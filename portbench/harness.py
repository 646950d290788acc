"""One run of one cell: set-up, the measured window, the trace, the check
against the reference, and the result line.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace T``
(see ``portbench/README.md``).  Everything a cell is made of is found by
name in ``BENCHMARK.json``: its configuration file, its traffic file
(``portbench/traffic/<traffic>.json``) and the reader of each metric
(``portbench/metrics/<metric>.py``, a ``read(ctx)`` that returns a number
or ``None``).

The window drives the port's streamed sweep entry
``repro_torch.core.stream.sweep_stream(cols, target_cs=..., reduce=
CellReduce(...))`` with every other argument at the program's default:
sweeps of the cell's columns back to back, each with its own seed column,
until ``--seconds`` have passed; the sweep running at the deadline
finishes and counts.  The clock stops after ``torch.cuda.synchronize()``
on every card used.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import check, roofline
from . import trace as TRC
from . import traffic as TR

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that may not be loaded in the result's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """The workload entry of ``spec`` named ``workload``, with its
    configuration and traffic (parsed)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    return w, config, TR.load_json("traffic", w["traffic"])


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    applies = lambda m: "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if applies(m)
            and ("workloads" in m or m["moves"] in names)]


def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one (compared
    whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _launch_count():
    """Simulator kernel launches so far (the wrappers' counters), or None
    where the program no longer keeps them."""
    try:
        from repro_torch.kernels import lock_sim as K
    except ImportError:
        return None
    n = 0
    for fn, attrs in ((K.lock_sim_block, ("launches", "open_launches")),
                      (getattr(K, "lock_sim_step", None), ("launches",)),
                      (getattr(K, "lock_transitions_step", None),
                       ("launches", "open_launches"))):
        for a in attrs:
            v = getattr(fn, a, None)
            if isinstance(v, int):
                n += v
    return n


def measure(sweep, seconds: float, clock=time.perf_counter):
    """Sweeps ``sweep(k)`` (each returns ``(cols, result)`` once its work
    has finished on every card) back to back until ``seconds`` have
    passed; the sweep running at the deadline finishes and counts.
    Returns the start, the end of every sweep, the last ``(cols,
    result)`` and the number of sweeps that quarantined a config."""
    t0 = clock()
    ends, failed, last = [], 0, None
    while not ends or ends[-1] < t0 + seconds:
        last = sweep(len(ends))
        failed += bool(getattr(last[1], "failures", None))
        ends.append(clock())
    return t0, ends, last, failed


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, spec: dict | None = None,
        cell: tuple | None = None, require_chips: bool = True,
        workers: int | None = None) -> dict:
    """One run; returns the result dict (``correct`` and the rest).
    ``device=None`` is the card; the tests pass ``device="cpu"``, a
    ``cell`` of their own and ``require_chips=False``."""
    import torch

    spec = spec or load_spec()
    w, config, traffic = cell or cell_of(spec, workload)
    chips = int(w["chips"])
    if require_chips and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < chips):
        raise SystemExit(
            f"{workload} needs {chips} CUDA card(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count()={torch.cuda.device_count()}")
    on_card = device is None or str(device).startswith("cuda")
    devices = list(range(chips)) if on_card else []

    from repro_torch.core import stream as S

    sweep = TR.build(config, traffic)
    reduce = S.CellReduce(sweep.group, sweep.cell_ids,
                          len(sweep.cell_names))
    call = lambda cols, **kw: S.sweep_stream(
        cols, target_cs=sweep.target_cs, reduce=reduce, device=device, **kw)

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    # set-up: the library and every allocation at the cell's own shapes,
    # two blocks of one sweep
    call(sweep.with_seed(seed, -1), n_steps=2 * TR.BLOCK_STEPS)
    sync()
    work = roofline.needed_work(sweep.cols, sweep.target_cs)
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function(TRC.WINDOW)
        span.__enter__()
    launches0 = _launch_count()

    def one(k):
        cols = sweep.with_seed(seed, k)
        res = call(cols)
        sync()
        return cols, res

    t0, ends, last, failed = measure(one, seconds)
    n_sweeps, t1 = len(ends), ends[-1]
    launches = (None if launches0 is None
                else _launch_count() - launches0)
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)

    ctx = {"setup_s": setup_s, "window_s": t1 - t0, "sweeps": n_sweeps,
           "configs_per_sweep": sweep.n_configs, "chips": chips,
           "launches": launches or None, "peak_bytes": peak if on_card
           else None, "work": work, "trace": {}}
    out = {"correct": False, "attempted": n_sweeps, "failed": failed,
           "sweep_s": list(np.diff([t0] + ends)),
           "steps_run": int(np.max(last[1].steps_run))}
    if prof is not None:
        t_trace = time.perf_counter()
        ctx["trace"] = TRC.read(TRC.profiler_events(prof))
        del prof
        out["trace_s"] = time.perf_counter() - t_trace
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    out["device"] = {"platform": "gpu" if on_card else "cpu", "kind": name,
                     "count": chips, "memory_peak_bytes": peak}
    tr = ctx["trace"]
    if trace and tr:
        busy = [tr["busy_s"].get(d, 0.0) for d in (devices or [0])]
        out["device"]["busy_s"] = float(np.mean(busy))
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}

    # the check, once the window has closed and its memory is read
    if on_card:
        torch.cuda.empty_cache()
    cols, res = last
    t_check = time.perf_counter()
    readings = check.compare(sweep, cols, res, seed, workers)
    out["check_s"] = time.perf_counter() - t_check
    out["correct"] = check.verdict(readings)
    out["rows_checked"] = readings["rows_checked"]
    out["checks"] = {k: {"value": readings[k], "limit": lim}
                     for k, lim in check.LIMITS.items()}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    # one process a card, and only the cards the cell asks for: the
    # program splits its sweeps over every card it sees
    chips = int(cell_of(load_spec(), a.workload)[0]["chips"])
    seen = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = seen.split(",") if seen else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards[:chips])
    out = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

"""Wall-clock microbenchmark of the batched lock simulator on the port —
the perf trajectory of its xdes engine.

The port of ``benchmarks/perf_bench.py``.  Five suites; sim cells timed
twice (cold = the first call, the kernel library's build included when it
is not cached; steady = the second call, ending in
``torch.cuda.synchronize()`` on the card; throughputs are computed from
the steady time):

* ``dispatch`` — a pinned-horizon 1k-config batch (10k too with
  ``--full-size``) through every (backend, rollout) cell: ``ref`` (the
  plain PyTorch versions) / ``kernel`` (the CUDA kernels) x per-step
  ``scan`` (two kernel launches per timestep) vs time-blocked ``blocked``
  (one launch per :data:`repro_torch.core.xdes.DEFAULT_BLOCK_STEPS`
  timesteps).  Same step count everywhere, early exit off: this isolates
  the launch-count effect.
* ``sweep`` — the end-to-end 1k-config scenario sweep at an auto-planned
  horizon through the kernel: the legacy path (scan, full horizon, one
  global scan length) vs the shipped fast path (blocked + early exit +
  ``bucket_steps``).
* ``open_loop`` — the open-loop arrival engine vs the closed engine at
  the same pinned horizon: the wall-clock price of per-request
  tail-latency telemetry.
* ``encode`` — packing 100k configs into engine columns: the per-config
  :func:`~repro_torch.core.policy.encode_configs_legacy` lambda table vs
  the array-native :func:`~repro_torch.core.policy.encode_configs` column
  path (host only).
* ``stream`` — the end-to-end streamed discipline sweep
  (:func:`repro_torch.core.stream.sweep_stream`, bucketed,
  memory-budgeted) through the kernel: 20k configs in quick mode, 20k +
  100k in full mode, with peak host RSS (``ru_maxrss``) and, on the card,
  peak device bytes alongside the chunk plan.

Artifact: ``reports/torch/bench_xdes.json`` by default, schema 2
(``{"schema": 2, "entries": {<env>: result}}``), keyed by
``<platform>/<n_devices>dev/<device name>`` so runs on different cards
coexist.  The port never reads or writes the JAX package's
``BENCH_xdes.json``: ``--check`` compares against the ``--baseline`` the
caller names, and passes with a note when that file has no entry for this
environment.

    PYTHONPATH=src python -m repro_torch.bench.perf_bench [--quick] \\
        [--device cpu] [--check --baseline FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.device import resolve_device

#: The regression gate's tolerance: fail if a cell's steady-state
#: throughput drops below baseline / REGRESSION_FACTOR.
REGRESSION_FACTOR = 2.0

#: The simulator's backends: the plain PyTorch versions, the CUDA kernels.
BACKENDS = ("ref", "kernel")


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}µs"


def _sync(device) -> None:
    if resolve_device(device).type == "cuda":
        torch.cuda.synchronize()


def _time_twice(fn, device=None):
    """(cold_s, steady_s, result): the first call builds the kernel
    library when it is not cached; the second is the steady state the
    trajectory tracks.  Each ends in a synchronize on the card."""
    t0 = time.perf_counter()
    fn()
    _sync(device)
    t1 = time.perf_counter()
    res = fn()
    _sync(device)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1, res


def dispatch_suite(n_configs: int, n_steps: int, backends=BACKENDS,
                   verbose: bool = True, device=None) -> dict:
    """Pinned-horizon (backend x rollout) grid on one scenario batch."""
    from repro_torch.configs.catalog import lock_scenario_sweep
    from repro_torch.core import xdes

    configs = lock_scenario_sweep(n_scenarios=n_configs // 5)
    assert len(configs) == n_configs
    cells = {}
    for backend in backends:
        for rollout in ("scan", "blocked"):
            cold, steady, res = _time_twice(lambda: xdes.simulate_batch(
                configs, n_steps=n_steps, backend=backend, rollout=rollout,
                device=device), device)
            cells[f"{backend}/{rollout}"] = {
                "n_configs": n_configs, "n_steps": n_steps,
                "block_steps": (xdes.DEFAULT_BLOCK_STEPS
                                if rollout == "blocked" else 1),
                "wall_cold_s": round(cold, 3), "wall_s": round(steady, 3),
                "cfg_steps_per_s": round(n_configs * n_steps / steady, 1),
            }
            if verbose:
                c = cells[f"{backend}/{rollout}"]
                print(f"  {backend:>6}/{rollout:<7} cold {_fmt_s(cold):>8} "
                      f"steady {_fmt_s(steady):>8} "
                      f"({c['cfg_steps_per_s']:.2e} cfg-steps/s)")
    return cells


def sweep_suite(n_scenarios: int, target_cs: int, verbose: bool = True,
                device=None) -> dict:
    """End-to-end auto-planned scenario sweep through the kernel: legacy
    full-horizon scan vs the shipped fast path (blocked + early exit +
    bucketing)."""
    from repro_torch.configs.catalog import lock_scenario_sweep
    from repro_torch.core import xdes

    configs = lock_scenario_sweep(n_scenarios=n_scenarios)
    variants = {
        "legacy": dict(rollout="scan", early_exit=False,
                       bucket_steps=False),
        "blocked": dict(rollout="blocked", early_exit=False,
                        bucket_steps=False),
        "fast": dict(rollout="blocked", early_exit=True, bucket_steps=True),
    }
    cells = {}
    for name, kw in variants.items():
        cold, steady, res = _time_twice(lambda: xdes.simulate_batch(
            configs, target_cs=target_cs, device=device, **kw), device)
        run = np.asarray(res.steps_run, np.int64)
        cells[name] = {
            "n_configs": len(configs), "target_cs": target_cs,
            "planned_steps": int(res.n_steps),
            "mean_steps_run": round(float(run.mean()), 1),
            "executed_cfg_steps": int(run.sum()),
            "wall_cold_s": round(cold, 3), "wall_s": round(steady, 3),
            "min_completed": int(np.asarray(res.completed).min()),
        }
        if verbose:
            c = cells[name]
            print(f"  {name:>8} cold {_fmt_s(cold):>8} steady "
                  f"{_fmt_s(steady):>8} (mean steps run "
                  f"{c['mean_steps_run']:.0f} of {c['planned_steps']} "
                  f"planned, min completed {c['min_completed']})")
    return cells


def encode_suite(n_configs: int = 100_000, verbose: bool = True) -> dict:
    """Config packing: per-config lambda table vs array-native columns.

    Both paths pack the SAME sweep (the column twin is bit-equal to the
    list pack, asserted here); the timed step is encode only, building the
    ``SimConfig`` list for the legacy path is setup.  Best-of-3 wall
    times, host only."""
    from repro_torch.configs.catalog import (lock_scenario_columns,
                                             lock_scenario_sweep)
    from repro_torch.core import policy

    n_scenarios = n_configs // 5
    configs = lock_scenario_sweep(n_scenarios=n_scenarios)
    cols = lock_scenario_columns(n_scenarios=n_scenarios)

    def best_of(fn, n=3):
        best, res = float("inf"), None
        for _ in range(n):
            t0 = time.perf_counter()
            res = fn()
            best = min(best, time.perf_counter() - t0)
        return best, res

    legacy_s, legacy = best_of(lambda: policy.encode_configs_legacy(configs))
    column_s, packed = best_of(lambda: policy.encode_configs(cols))
    for k in packed:
        assert np.array_equal(packed[k], legacy[k]), f"encode mismatch: {k}"
    cells = {
        "n_configs": len(configs),
        "legacy_s": round(legacy_s, 4), "columns_s": round(column_s, 4),
        "legacy_cfg_per_s": round(len(configs) / legacy_s, 1),
        "columns_cfg_per_s": round(len(configs) / column_s, 1),
        "speedup": round(legacy_s / column_s, 1),
    }
    if verbose:
        print(f"  legacy {_fmt_s(legacy_s):>8}  columns "
              f"{_fmt_s(column_s):>8}  ({cells['speedup']}x)")
    return cells


def stream_suite(n_configs: int, target_cs: int,
                 mem_mb: float | None = None, verbose: bool = True,
                 device=None) -> dict:
    """End-to-end streamed discipline sweep through the kernel: bucketed
    ``sweep_stream`` under a memory budget, with peak host RSS and (on the
    card) peak device bytes next to the chunk plan.  One cold call."""
    import resource

    from repro_torch.configs.catalog import (lock_discipline_columns,
                                             lock_discipline_variants)
    from repro_torch.core import stream as xstream

    on_card = resolve_device(device).type == "cuda"
    V = len(lock_discipline_variants())
    n_scenarios = max(1, n_configs // V)
    cols = lock_discipline_columns(n_scenarios=n_scenarios)
    C = n_scenarios * V
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = xstream.sweep_stream(cols, target_cs=target_cs, backend="kernel",
                               bucket_steps=True, mem_mb=mem_mb,
                               device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    rss_kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cell = {
        "n_configs": C, "target_cs": target_cs,
        "wall_s": round(wall, 2),
        "configs_per_s": round(C / wall, 1),
        "chunk_size": res.chunk_size, "n_chunks": res.n_chunks,
        "budget_mb": round(res.budget_mb, 1),
        "bytes_per_config": res.bytes_per_config,
        "ru_maxrss_mb": round(rss_kib / 1024.0, 1),
        "device_peak_mb": (round(torch.cuda.max_memory_allocated() / 2**20,
                                 1) if on_card else None),
        "min_completed": int(np.asarray(res.completed).min()),
    }
    if verbose:
        print(f"  {C} configs in {_fmt_s(wall):>8} "
              f"({cell['configs_per_s']} cfg/s, {res.n_chunks} chunk(s) "
              f"of <= {res.chunk_size}, peak RSS "
              f"{cell['ru_maxrss_mb']:.0f} MB)")
    return cell


def open_loop_suite(n_configs: int, n_steps: int, verbose: bool = True,
                    device=None) -> dict:
    """Pinned-horizon open-loop cells through the kernel: the arrival
    engine vs the closed engine at the same config count and horizon.
    Both cells run the blocked rollout with early exit off; throughput is
    compared per cfg-step so the slightly different variant counts
    cancel."""
    from repro_torch.configs.catalog import (lock_arrival_sweep,
                                             lock_arrival_variants,
                                             lock_discipline_sweep,
                                             lock_discipline_variants)
    from repro_torch.core import xdes

    Va = len(lock_arrival_variants())
    Vd = len(lock_discipline_variants())
    batches = {
        "closed": lock_discipline_sweep(
            n_scenarios=max(1, n_configs // Vd)),
        "open": lock_arrival_sweep(n_scenarios=max(1, n_configs // Va)),
    }
    cells = {}
    for name, cfgs in batches.items():
        cold, steady, res = _time_twice(lambda: xdes.simulate_batch(
            cfgs, n_steps=n_steps, rollout="blocked", early_exit=False,
            device=device), device)
        cells[name] = {
            "n_configs": len(cfgs), "n_steps": n_steps,
            "wall_cold_s": round(cold, 3), "wall_s": round(steady, 3),
            "cfg_steps_per_s": round(len(cfgs) * n_steps / steady, 1),
        }
        if verbose:
            c = cells[name]
            print(f"  {name:>7} cold {_fmt_s(cold):>8} steady "
                  f"{_fmt_s(steady):>8} "
                  f"({c['cfg_steps_per_s']:.2e} cfg-steps/s)")
    cells["open_overhead_x"] = round(
        cells["closed"]["cfg_steps_per_s"]
        / max(cells["open"]["cfg_steps_per_s"], 1e-9), 2)
    if verbose:
        print(f"  open-loop overhead {cells['open_overhead_x']}x "
              f"(closed cfg-steps/s over open)")
    return cells


def env_key(meta: dict) -> str:
    """The baseline entry key for one environment's measurements: results
    are only comparable on one (platform, device count, device) triple."""
    return f"{meta['platform']}/{meta['n_devices']}dev/{meta['device_kind']}"


def load_entries(path: str) -> dict:
    """Read a baseline file as ``{env_key: result}``: schema-2 files
    verbatim, a single-result file keyed by its recorded meta."""
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") == 2:
        return data["entries"]
    return {env_key(data["meta"]): data}


def _speedups(cells: dict) -> dict:
    out = {}
    for backend in BACKENDS:
        a, b = cells.get(f"{backend}/scan"), cells.get(f"{backend}/blocked")
        if a and b:
            out[f"dispatch/{backend}/blocked_over_scan"] = round(
                a["wall_s"] / b["wall_s"], 2)
    return out


def summarize(result: dict) -> str:
    """Markdown perf table."""
    lines = ["### xdes perf trajectory on the port — "
             "`reports/torch/bench_xdes.json`", "",
             "| cell | configs | steps | cold | steady | cfg-steps/s |",
             "|---|---|---|---|---|---|"]
    for name, c in result["dispatch"].items():
        lines.append(
            f"| dispatch {name} | {c['n_configs']} | {c['n_steps']} "
            f"| {_fmt_s(c['wall_cold_s'])} | {_fmt_s(c['wall_s'])} "
            f"| {c['cfg_steps_per_s']:.2e} |")
    for name, c in result["sweep"].items():
        lines.append(
            f"| sweep {name} | {c['n_configs']} "
            f"| {c['mean_steps_run']:.0f}/{c['planned_steps']} "
            f"| {_fmt_s(c['wall_cold_s'])} | {_fmt_s(c['wall_s'])} | - |")
    for name in ("closed", "open"):
        c = result.get("open_loop", {}).get(name)
        if c:
            lines.append(
                f"| open_loop {name} | {c['n_configs']} | {c['n_steps']} "
                f"| {_fmt_s(c['wall_cold_s'])} | {_fmt_s(c['wall_s'])} "
                f"| {c['cfg_steps_per_s']:.2e} |")
    for name, c in result.get("stream", {}).items():
        lines.append(
            f"| stream {name} | {c['n_configs']} | - "
            f"| - | {_fmt_s(c['wall_s'])} | {c['configs_per_s']} cfg/s, "
            f"{c['n_chunks']} chunks, RSS {c['ru_maxrss_mb']:.0f} MB |")
    enc = result.get("encode")
    if enc:
        lines.append(
            f"| encode columns | {enc['n_configs']} | - "
            f"| - | {_fmt_s(enc['columns_s'])} "
            f"| {enc['speedup']}x over legacy |")
    lines += ["", "| speedup | x |", "|---|---|"]
    for k, v in result["speedups"].items():
        lines.append(f"| {k} | {v} |")
    return "\n".join(lines)


def check_regression(result: dict, baseline: dict,
                     factor: float = REGRESSION_FACTOR) -> list[str]:
    """Compare steady-state throughput of matching dispatch and stream
    cells against a baseline (one environment's entry); return the list
    of failures (empty = pass)."""
    failures = []
    base_cells = baseline.get("dispatch", {})
    for name, cell in result.get("dispatch", {}).items():
        base = base_cells.get(name)
        if not base or (base["n_configs"], base["n_steps"]) != (
                cell["n_configs"], cell["n_steps"]):
            continue                      # different scale: not comparable
        if cell["cfg_steps_per_s"] * factor < base["cfg_steps_per_s"]:
            failures.append(
                f"{name}: {cell['cfg_steps_per_s']:.2e} cfg-steps/s is "
                f">{factor}x below baseline "
                f"{base['cfg_steps_per_s']:.2e}")
    base_stream = baseline.get("stream", {})
    for name, cell in result.get("stream", {}).items():
        base = base_stream.get(name)
        if not base or (base["n_configs"], base["target_cs"]) != (
                cell["n_configs"], cell["target_cs"]):
            continue
        if cell["configs_per_s"] * factor < base["configs_per_s"]:
            failures.append(
                f"stream {name}: {cell['configs_per_s']} cfg/s is "
                f">{factor}x below baseline {base['configs_per_s']}")
    return failures


def environment(device=None) -> dict:
    """The run's environment: platform (``gpu`` on the card), device count
    and the device's name."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "n_devices": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "n_devices": 1, "device_kind": "cpu"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke scale: 1k-config dispatch grid + 200-config "
                         "sweep")
    ap.add_argument("--full-size", action="store_true",
                    help="add the 10k-config dispatch cell (ref backend)")
    ap.add_argument("--out", default="reports/torch/bench_xdes.json",
                    help="output path (entries merge under this "
                         "environment's key)")
    ap.add_argument("--check", action="store_true",
                    help="compare against this environment's entry in "
                         "--baseline BEFORE writing; exit 1 on a "
                         f">{REGRESSION_FACTOR}x throughput regression")
    ap.add_argument("--baseline", default=None,
                    help="the baseline file --check reads (required with "
                         "--check)")
    ap.add_argument("--mem-mb", type=float, default=None,
                    help="streaming suite memory budget in MiB (default: "
                         "REPRO_SWEEP_MEM_MB env, else device-derived)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    args = ap.parse_args(argv)

    baseline_entries = None
    if args.check:
        # fail fast: --check with no baseline must not pass silently
        if args.baseline is None or not os.path.exists(args.baseline):
            raise SystemExit(f"perf check: no baseline at {args.baseline} "
                             f"(name one with --baseline FILE)")
        baseline_entries = load_entries(args.baseline)
    meta = environment(args.device)       # no card: raise before any work
    dev = args.device

    t0 = time.time()
    print("dispatch suite (pinned horizon, early exit off):")
    dispatch = dispatch_suite(1000, 384, device=dev)
    if args.full_size:
        print("dispatch suite, 10k configs (ref backend):")
        dispatch.update({f"10k-{k}": v for k, v in dispatch_suite(
            10_000, 384, backends=("ref",), device=dev).items()})

    print("sweep suite (auto-planned horizon):")
    sweep = sweep_suite(n_scenarios=40 if args.quick else 200,
                        target_cs=20 if args.quick else 50, device=dev)

    print("open-loop suite (pinned horizon, arrival engine vs closed):")
    open_loop = open_loop_suite(1000, 384, device=dev)

    print("encode suite (100k-config packing):")
    encode = encode_suite(100_000)

    print("stream suite (bucketed sweep_stream under a memory budget):")
    stream = {"discipline_20k": stream_suite(20_000, target_cs=20,
                                             mem_mb=args.mem_mb, device=dev)}
    if not args.quick:
        stream["discipline_100k"] = stream_suite(100_000, target_cs=20,
                                                 mem_mb=args.mem_mb,
                                                 device=dev)

    result = {
        "meta": {**meta, "torch": torch.__version__,
                 "mode": "quick" if args.quick else "full",
                 "wall_total_s": None},
        "dispatch": dispatch,
        "sweep": sweep,
        "open_loop": open_loop,
        "encode": encode,
        "stream": stream,
    }
    result["speedups"] = _speedups(dispatch)
    result["speedups"]["open_loop/overhead_x"] = open_loop[
        "open_overhead_x"]
    legacy, fast = sweep.get("legacy"), sweep.get("fast")
    if legacy and fast:
        result["speedups"]["sweep/fast_over_legacy"] = round(
            legacy["wall_s"] / fast["wall_s"], 2)
    result["speedups"]["encode/columns_over_legacy"] = encode["speedup"]
    result["meta"]["wall_total_s"] = round(time.time() - t0, 1)

    key = env_key(result["meta"])
    entries = load_entries(args.out) if os.path.exists(args.out) else {}
    entries[key] = result
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"schema": 2, "entries": entries}, f, indent=1)
        f.write("\n")
    print(f"\n{summarize(result)}\n\nwrote {args.out} entry '{key}' "
          f"({result['meta']['wall_total_s']}s total)")

    if baseline_entries is not None:
        base = baseline_entries.get(key)
        if base is None:
            print(f"perf check vs {args.baseline}: no entry for '{key}' "
                  f"yet — nothing to compare")
        else:
            failures = check_regression(result, base)
            if failures:
                print("PERF REGRESSION vs baseline:")
                for line in failures:
                    print(f"  {line}")
                raise SystemExit(1)
            print(f"perf check vs {args.baseline} entry '{key}': OK "
                  f"(no cell >{REGRESSION_FACTOR}x below baseline)")
    return result


if __name__ == "__main__":
    main()

"""The rest of ``benchmarks/`` on the port — ``repro_torch.bench.
perf_bench``, ``stream_smoke`` and ``run`` — and ``policy.
encode_configs_legacy``, against the JAX package's on the CPU.

* ``encode_configs_legacy`` equals the reference's and the port's
  ``encode_configs``, bit for bit, on the same 1000 configs.
* ``perf_bench``: ``_speedups``, ``summarize`` and ``check_regression``
  give the reference's outputs on the same dicts (the port's backend
  ``kernel`` where the reference has ``pallas``); ``env_key`` names the
  card; each suite runs on the CPU at a toy size and returns the
  reference's keys; ``main`` writes where ``--out`` says and never reads
  or writes ``BENCH_xdes.json``, and ``--check`` reads only the
  ``--baseline`` it is given.
* ``stream_smoke.main`` passes at a budget that forces chunks, and exits 1
  where the reference's does ("did not stream" under a large budget).
* ``run.main`` (``--quick`` and the default), with each step replaced by a
  stub returning the same dict to both packages, prints the reference's
  summary rows.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import benchmarks.perf_bench as jpb
import benchmarks.run as jrun
import benchmarks.stream_smoke as jss
from repro.configs import catalog as jcatalog
from repro.core import policy as jpolicy
from repro_torch.bench import perf_bench as tpb
from repro_torch.bench import run as trun
from repro_torch.bench import stream_smoke as tss
from repro_torch.configs import catalog as tcatalog
from repro_torch.core import policy as tpolicy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# encode_configs_legacy
# --------------------------------------------------------------------------
def test_encode_configs_legacy_equals_the_reference_and_the_columns():
    want = jpolicy.encode_configs_legacy(
        jcatalog.lock_scenario_sweep(n_scenarios=200))
    cfgs = tcatalog.lock_scenario_sweep(n_scenarios=200)
    assert len(cfgs) == 1000
    legacy = tpolicy.encode_configs_legacy(cfgs)
    cols = tpolicy.encode_configs(cfgs)
    assert legacy.keys() == want.keys() == cols.keys()
    for k in want:
        assert legacy[k].dtype == want[k].dtype == cols[k].dtype, k
        np.testing.assert_array_equal(legacy[k], want[k], err_msg=k)
        np.testing.assert_array_equal(cols[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="empty"):
        tpolicy.encode_configs_legacy([])


# --------------------------------------------------------------------------
# perf_bench: the pure functions
# --------------------------------------------------------------------------
def _cell(n, steps, wall, cold=1.0):
    return {"n_configs": n, "n_steps": steps, "block_steps": 1,
            "wall_cold_s": cold, "wall_s": wall,
            "cfg_steps_per_s": round(n * steps / wall, 1)}


def _result(backend, scale=1.0):
    """A perf_bench result with ``backend`` as the second backend's name."""
    dispatch = {"ref/scan": _cell(1000, 384, 2.0 * scale),
                "ref/blocked": _cell(1000, 384, 0.5 * scale),
                f"{backend}/scan": _cell(1000, 384, 0.2 * scale),
                f"{backend}/blocked": _cell(1000, 384, 0.004 * scale)}
    sweep = {name: {"n_configs": 200, "target_cs": 20, "planned_steps": 900,
                    "mean_steps_run": run, "executed_cfg_steps": 1,
                    "wall_cold_s": 3.0, "wall_s": w, "min_completed": 20}
             for name, run, w in (("legacy", 900.0, 1.5),
                                  ("blocked", 900.0, 0.4),
                                  ("fast", 410.5, 0.2))}
    open_loop = {"closed": _cell(990, 384, 0.01), "open": _cell(1000, 384,
                                                                0.02),
                 "open_overhead_x": 1.98}
    stream = {"discipline_20k": {
        "n_configs": 19995, "target_cs": 20, "wall_s": 1.5 * scale,
        "configs_per_s": round(13330.0 / scale, 1), "chunk_size": 2000,
        "n_chunks": 10, "budget_mb": 16.0, "bytes_per_config": 2272,
        "ru_maxrss_mb": 900.0, "min_completed": 20}}
    encode = {"n_configs": 100000, "legacy_s": 2.5, "columns_s": 0.05,
              "legacy_cfg_per_s": 4e4, "columns_cfg_per_s": 2e6,
              "speedup": 50.0}
    return {"dispatch": dispatch, "sweep": sweep, "open_loop": open_loop,
            "encode": encode, "stream": stream}


def _rename(d: dict, old: str, new: str) -> dict:
    return {k.replace(old, new): v for k, v in d.items()}


def test_speedups_summarize_and_check_match_the_reference():
    theirs, ours = _result("pallas"), _result("kernel")
    want = jpb._speedups(theirs["dispatch"])
    got = tpb._speedups(ours["dispatch"])
    assert got == _rename(want, "pallas", "kernel")
    assert got["dispatch/kernel/blocked_over_scan"] == 50.0
    for res, sp in ((theirs, want), (ours, got)):
        res["speedups"] = dict(sp, **{"encode/columns_over_legacy": 50.0})
    # the same table under the port's title (its report's own path)
    got_t, want_t = (tpb.summarize(ours).splitlines(),
                     jpb.summarize(theirs).replace("pallas",
                                                   "kernel").splitlines())
    assert got_t[1:] == want_t[1:] and len(got_t) > 15
    assert "reports/torch/bench_xdes.json" in got_t[0]
    for scale in (1.0, 1.5, 3.0):
        slow_t, slow_o = _result("pallas", scale), _result("kernel", scale)
        want_f = jpb.check_regression(slow_t, theirs)
        got_f = tpb.check_regression(slow_o, ours)
        assert got_f == [f.replace("pallas", "kernel") for f in want_f]
        assert bool(got_f) == (scale > 2.0)
    # a cell at another scale is not comparable
    other = _result("kernel", 3.0)
    other["dispatch"] = {k: dict(v, n_steps=100)
                         for k, v in other["dispatch"].items()}
    assert len(tpb.check_regression(other, ours)) == 1      # stream only


def test_env_key_names_the_card():
    meta = {"platform": "gpu", "n_devices": 1,
            "device_kind": "NVIDIA H100 80GB HBM3"}
    assert tpb.env_key(meta) == "gpu/1dev/NVIDIA H100 80GB HBM3"
    assert tpb.environment("cpu") == {"platform": "cpu", "n_devices": 1,
                                      "device_kind": "cpu"}
    assert tpb.env_key(tpb.environment("cpu")) == "cpu/1dev/cpu"


def test_load_entries_reads_both_schemas(tmp_path):
    res = dict(_result("kernel"), meta=tpb.environment("cpu"))
    one = tmp_path / "one.json"
    one.write_text(json.dumps(res))
    assert tpb.load_entries(str(one)) == {"cpu/1dev/cpu": res}
    two = tmp_path / "two.json"
    two.write_text(json.dumps({"schema": 2, "entries": {"k": res}}))
    assert tpb.load_entries(str(two)) == {"k": res}


# --------------------------------------------------------------------------
# perf_bench: the suites on the CPU
# --------------------------------------------------------------------------
def test_suites_run_on_the_cpu_with_the_reference_keys():
    d = tpb.dispatch_suite(10, 4, device="cpu", verbose=False)
    assert set(d) == {"ref/scan", "ref/blocked", "kernel/scan",
                      "kernel/blocked"}
    for c in d.values():
        assert set(c) == {"n_configs", "n_steps", "block_steps",
                          "wall_cold_s", "wall_s", "cfg_steps_per_s"}
        assert c["n_configs"] == 10 and c["cfg_steps_per_s"] > 0
    s = tpb.sweep_suite(1, 1, device="cpu", verbose=False)
    assert set(s) == {"legacy", "blocked", "fast"}
    for c in s.values():
        assert set(c) == {"n_configs", "target_cs", "planned_steps",
                          "mean_steps_run", "executed_cfg_steps",
                          "wall_cold_s", "wall_s", "min_completed"}
        assert c["min_completed"] >= 1
    assert s["fast"]["mean_steps_run"] <= s["legacy"]["mean_steps_run"]
    o = tpb.open_loop_suite(15, 4, device="cpu", verbose=False)
    assert set(o) == {"closed", "open", "open_overhead_x"}
    e = tpb.encode_suite(100, verbose=False)
    assert set(e) == set(jpb.encode_suite(100, verbose=False))
    st = tpb.stream_suite(30, 1, mem_mb=0.04, device="cpu", verbose=False)
    assert set(st) == {"n_configs", "target_cs", "wall_s", "configs_per_s",
                       "chunk_size", "n_chunks", "budget_mb",
                       "bytes_per_config", "ru_maxrss_mb", "device_peak_mb",
                       "min_completed"}
    assert st["n_chunks"] > 1 and st["device_peak_mb"] is None


# --------------------------------------------------------------------------
# perf_bench: main
# --------------------------------------------------------------------------
@pytest.fixture
def stubbed_suites(monkeypatch, tmp_path):
    res = _result("kernel")
    monkeypatch.setattr(tpb, "dispatch_suite",
                        lambda *a, **k: dict(res["dispatch"]))
    monkeypatch.setattr(tpb, "sweep_suite", lambda *a, **k: res["sweep"])
    monkeypatch.setattr(tpb, "open_loop_suite",
                        lambda *a, **k: res["open_loop"])
    monkeypatch.setattr(tpb, "encode_suite", lambda *a, **k: res["encode"])
    monkeypatch.setattr(tpb, "stream_suite",
                        lambda *a, **k: res["stream"]["discipline_20k"])
    monkeypatch.chdir(tmp_path)
    return res


def _bench_xdes():
    path = os.path.join(REPO, "BENCH_xdes.json")
    with open(path, "rb") as f:
        return f.read(), os.stat(path).st_mtime_ns


def test_main_writes_its_own_report_only(stubbed_suites, tmp_path):
    before = _bench_xdes()
    out = tmp_path / "r" / "bench.json"
    with contextlib.redirect_stdout(io.StringIO()):
        res = tpb.main(["--quick", "--device", "cpu", "--out", str(out)])
    data = json.loads(out.read_text())
    assert data["schema"] == 2 and list(data["entries"]) == ["cpu/1dev/cpu"]
    assert res["meta"]["mode"] == "quick"
    assert res["speedups"]["dispatch/kernel/blocked_over_scan"] == 50.0
    assert res["speedups"]["sweep/fast_over_legacy"] == 7.5
    # the default lands under reports/torch/ of the working directory
    with contextlib.redirect_stdout(io.StringIO()):
        tpb.main(["--quick", "--device", "cpu"])
    assert (tmp_path / "reports" / "torch" / "bench_xdes.json").exists()
    assert _bench_xdes() == before
    assert not (tmp_path / "BENCH_xdes.json").exists()


def test_check_reads_only_the_named_baseline(stubbed_suites, tmp_path):
    out = str(tmp_path / "bench.json")
    with pytest.raises(SystemExit, match="no baseline"):
        tpb.main(["--quick", "--device", "cpu", "--check", "--out", out])
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"schema": 2, "entries": {}}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tpb.main(["--quick", "--device", "cpu", "--check", "--baseline",
                  str(base), "--out", out])
    assert "no entry for 'cpu/1dev/cpu'" in buf.getvalue()
    fast = _result("kernel", 1 / 3.0)
    base.write_text(json.dumps({"schema": 2,
                                "entries": {"cpu/1dev/cpu": fast}}))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit) as e:
            tpb.main(["--quick", "--device", "cpu", "--check",
                      "--baseline", str(base), "--out", out])
    assert e.value.code == 1


# --------------------------------------------------------------------------
# stream_smoke
# --------------------------------------------------------------------------
def test_stream_smoke_streams_and_refuses_a_run_that_did_not():
    """30 configs (two step-count buckets) at a budget of 20 configs
    stream; one scenario (15 configs, one bucket) under 64 MiB does not,
    and both packages exit 1."""
    with contextlib.redirect_stdout(io.StringIO()):
        out = tss.main(["--configs", "30", "--target-cs", "1", "--mem-mb",
                        "0.04", "--device", "cpu"])
    assert out["n_configs"] == 30 and out["n_chunks"] > 1
    assert out["device_grown_mb"] is None
    assert out["chunk_mb"] <= out["budget_mb"]
    for main, extra in ((tss.main, ["--device", "cpu"]), (jss.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with pytest.raises(SystemExit) as e:
                main(["--configs", "15", "--target-cs", "1", "--mem-mb",
                      "64"] + extra)
        assert e.value.code == 1
        assert "FAIL: did not stream: 1 chunk at C=15" in buf.getvalue()


# --------------------------------------------------------------------------
# run
# --------------------------------------------------------------------------
STUBS = {
    "sweep": {"fig3": {"claims": {"C2": True, "C3": True, "C4": False}},
              "scenario": {"mean_ratio_to_best": {"mutable": 0.93456,
                                                  "ttas": 0.81}}},
    "oracle_ablation": {"families": {
        f: {"best_tuned_mean_ratio": r, "wins": w}
        for f, r, w in (("paper", 0.98765, 7), ("aimd", 0.9, 2))}},
    "discipline_diagram": {"disciplines": {
        d: {"wins": w, "best_variant_mean_ratio": 0.97777}
        for d, w in (("fifo", 3), ("mutable", 9))}},
    "workload_diagram": {"workloads": {
        w: {"mutable": {"wins": a, "best_variant_mean_ratio": 0.91234},
            "ttas": {"wins": b, "best_variant_mean_ratio": 0.8}}
        for w, a, b in (("constant", 5, 1), ("bursty", 1, 4))}},
    "arrival_diagram": {"phase": [
        {"arrival": "poisson", "rho": 0.6, "winner": "mutable",
         "mean_slo_frac": 0.12345},
        {"arrival": "bursty", "rho": 2.0, "winner": "sleep",
         "mean_slo_frac": 0.5}]},
    "fault_diagram": {"faults": {
        f: {"mutable": {"wins": 3}, "sleep": {"wins": 1,
                                              "mean_retained_vs_none": r}}
        for f, r in (("none", None), ("preempt", 0.87654))}},
    "park_diagram": {"park_costs": {
        p: {"mutable": {"wins": 2}, "sleep": {"wins": 4,
                                              "mean_retained_vs_unit": r}}
        for p, r in (("1", None), ("16", 0.66666))}},
    "perf_bench": {"speedups": {"dispatch/ref/blocked_over_scan": 4.0,
                                "open_loop/overhead_x": 1.98}},
    "sched_bench": {p: {"late_handoff_rate": 0.12345, "avg_standby": 1.234}
                    for p in ("zero", "max", "mutable")},
}
FIG1 = {k: {"makespan_slots": v} for k, v in (("ttas", 3.1), ("sleep", 5.0),
                                               ("mutable", 3.0))}
FIG3 = {r: {"summary": {"mutable": {"ratio_to_opt": 0.95432},
                        "pt-exp": {"ratio_to_opt": 0.7}}}
        for r in ("short_short", "long_long")}
PHOLD = {"25us": {16: {"mutable": {"speedup": 3.21}}}}


def _stub_package(monkeypatch, pkg: str):
    import importlib
    for name, res in STUBS.items():
        mod = importlib.import_module(f"{pkg}.{name}")
        monkeypatch.setattr(mod, "main", lambda argv=None, _r=res: _r)
    pb = importlib.import_module(f"{pkg}.perf_bench")
    monkeypatch.setattr(pb, "summarize", lambda r, *a, **k: "table")
    lb = importlib.import_module(f"{pkg}.lockbench")
    monkeypatch.setattr(lb, "fig1", lambda *a, **k: FIG1)
    monkeypatch.setattr(lb, "fig3", lambda *a, **k: FIG3)
    ph = importlib.import_module(f"{pkg}.phold")
    monkeypatch.setattr(ph, "run_phold", lambda *a, **k: PHOLD)


def _rows(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().splitlines()
    return lines[lines.index("name,value"):]


@pytest.mark.parametrize("argv", [["--quick"], []], ids=str)
def test_run_prints_the_reference_summary(monkeypatch, tmp_path, argv):
    monkeypatch.chdir(tmp_path)
    _stub_package(monkeypatch, "benchmarks")
    _stub_package(monkeypatch, "repro_torch.bench")
    want = _rows(jrun.main, argv)
    got = _rows(trun.main, argv + ["--device", "cpu"])
    assert got == want and len(got) > 10
    # the port's reports go under reports/torch/ only
    written = {os.path.relpath(os.path.join(d, f), tmp_path)
               for d, _, fs in os.walk(tmp_path / "reports" / "torch")
               for f in fs}
    assert written == (set() if argv else {
        "reports/torch/lockbench.json", "reports/torch/phold.json",
        "reports/torch/perf_bench.md"})

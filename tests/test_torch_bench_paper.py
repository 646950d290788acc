"""The port's paper-artifact modules (``repro_torch.bench.lockbench``,
``fidelity_study``, ``phold``, ``sched_bench``) against the JAX package's
``benchmarks/`` on the CPU.

* What runs on the DES is exact: Fig. 1, the Fig. 3 grid under
  ``engine="des"``, the fidelity study's DES half, the step-level
  scheduler runs.
* What runs on the batched engine (Fig. 3 under ``engine="xdes"``, the
  fidelity study's xdes half) is held within rtol 2e-2, the band of
  ``tests/test_torch_bench_grids.py`` (ROADMAP C12), with the same
  claims.  The port runs its plain versions (``device="cpu"``), the
  reference its jitted ``ref`` backend.
* PHOLD on the port's real locks processes every event.
* Each CLI writes its JSON (and the fidelity study its Markdown) byte for
  byte as the reference's writer would given the same dict, and without
  ``--device cpu`` and without CUDA the CLIs that reach the simulator
  raise before writing anything.
"""

import json
import math
import threading

import pytest
import torch

from benchmarks import fidelity_study as jfid
from benchmarks import lockbench as jlock
from benchmarks import sched_bench as jsched
from benchmarks import sweep as jsweep
from repro_torch.bench import fidelity_study as tfid
from repro_torch.bench import lockbench as tlock
from repro_torch.bench import phold as tphold
from repro_torch.bench import sched_bench as tsched
from repro_torch.bench import sweep as tsweep
from test_torch_bench_grids import RTOL, assert_results_agree

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

def test_grid_constants_are_the_reference_lockbench():
    """The xdes and DES Fig. 3 grids line up cell for cell: lockbench's
    constants are the catalog's, which are the reference lockbench's."""
    assert tlock.LOCKS == jlock.LOCKS
    assert tlock.THREADS == jlock.THREADS
    assert tlock.REGIMES == jlock.REGIMES
    assert list(tlock.REGIMES) == list(jlock.REGIMES)
    assert (tlock.SHORT, tlock.LONG, tlock.WAKE, tlock.CORES) == \
        (jlock.SHORT, jlock.LONG, jlock.WAKE, jlock.CORES)


def test_fig1_equals_reference():
    got, want = tlock.fig1(verbose=False), jlock.fig1(verbose=False)
    assert got == want
    assert got["ttas"]["makespan_slots"] < 3.5
    assert 4.5 < got["sleep"]["makespan_slots"] < 5.5
    assert got["mutable"]["makespan_slots"] < 3.5
    assert got["convergence"]["grew"]


def test_fig3_des_equals_reference():
    got = tlock.fig3(target_cs=100, seeds=(0,), engine="des", verbose=False)
    want = jlock.fig3(target_cs=100, seeds=(0,), engine="des", verbose=False)
    assert got == want
    assert tsweep._check_claims(got) == jsweep._check_claims(want)


def test_fig3_xdes_within_band_of_reference():
    got = tlock.fig3(target_cs=3, seeds=(0,), engine="xdes", device="cpu",
                     verbose=False)
    want = jlock.fig3(target_cs=3, seeds=(0,), engine="xdes", verbose=False)
    assert list(got) == list(want) == list(tlock.REGIMES)
    assert_results_agree(got, want)
    assert tsweep._check_claims(got) == jsweep._check_claims(want)
    with pytest.raises(ValueError, match="unknown engine"):
        tlock.fig3(engine="pallas")


def test_fidelity_study_des_exact_xdes_within_band(tmp_path):
    kw = dict(seeds=(0,), des_target=60, xdes_target=20, verbose=False)
    got = tfid.run_study(device="cpu", **kw)
    want = jfid.run_study(**kw)
    assert got["des_reference"] == want["des_reference"]
    for key in ("rows", "cells", "dts", "seeds", "des_target_cs",
                "xdes_target_cs", "n_configs"):
        assert got["meta"][key] == want["meta"][key], key
    assert [{k: v for k, v in g.items() if not k.endswith("_err")}
            for g in got["grid"]] == \
        [{k: v for k, v in g.items() if not k.endswith("_err")}
         for g in want["grid"]]
    for g, w in zip(got["grid"], want["grid"]):
        # the errors are x / des - 1, rounded to 4 places
        assert math.isclose(1 + g["throughput_rel_err"],
                            1 + w["throughput_rel_err"],
                            rel_tol=RTOL, abs_tol=1e-4), (g, w)
    assert set(got["throughput_err_band_by_dt"]) == \
        set(want["throughput_err_band_by_dt"])
    assert all(math.isfinite(v)
               for v in got["throughput_err_band_by_dt"].values())
    # the Markdown writer renders one dict to the reference's bytes
    tfid.write_md(got, str(tmp_path / "port.md"))
    jfid.write_md(got, str(tmp_path / "ref.md"))
    assert (tmp_path / "port.md").read_bytes() == \
        (tmp_path / "ref.md").read_bytes()


def test_fidelity_cli_writes_the_reference_bytes(tmp_path, monkeypatch):
    """``main`` writes the JSON and Markdown the reference's ``main`` would
    write for the same study dict (the study itself stubbed: its CPU cost
    is the test above)."""
    study = json.loads(json.dumps(tfid.run_study(
        seeds=(0,), des_target=30, xdes_target=5, n_steps=200,
        verbose=False, device="cpu")))
    seen = []
    monkeypatch.setattr(tfid, "run_study",
                        lambda **kw: seen.append(kw) or study)
    monkeypatch.setattr(jfid, "run_study", lambda **kw: study)
    tfid.main(["--device", "cpu", "--backend", "ref", "--out",
               str(tmp_path / "t" / "fid.json")])
    jfid.main(["--out", str(tmp_path / "j" / "fid.json")])
    assert seen[0]["device"] == "cpu" and seen[0]["backend"] == "ref"
    for name in ("fid.json", "fid.md"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_lockbench_cli_writes_the_reference_bytes(tmp_path):
    argv = ["--fig1", "--fig3", "--engine", "des", "--target-cs", "40"]
    got = tlock.main(argv + ["--out", str(tmp_path / "t" / "lb.json")])
    want = jlock.main(argv + ["--out", str(tmp_path / "j" / "lb.json")])
    assert got == want
    assert (tmp_path / "t" / "lb.json").read_bytes() == \
        (tmp_path / "j" / "lb.json").read_bytes()


def test_sched_bench_run_policy_and_cli_equal_reference(tmp_path):
    for policy in ("zero", "max", "mutable"):
        assert tsched.run_policy(policy, n_requests=120, seed=1) == \
            jsched.run_policy(policy, n_requests=120, seed=1), policy
    got = tsched.main(["--requests", "80",
                       "--out", str(tmp_path / "t" / "sb.json")])
    want = jsched.main(["--requests", "80",
                        "--out", str(tmp_path / "j" / "sb.json")])
    assert got == want
    assert (tmp_path / "t" / "sb.json").read_bytes() == \
        (tmp_path / "j" / "sb.json").read_bytes()
    reqs_t, reqs_j = tsched.bursty_workload(60, 3), jsched.bursty_workload(
        60, 3)
    assert [(t, vars(r)) for t, r in reqs_t] == \
        [(t, vars(r)) for t, r in reqs_j]


@pytest.mark.parametrize("gran", [25e-6, 50e-6])
def test_phold_processes_every_event(gran):
    sim = tphold.ShareEverythingPDES("mutable", 8, 200, gran)
    walls = []
    runner = threading.Thread(target=lambda: walls.append(sim.run()),
                              daemon=True)
    runner.start()
    runner.join(timeout=120)
    assert not runner.is_alive(), "a PHOLD worker hung"
    assert sim.processed == 200 and sim.done.is_set()
    assert walls[0] > 0
    assert sim.spin_iters() >= 0
    out = tphold.run_phold(locks=("mutable",), n_threads=(8,),
                           granularities=(gran,), n_events=200,
                           verbose=False)
    row = out[f"{int(gran * 1e6)}us"][8]["mutable"]
    assert row["wall_s"] > 0 and row["speedup"] > 0


def test_phold_cli_writes_its_result(tmp_path):
    out = tmp_path / "ph.json"
    res = tphold.main(["--quick", "--events", "120", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res) == {"50us"}


def test_clis_without_cuda_raise_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    runs = [(tlock.main, ["--fig3"]), (tlock.main, []),
            (tfid.main, []), (tsched.main, ["--xdes", "--scenarios", "1"])]
    for main, argv in runs:
        out = tmp_path / "x.json"
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ["--out", str(out)])
        assert not out.exists(), argv
    with pytest.raises(RuntimeError, match="CUDA"):
        tfid.run_study(seeds=(0,), des_target=5, xdes_target=5)

"""The port's sweep layer against the JAX package's on the CPU, part two:
the streamed grids (``stream=True`` under a memory budget of a few
chunks), the open-loop ``arrival_grid`` one-shot and streamed, a
quarantined config in a streamed ``fault_grid``, the ``refine_grid``
lattice, the arrival writer and the discipline writer with the refine
lattice attached, and the scheduler-policy sweep
(``repro_torch.serve.xdes_policy_sweep``).

Same rules as ``tests/test_torch_bench_grids.py``: every integer and
string equal, every float within rtol 2e-2.  The port plans a chunk as
the largest multiple of the reduction group under the budget, the
reference as the largest group x power of two
(``repro_torch.core.stream.plan_chunks``); a budget of a power-of-two
number of groups gives both the same chunks, so chunk sizes and counts are
compared too.
"""

import json
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from benchmarks import arrival_diagram as jarr
from benchmarks import discipline_diagram as jdisc
from benchmarks import sweep as jsweep
from repro.core import stream as jstream
from repro.serve import scheduler as jsched
from repro_torch import serve as tserve
from repro_torch.bench import arrival_diagram as tarr
from repro_torch.bench import discipline_diagram as tdisc
from repro_torch.bench import sweep as tsweep
from repro_torch.configs import catalog as tcatalog
from repro_torch.core import stream as tstream
from test_torch_bench_grids import assert_results_agree, run_both, written


def budget_mb(chunk: int, T: int, open_loop: bool = False) -> float:
    """A memory budget that holds exactly ``chunk`` configs at ``T``
    thread slots in both packages' model of a config's working set."""
    bpc = tstream.bytes_per_config(T, open_loop=open_loop)
    assert bpc == jstream.bytes_per_config(T, open_loop=open_loop)
    return (chunk + 0.5) * bpc / 2**20


def widest(n_scenarios: int, seed: int = 0) -> int:
    return int(tcatalog.sample_scenario_columns(n_scenarios,
                                                seed)["threads"].max())


#: Streamed grids: (arguments, configs a chunk), the chunk a power-of-two
#: number of reduction groups and at most a third of the grid.  Seed 6's
#: first three scenarios plan at most 89 steps at target_cs 5, which keeps
#: the plain versions' CPU time to a few seconds.
STREAMED = {
    "scenario": (dict(n_scenarios=3, target_cs=5, seed=6), 5),
    "oracle_grid": (dict(n_scenarios=3, target_cs=5, seed=6), 23),
    "discipline_grid": (dict(n_scenarios=3, target_cs=5, seed=6), 15),
    "arrival_grid": (dict(n_scenarios=1, target_cs=5, seed=6), 30),
}


@pytest.mark.parametrize("grid", list(STREAMED))
def test_streamed_grid_equals_reference(grid):
    """Measured largest relative float difference: 1.27e-08 (scenario,
    bucketed), 7.04e-08 (oracle_grid), 7.61e-08 (discipline_grid), 0.0
    (arrival_grid); wins, winners and chunk counts equal."""
    kw, chunk = STREAMED[grid]
    mem = budget_mb(chunk, widest(kw["n_scenarios"], kw["seed"]),
                    open_loop=grid == "arrival_grid")
    got, want = run_both(grid, stream=True, mem_mb=mem, **kw)
    assert got["meta"]["streamed"] is True
    assert got["meta"]["chunk_size"] == chunk
    assert got["meta"]["n_chunks"] >= 3
    assert assert_results_agree(got, want) <= 1e-6


def test_arrival_grid_one_shot_equals_reference(tmp_path):
    """Open loop, one shot: throughput and p95 winners, latency
    percentiles, SLO and shed fractions.  Measured largest relative float
    difference 0.0.  The arrival writer, fed the reference's dict, writes
    the reference's bytes."""
    got, want = run_both("arrival_grid", n_scenarios=1, target_cs=5)
    assert got["meta"]["streamed"] is False
    assert assert_results_agree(got, want) <= 1e-6
    got_csv, got_md = written(tarr, want, tmp_path / "port")
    assert (got_csv, got_md) == written(jarr, want, tmp_path / "ref")
    assert got_csv.count(b"\n") == 1 + len(want["phase"])


def test_quarantined_config_reaches_the_wins_as_in_reference(
        monkeypatch, tmp_path):
    """A streamed fault grid whose second chunk comes back with a NaN
    ``t_end`` in its second row, in both packages: the same config is
    quarantined and reported, and the sanitized row feeds the phase-cell
    win counts exactly as in the reference."""
    def poisoned(module):
        real, calls = module._run_chunk, [0]

        def run(*a, **k):
            calls[0] += 1
            out = {f: np.asarray(v).copy() for f, v in real(*a, **k).items()}
            if calls[0] == 2:
                out["t_end"][1] = np.nan
            return out
        return run

    chunk = 15
    kw = dict(n_scenarios=1, target_cs=5, stream=True,
              mem_mb=budget_mb(chunk, widest(1)))
    monkeypatch.setattr(tstream, "_run_chunk", poisoned(tstream))
    monkeypatch.setattr(jstream, "_run_chunk", poisoned(jstream))
    reports = {m: str(tmp_path / f"{m.__name__}.json")
               for m in (tsweep, jsweep)}
    for m, path in reports.items():
        monkeypatch.setattr(m, "FAILURES_PATH", path)
    got, want = run_both("fault_grid", **kw)
    assert got["meta"]["n_chunks"] == 75 // chunk
    assert assert_results_agree(got, want) <= 1e-6
    # the poisoned group's win went to a sanitized row, as in the reference
    assert sum(c["n"] for c in got["phase"]) == 5
    with open(reports[tsweep]) as f, open(reports[jsweep]) as g:
        t_rep, j_rep = json.load(f), json.load(g)
    assert [r["index"] for r in t_rep["failures"]] == \
        [r["index"] for r in j_rep["failures"]] == [chunk + 1]
    assert list(t_rep["failures"][0]["fields"]) == ["t_end"]


#: A refine lattice small enough for the CPU that still has a boundary
#: (every coarse cell, 16 dense points).  Four coarse points make a chunk
#: of four reduction groups in both packages' planners.
REFINE = dict(nx=2, ny=2, factor=2, target_cs=5, thread_range=(2, 6),
              cs_range=(1e-6, 3e-5))


def test_refine_grid_equals_reference(tmp_path):
    """Both passes streamed: the coarse winners, the boundary points and
    their winners equal the reference's.  Measured largest relative float
    difference 0.0.  The discipline writer, fed the reference's discipline
    dict with this lattice attached (as ``--refine`` does), writes the
    reference's bytes."""
    got, want = run_both("refine_grid", **REFINE)
    assert got["meta"]["chunk_size"] == 4 * 15
    assert got["meta"]["n_dense"] > 0
    assert assert_results_agree(got, want) <= 1e-6
    _, disc = run_both("discipline_grid", n_scenarios=1, target_cs=5)
    disc["refine"] = want
    assert written(tdisc, disc, tmp_path / "port") == \
        written(jdisc, disc, tmp_path / "ref")


# --------------------------------------------------------------------------
# the scheduler-policy sweep
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(n_scenarios=6),
    dict(n_scenarios=4, seed=3, slots=(2, 8)),
    dict(n_scenarios=4, workload="bursty"),
    dict(n_scenarios=4, workload="hetero", seed=1),
    dict(n_scenarios=4, arrival="poisson"),
    dict(n_scenarios=3, workload="bursty", arrival="bursty", seed=2),
])
def test_sample_sched_scenarios_equal_reference(kwargs):
    got = tserve.sample_sched_scenarios(**kwargs)
    want = jsched.sample_sched_scenarios(**kwargs)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert [s.capacity_rps for s in got] == [s.capacity_rps for s in want]
    for policy in tserve.SCHED_POLICY_LOCKS:
        assert [vars(s.to_sim_config(policy)) for s in got] == \
            [vars(s.to_sim_config(policy)) for s in want]
    assert tserve.SCHED_POLICY_LOCKS == jsched.SCHED_POLICY_LOCKS


@pytest.mark.parametrize("arrival,n", [("closed", 3), ("poisson", 3),
                                       ("bursty", 2)])
def test_xdes_policy_sweep_equals_reference(arrival, n):
    """Closed loop, and open loop (tail latency, SLO and shed fractions),
    on seed 3's serving scenarios (168 planned steps at target_cs 5).
    Measured largest relative float difference 0.0 in each case."""
    got_sc = tserve.sample_sched_scenarios(n, seed=3, arrival=arrival)
    want_sc = jsched.sample_sched_scenarios(n, seed=3, arrival=arrival)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tserve.xdes_policy_sweep(got_sc, target_cs=5, device="cpu")
        want = jsched.xdes_policy_sweep(want_sc, target_cs=5,
                                        backend="ref", shard=False)
    assert got["meta"]["open_loop"] is (arrival != "closed")
    assert assert_results_agree(got, want) <= 1e-6

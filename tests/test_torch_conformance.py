"""The port's cross-registry conformance suite, on ``device="cpu"``.

Built like ``tests/test_conformance.py``: the matrices are enumerated from
the registries of ``repro_torch.core.policy`` (``POLICY_IDS`` /
``DISCIPLINE_ROWS`` / ``WORKLOAD_ROWS`` / ``ARRIVAL_ROWS`` /
``FAULT_ROWS``) when this module is imported, so a row added to a registry
joins the matrix by being registered.  For every enumerated combination:

* the scan rollout equals the blocked rollout at B in {1, 32}, bit for
  bit, both through the ``kernel`` backend (whose wrappers take the plain
  versions for CPU tensors; the CUDA kernels are held against those on the
  card by ``chip_smoke.py``);
* :meth:`BatchResult.validate` — no non-finite value anywhere;
* conservation: completed CS equals the per-thread ledger, and for open
  rows ``arrived == shed + departed + in_flight`` with the Little's-law
  bound on the occupancy integral;
* against the JAX reference run op by op (``jax.disable_jit()``), within
  the parity contract (ROADMAP.md C1): C <= 32, T <= 8, 40 steps, rows
  without transcendentals (constant and bursty workloads); every discrete
  field exact, the float accumulators at ``rtol=1e-6``.
"""

import jax
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import policy as JP
from repro.core import xdes as jxdes
from repro_torch.core import policy as P
from repro_torch.core import xdes
from repro_torch.kernels import lock_sim as K

SHORT = (0.0, 3.7e-6)
LONG = (0.0, 80e-6)
WAKE = 8e-6

# -- enumerated from the registries at import time ------------------------
LOCKS = sorted(P.POLICY_IDS)                     # every policy id
WORKLOADS = list(P.WORKLOAD_ROWS)
ARRIVALS = list(P.ARRIVAL_ROWS)
OPEN_ARRIVALS = [a for a in ARRIVALS if P.ARRIVAL_IDS[a] != P.AR_CLOSED]
FAULTS = list(P.FAULT_ROWS)
PARK_COSTS = (0.25, 1.0, 16.0)                   # M:N environment axis
#: Workload rows whose arithmetic has no transcendental (C1, C3).
EXACT_WORKLOADS = ("constant", "bursty")

ROLLOUTS = {
    "blocked-1": dict(rollout="blocked", block_steps=1),
    "blocked-32": dict(rollout="blocked", block_steps=32),
}
CLOSED_FIELDS = ("completed", "completed_per_thread", "wake_count",
                 "final_sws", "spin_cpu", "t_end", "steps_run")
OPEN_FIELDS = CLOSED_FIELDS + xdes.OPEN_RESULT_FIELDS
DISCRETE = ("completed", "completed_per_thread", "wake_count", "final_sws",
            "t_end", "steps_run", "lat_hist", "arrived", "shed", "departed",
            "slo_viol", "in_flight")


def test_registry_closure():
    """The registries are dense and mutually consistent, and the kernels
    implement exactly their ids."""
    covered = [pid for row in P.DISCIPLINE_ROWS.values()
               for pid in row.policy_ids]
    assert sorted(covered) == sorted(P.POLICY_IDS.values())
    assert len(covered) == len(set(covered))     # a partition, no overlap
    assert sorted(P.POLICY_IDS.values()) == list(range(len(P.POLICY_IDS)))
    assert set(P.DEFAULT_ALPHA) == set(P.POLICY_IDS)
    for ids, column in ((P.POLICY_IDS, "policy"), (P.ORACLE_IDS, "oracle"),
                        (P.WORKLOAD_IDS, "workload"), (P.FAULT_IDS, "fault"),
                        (P.TIE_BREAK_IDS, "tb"), (P.ARRIVAL_IDS, "arrival")):
        assert sorted(ids.values()) == list(range(len(ids)))
        assert K.KERNEL_IDS[column] == frozenset(ids.values())


def _assert_equal(a, b, fields, msg=""):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{msg}: {f}")


# -------------------------------------------------------------------------
# The closed-loop matrix: lock x workload x fault, park_cost riding along
# -------------------------------------------------------------------------
def _closed_kwargs():
    rng = np.random.default_rng(0)
    out = []
    for lock in LOCKS:
        for w in WORKLOADS:
            for flt in FAULTS:
                i = len(out)
                out.append(dict(
                    lock=lock, threads=int(rng.integers(2, 9)),
                    cores=int(rng.integers(2, 9)),
                    cs=SHORT if i % 2 else LONG, ncs=SHORT,
                    wake_latency=WAKE, seed=int(rng.integers(0, 1000)),
                    workload=w, fault=flt,
                    fault_rate=0.0 if flt == "none" else 0.25,
                    park_cost=PARK_COSTS[i % len(PARK_COSTS)],
                    tie_break=("id", "random")[(i // 3) % 2]))
    return out


def _run(cfgs, n_steps, **kw):
    return xdes.simulate_batch(cfgs, n_steps=n_steps, device="cpu", **kw)


@pytest.fixture(scope="module")
def closed_matrix():
    cfgs = [P.SimConfig(**kw) for kw in _closed_kwargs()]
    runs = {rk: _run(cfgs, 220, **kw) for rk, kw in ROLLOUTS.items()}
    runs["scan"] = _run(cfgs, 220, rollout="scan")
    return cfgs, runs


@pytest.mark.parametrize("rollout", list(ROLLOUTS))
def test_closed_matrix_scan_equals_blocked(closed_matrix, rollout):
    cfgs, runs = closed_matrix
    _assert_equal(runs["scan"], runs[rollout], CLOSED_FIELDS,
                  f"scan=={rollout}")


def test_closed_matrix_validates_and_conserves(closed_matrix):
    cfgs, runs = closed_matrix
    res = runs["scan"].validate("port conformance matrix")
    assert len(cfgs) == len(LOCKS) * len(WORKLOADS) * len(FAULTS)
    per = np.asarray(res.completed_per_thread, np.int64)
    for i, c in enumerate(cfgs):
        assert per[i, c.threads:].sum() == 0, (i, c.lock)   # padded lanes
        assert per[i].sum() == int(res.completed[i]), (i, c.lock)
    assert (res.steps_run == 220).all()
    # the matrix actually exercises the machine: most cells complete CSes
    assert (res.completed > 0).mean() > 0.9


# -------------------------------------------------------------------------
# The open-loop matrix: lock x open arrival rows, closed rows mixed in
# -------------------------------------------------------------------------
def _open_kwargs():
    rng = np.random.default_rng(1)
    out = []
    for lock in LOCKS:
        for a in OPEN_ARRIVALS:
            out.append(dict(
                lock=lock, threads=int(rng.integers(2, 9)),
                cores=int(rng.integers(2, 9)), cs=SHORT, ncs=SHORT,
                wake_latency=WAKE, seed=int(rng.integers(0, 1000)),
                arrival=a, arrival_rate=float(rng.uniform(5e4, 6e5)),
                queue_cap=int(rng.integers(4, 32)),
                workload=EXACT_WORKLOADS[len(out) % 2], wl_period=8e-5,
                park_cost=PARK_COSTS[len(out) % len(PARK_COSTS)]))
    for j, lock in enumerate(LOCKS[:4]):
        out.append(dict(lock=lock, threads=5, cores=4, cs=SHORT, ncs=SHORT,
                        wake_latency=WAKE, seed=100 + j))
    return out


@pytest.fixture(scope="module")
def open_matrix():
    cfgs = [P.SimConfig(**kw) for kw in _open_kwargs()]
    runs = {rk: _run(cfgs, 260, **kw) for rk, kw in ROLLOUTS.items()}
    runs["scan"] = _run(cfgs, 260, rollout="scan")
    return cfgs, runs


@pytest.mark.parametrize("rollout", list(ROLLOUTS))
def test_open_matrix_scan_equals_blocked(open_matrix, rollout):
    cfgs, runs = open_matrix
    _assert_equal(runs["scan"], runs[rollout], OPEN_FIELDS,
                  f"scan=={rollout}")


def test_open_matrix_validates_and_conserves(open_matrix):
    """Request conservation and the sharp Little's-law bound across the
    matrix (closed rows: every open counter stays 0)."""
    cfgs, runs = open_matrix
    res = runs["scan"].validate("port open conformance matrix")
    assert int(res.arrived.sum()) > 0 and int(res.departed.sum()) > 0
    for i, c in enumerate(cfgs):
        arrived, shed = int(res.arrived[i]), int(res.shed[i])
        departed, fly = int(res.departed[i]), int(res.in_flight[i])
        assert arrived - shed - departed - fly == 0, (i, c.lock)
        assert 0 <= fly <= c.queue_cap + c.threads, (i, c.lock)
        assert int(res.lat_hist[i].sum()) == departed, (i, c.lock)
        occ, lat = float(res.occ_int[i]), float(res.lat_sum[i])
        slack = 1e-3 * max(occ, lat) + 1e-6
        assert occ - lat >= -slack, (i, c.lock)
        assert occ - lat <= fly * float(res.t_end[i]) + slack, (i, c.lock)
        if not c.open_loop:
            assert arrived == 0 and int(res.completed[i]) > 0, (i, c.lock)


# -------------------------------------------------------------------------
# Against the JAX reference, op by op (C1): C <= 32, T <= 8, 40 steps
# -------------------------------------------------------------------------
#: A covering subset of the closed matrix's transcendental-free rows: two
#: faults per lock (three for the first half of the locks), the constant
#: and the bursty workload alternating, so that every lock, every fault and
#: both workloads are compared; in chunks of at most 32 configs.
def _exact_closed():
    rows = {(kw["lock"], kw["workload"], kw["fault"]): kw
            for kw in _closed_kwargs()}
    out = []
    for li, lock in enumerate(LOCKS):
        shifts = (0, 2, 4) if 2 * li < len(LOCKS) else (0, 2)
        for n, shift in enumerate(shifts):
            out.append(rows[lock, EXACT_WORKLOADS[(li + n) % 2],
                            FAULTS[(li + shift) % len(FAULTS)]])
    return out


_EXACT_CLOSED = _exact_closed()
_CHUNK = 32
_CHUNKS = [(i, i + _CHUNK) for i in range(0, len(_EXACT_CLOSED), _CHUNK)]
_REF_STEPS = 40


def _against_reference(kws, fields):
    with jax.disable_jit():
        want = jxdes.simulate_batch([JP.SimConfig(**kw) for kw in kws],
                                    n_steps=_REF_STEPS, backend="ref",
                                    rollout="scan", shard=False)
    got = _run([P.SimConfig(**kw) for kw in kws], _REF_STEPS,
               rollout="scan")
    for f in fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if f in DISCRETE:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.dt, want.dt)
    return got


def test_exact_rows_cover_every_lock_fault_and_workload():
    assert {kw["lock"] for kw in _EXACT_CLOSED} == set(LOCKS)
    assert {kw["fault"] for kw in _EXACT_CLOSED} == set(FAULTS)
    assert {kw["workload"] for kw in _EXACT_CLOSED} == set(EXACT_WORKLOADS)
    assert len({tuple(sorted(kw.items())) for kw in _EXACT_CLOSED}) \
        == len(_EXACT_CLOSED)


@pytest.mark.parametrize("chunk", _CHUNKS, ids=lambda c: f"rows{c[0]}")
def test_closed_matrix_against_unjitted_reference(chunk):
    kws = _EXACT_CLOSED[slice(*chunk)]
    assert len(kws) <= 32
    got = _against_reference(kws, CLOSED_FIELDS)
    assert got.completed.sum() > 0


def test_open_matrix_against_unjitted_reference():
    kws = _open_kwargs()
    assert len(kws) <= 32
    got = _against_reference(kws, OPEN_FIELDS)
    assert got.departed.sum() > 0

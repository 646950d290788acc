"""The port's event-driven DES, lock baselines and ``repro_torch.core``'s
public API against the JAX package's, on the CPU.

* ``repro_torch.core.des`` equals ``repro.core.des`` field for field, floats
  included, with no tolerance: every ``SimResult`` field (``sws_trace``,
  the recorded ``timeline`` and the open-loop ``latencies`` among them),
  every task's end state and the lock model's counters, over all ten lock
  models x the four workload rows x the three arrival rows x the five
  fault rows x park_cost {1, 8} x two seeds (6 or 12 threads, target_cs
  60).  Both draw from :class:`random.Random` and run the same scalar
  policy arithmetic, so any difference is a fault of the copy.
* ``SimConfig``'s five DES keyword methods give the reference's dicts (the
  oracle compared by type and ``k``).
* ``repro_torch.core.__all__`` is the reference's, in its order, and
  ``make_lock`` builds every kind of ``ALL_LOCKS`` with mutual exclusion
  and no lost updates under 8 threads.
* The hypothesis properties of ``tests/test_des_props.py`` hold on the
  port's DES at the reference's ``max_examples``.
"""

import dataclasses
import itertools
import threading
import time

import pytest

from repro.core import des as jdes
from repro.core.policy import SimConfig as JConfig
from repro_torch.core import des as tdes
from repro_torch.core.policy import SimConfig as TConfig

SHORT = (0.0, 3.7e-6)
WAKE = 8e-6
WORKLOADS = ("constant", "bursty", "hetero", "jitter")
ARRIVALS = ("closed", "poisson", "bursty")
FAULTS = ("none", "preempt", "oversub", "lostwake", "jitter")
FAULT_RATES = {"none": 0.0, "preempt": 0.6, "oversub": 0.6,
               "lostwake": 0.5, "jitter": 0.5}
ORACLES = ("paper", "aimd", "fixed", "history")
PARK_COSTS = (1.0, 8.0)
SEEDS = (0, 1)
TARGET_CS = 60


def _config(cls, lock, i, workload, arrival, fault, park_cost, seed):
    """The i-th cell of the product: windowed locks cycle the oracle
    families, threads alternate 6 / 12 on 4 cores."""
    return cls(lock, threads=(6, 12)[i % 2], cores=4, cs=SHORT, ncs=SHORT,
               wake_latency=WAKE, seed=seed, oracle=ORACLES[i % 4],
               k=3 + i % 5, workload=workload, wl_period=8e-5,
               arrival=arrival, arrival_rate=3e5, queue_cap=16,
               fault=fault, fault_rate=FAULT_RATES[fault],
               fault_scale=2e-5, park_cost=park_cost)


def _run(des, cfg):
    sim = des.LockSim(cfg.lock, cfg.threads, cfg.cores, cfg.cs, cfg.ncs,
                      cfg.wake_latency, seed=cfg.seed, record_timeline=True,
                      lock_kwargs=cfg.des_kwargs(),
                      **cfg.workload_kwargs(), **cfg.arrival_kwargs(),
                      **cfg.fault_kwargs(), **cfg.env_kwargs())
    res = sim.run(target_cs=TARGET_CS)
    plain = lambda obj: {k: v for k, v in vars(obj).items()
                         if isinstance(v, (int, float, list, dict))
                         or v is None}
    model = plain(sim.model)
    if hasattr(sim.model, "oracle"):
        model["oracle"] = plain(sim.model.oracle)
    return (dataclasses.asdict(res),
            [dataclasses.asdict(t) for t in sim.tasks], model, sim.now)


@pytest.mark.parametrize("lock", list(jdes._MODELS))
def test_des_equals_reference_field_for_field(lock):
    assert list(tdes._MODELS) == list(jdes._MODELS)
    product = itertools.product(WORKLOADS, ARRIVALS, FAULTS, PARK_COSTS,
                                SEEDS)
    for i, (wl, arr, flt, pc, seed) in enumerate(product):
        where = (lock, wl, arr, flt, pc, seed)
        want = _run(jdes, _config(JConfig, lock, i, wl, arr, flt, pc, seed))
        got = _run(tdes, _config(TConfig, lock, i, wl, arr, flt, pc, seed))
        assert got[0]["completed_cs"] >= TARGET_CS, where
        assert got == want, where
        # the timeline holds the floats of every event exactly
        assert got[0]["timeline"] and got[0]["timeline"] == want[0][
            "timeline"], where


def test_simulate_and_result_properties_equal():
    """``simulate`` with its defaults (Fig. 3's machine) and the derived
    properties, at 20 threads."""
    for lock in tdes._MODELS:
        a = jdes.simulate(lock, threads=20, target_cs=200, seed=3)
        b = tdes.simulate(lock, threads=20, target_cs=200, seed=3)
        assert dataclasses.asdict(b) == dataclasses.asdict(a), lock
        assert (b.throughput, b.sync_cpu_per_cs) == \
            (a.throughput, a.sync_cpu_per_cs), lock
    sim_a = jdes.LockSim("mutable", 4, 4, SHORT, SHORT, WAKE, seed=2,
                         arrival="poisson", arrival_rate=4e5)
    sim_b = tdes.LockSim("mutable", 4, 4, SHORT, SHORT, WAKE, seed=2,
                         arrival="poisson", arrival_rate=4e5)
    a, b = sim_a.run(target_cs=300), sim_b.run(target_cs=300)
    assert b.latencies == a.latencies and len(b.latencies) >= 300
    assert b.mean_latency == a.mean_latency
    for q in (0.5, 0.95, 0.99):
        assert b.latency_percentile(q) == a.latency_percentile(q)
    assert (b.arrived, b.shed, b.slo_viol) == (a.arrived, a.shed, a.slo_viol)


def test_simconfig_des_keyword_methods_equal_reference():
    from repro.core.policy import POLICY_IDS

    for i, lock in enumerate(POLICY_IDS):
        kw = dict(threads=6, cores=4, cs=SHORT, ncs=SHORT, wake_latency=WAKE,
                  seed=i, oracle=ORACLES[i % 4], k=2 + i, sws_init=2,
                  sws_max=3 if i % 2 else None,
                  alpha=None if i % 3 else 0.05, spin_budget=1e-6 * (1 + i),
                  workload=WORKLOADS[i % 4], wl_period=5e-5, wl_duty=0.3,
                  wl_burst=6.0, wl_spread=3.0, arrival_phase=0.5,
                  arrival=ARRIVALS[i % 3], arrival_rate=2e5, queue_cap=9,
                  fault=FAULTS[i % 5], fault_rate=0.4, fault_scale=3e-5,
                  park_cost=2.0)
        j, t = JConfig(lock, **kw), TConfig(lock, **kw)
        jd, td = j.des_kwargs(), t.des_kwargs()
        jo, to = jd.pop("oracle", None), td.pop("oracle", None)
        assert td == jd, lock
        assert (jo is None) == (to is None), lock
        if jo is not None:
            assert type(to).__name__ == type(jo).__name__, lock
            assert to.k == jo.k, lock
            assert type(to).__module__ == "repro_torch.core.oracle"
        for name in ("workload_kwargs", "arrival_kwargs", "fault_kwargs",
                     "env_kwargs"):
            assert getattr(t, name)() == getattr(j, name)(), (lock, name)


def test_public_api_equals_reference():
    import repro.core as jcore
    import repro_torch.core as tcore

    assert tcore.__all__ == jcore.__all__
    for name in tcore.__all__:
        assert hasattr(tcore, name), name
        assert type(getattr(tcore, name)) is type(getattr(jcore, name)), name
    assert list(tcore.ALL_LOCKS) == list(jcore.ALL_LOCKS)
    assert list(tcore.LOCKS) == list(jcore.LOCKS)
    for kind, cls in tcore.ALL_LOCKS.items():
        assert cls.__name__ == jcore.ALL_LOCKS[kind].__name__
        assert cls.__module__.startswith("repro_torch.core.")
    assert tcore.policy.__name__ == "repro_torch.core.policy"
    with pytest.raises(ValueError, match="unknown lock kind"):
        tcore.make_lock("futex")


@pytest.mark.parametrize("kind", ["adaptive", "mcs", "mutable", "sleep",
                                  "tas", "ttas"])
def test_make_lock_mutual_exclusion_and_counter(kind):
    """``tests/test_mutlock.py``'s check on the port's locks: 8 threads x
    200 increments, no lost update, at most one thread in the CS, every
    worker joined."""
    from repro_torch.core import ALL_LOCKS, make_lock

    assert kind in ALL_LOCKS
    lock = make_lock(kind)
    n_threads, n_iters = 8, 200
    counter = {"v": 0, "in_cs": 0, "max_in_cs": 0}

    def worker():
        for _ in range(n_iters):
            with lock:
                counter["in_cs"] += 1
                counter["max_in_cs"] = max(counter["max_in_cs"],
                                           counter["in_cs"])
                v = counter["v"]
                time.sleep(0)           # widen the race window
                counter["v"] = v + 1
                counter["in_cs"] -= 1

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), f"{kind}: worker hung (lost wake-up?)"
    assert counter["v"] == n_threads * n_iters, f"{kind}: lost updates"
    assert counter["max_in_cs"] == 1, f"{kind}: mutual exclusion violated"


# --------------------------------------------------------------------------
# tests/test_des_props.py on the port's DES (hypothesis, a dev dependency)
# --------------------------------------------------------------------------
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PROP_LOCKS = ["tas", "ttas", "mcs", "sleep", "adaptive", "mutable"]

if HAVE_HYPOTHESIS:
    @settings(max_examples=30, deadline=None)
    @given(
        lock=st.sampled_from(PROP_LOCKS),
        threads=st.integers(1, 12),
        cores=st.integers(1, 24),
        cs_hi=st.floats(1e-7, 1e-4),
        ncs_hi=st.floats(1e-7, 1e-4),
        wake=st.floats(1e-7, 5e-5),
        seed=st.integers(0, 2**16),
    )
    def test_des_progress_and_conservation(lock, threads, cores, cs_hi,
                                           ncs_hi, wake, seed):
        sim = tdes.LockSim(lock, threads, cores, (0.0, cs_hi),
                           (0.0, ncs_hi), wake, seed=seed)
        res = sim.run(target_cs=60)
        assert res.completed_cs >= 60
        assert res.completed_cs == sum(t.cs_done for t in sim.tasks)
        assert res.t_end > 0
        assert res.spin_cpu >= 0.0

    @settings(max_examples=20, deadline=None)
    @given(
        threads=st.integers(2, 16),
        cores=st.integers(2, 24),
        initial=st.integers(1, 8),
        k=st.integers(1, 20),
        seed=st.integers(0, 2**16),
    )
    def test_mutable_window_bounds(threads, cores, initial, k, seed):
        from repro_torch.core.oracle import EvalSWS

        sim = tdes.LockSim("mutable", threads, cores, (0.0, 2e-6),
                           (0.0, 2e-6), 5e-6, seed=seed,
                           lock_kwargs={"initial_sws": min(initial, cores),
                                        "oracle": EvalSWS(k=k)})
        res = sim.run(target_cs=150)
        assert res.completed_cs >= 150
        for _, sws in res.sws_trace:
            assert 1 <= sws <= sim.model.max

    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2**16), threads=st.integers(2, 10))
    def test_mutable_thc_returns_to_idle(seed, threads):
        """After the run drains, no phantom waiters: every task retired and
        the model's thread count back at 0."""
        sim = tdes.LockSim("mutable", threads, 8, (0.0, 3e-6), (0.0, 3e-6),
                           4e-6, seed=seed, max_cs_per_thread=5)
        res = sim.run(target_cs=5 * threads)
        assert res.completed_cs == 5 * threads
        assert all(t.state == tdes.DONE for t in sim.tasks)
        assert sim.model.thc == 0

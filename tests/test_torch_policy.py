"""The port's policy registries and encoders against the JAX package's.

``repro_torch.core.policy`` is an independent copy (the port imports
nothing from ``repro``), so every id, name, salt and flag is compared here,
enumerated from the registries at import time — a row added to one package
and not the other fails instead of silently diverging.
"""

import numpy as np
import pytest

from repro.configs import catalog as jcatalog
from repro.core import policy as JP
from repro.core import xdes as jxdes
from repro_torch.configs import catalog as tcatalog
from repro_torch.core import policy as TP
from repro_torch.core import xdes as txdes

ID_TABLES = ("POLICY_IDS", "ORACLE_IDS", "WORKLOAD_IDS", "ARRIVAL_IDS",
             "FAULT_IDS", "TIE_BREAK_IDS")
NAME_TABLES = ("POLICY_NAMES", "ORACLE_NAMES", "WORKLOAD_NAMES",
               "ARRIVAL_NAMES", "FAULT_NAMES", "TIE_BREAK_NAMES")
CONSTANTS = ("NCS", "CS", "SPIN", "SLEEP_ST", "WAKING", "DONE",
             "STATE_NAMES", "DEFAULT_ALPHA", "DEFAULT_SPIN_BUDGET",
             "BO_SALT", "BO_CAP", "EWMA_ONE", "EWMA_SHIFT",
             "WL_PHASE_SALT", "WL_SPREAD_SALT", "AR_SALT", "AR_PHASE_SALT",
             "TB_SALT", "FLT_GATE_SALT", "FLT_WAKE_SALT", "FLT_MAG_SALT",
             "QUEUE_MAX", "LAT_NBINS", "LAT_BIN0", "LAT_BINS_PER_OCTAVE",
             "DISCIPLINE_FLAG_ATTRS", "CONFIG_FIELDS", "RAW_CONFIG_FIELDS",
             "RAW_OPEN_DEFAULTS", "RAW_FAULT_DEFAULTS", "RAW_ENV_DEFAULTS",
             "HANDOFF_POLICIES", "SLEEPING_POLICIES")


@pytest.mark.parametrize("name", ID_TABLES + NAME_TABLES + CONSTANTS)
def test_registry_constant_equal(name):
    assert getattr(TP, name) == getattr(JP, name)


@pytest.mark.parametrize("lock", sorted(JP.POLICY_IDS))
def test_discipline_flags_and_rules_per_policy(lock):
    pid = JP.POLICY_IDS[lock]
    assert TP.discipline_flags(pid) == JP.discipline_flags(pid)
    jrow, trow = JP.POLICY_ROW[pid], TP.POLICY_ROW[pid]
    assert (trow.name, trow.policy_ids) == (jrow.name, jrow.policy_ids)
    # the two decision functions are the same row by name
    assert trow.arrival_sleeps.__name__ == jrow.arrival_sleeps.__name__
    assert trow.quota.__name__ == jrow.quota.__name__
    # ... and by value over a small grid of their integer arguments
    for rank in (0, 1):
        for thc in (0, 1, 3):
            for sws in (1, 2):
                for free in (0, 1):
                    assert TP.discipline_arrival_sleeps(
                        pid, rank, thc, sws, free) == \
                        JP.discipline_arrival_sleeps(pid, rank, thc, sws,
                                                     free)
                    assert TP.discipline_release_quota(
                        pid, rank - 1, thc, sws, thc, free) == \
                        JP.discipline_release_quota(pid, rank - 1, thc, sws,
                                                    thc, free)


def test_registry_rows_enumerate_alike():
    assert list(TP.DISCIPLINE_ROWS) == list(JP.DISCIPLINE_ROWS)
    for reg, key in (("WORKLOAD_ROWS", "wid"), ("FAULT_ROWS", "fid"),
                     ("ARRIVAL_ROWS", "aid")):
        t, j = getattr(TP, reg), getattr(JP, reg)
        assert [(n, getattr(r, key)) for n, r in t.items()] == \
            [(n, getattr(r, key)) for n, r in j.items()]
    assert [f.__name__ for f in TP.ORACLE_ROWS] == \
        [f.__name__ for f in JP.ORACLE_ROWS]


@pytest.mark.parametrize("oracle", sorted(JP.ORACLE_IDS))
def test_oracle_update_scalar_equal(oracle):
    oid = JP.ORACLE_IDS[oracle]
    for spun in (0, 1):
        for slept in (0, 1):
            for sws, cnt, ewma, k in ((1, 0, 0, 3), (4, 2, 200, 3),
                                      (7, 9, 31, 10)):
                assert TP.oracle_update(oid, spun, slept, sws, cnt, ewma,
                                        k) == \
                    JP.oracle_update(oid, spun, slept, sws, cnt, ewma, k)


def test_row_functions_scalar_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        u, base, expd, ts = rng.uniform(0.01, 2.0, 4)
        gate, burst = float(rng.integers(0, 2)), rng.uniform(1, 16)
        for wid in JP.WORKLOAD_IDS.values():
            for is_ncs in (0, 1):
                assert TP.workload_hold(wid, is_ncs, base, expd, gate, ts,
                                        burst) == \
                    JP.workload_hold(wid, is_ncs, base, expd, gate, ts,
                                     burst)
        for fid in JP.FAULT_IDS.values():
            assert TP.fault_progress_scale(fid, 1.0, u / 2, 0.25) == \
                JP.fault_progress_scale(fid, 1.0, u / 2, 0.25)
            assert TP.fault_wake_delay(fid, base, u / 2, expd, 0.25, ts) == \
                JP.fault_wake_delay(fid, base, u / 2, expd, 0.25, ts)
        assert TP.workload_off_gate(base, u, expd, 0.25) == \
            JP.workload_off_gate(base, u, expd, 0.25)
        assert TP.workload_thread_scale(u / 2, burst) == \
            JP.workload_thread_scale(u / 2, burst)
        seed, tid, ctr = (int(x) for x in rng.integers(0, 2**31, 3))
        assert TP.counter_uniform_scalar(seed, tid % 128, ctr) == \
            JP.counter_uniform_scalar(seed, tid % 128, ctr)


def test_algorithm1_scalar_helpers_equal():
    """The scalar Algorithm-1 helpers the threaded lock and oracles use."""
    for spun in (False, True):
        for slept in (False, True):
            for sws in (1, 2, 5):
                for cnt in (0, 2, 9):
                    for k in (1, 3, 10):
                        assert TP.eval_sws_delta(spun, slept, sws, cnt, k) \
                            == JP.eval_sws_delta(spun, slept, sws, cnt, k)
    for sws in range(1, 6):
        for delta in range(-6, 7):
            assert TP.clamp_delta(sws, delta, 1, 4) == \
                JP.clamp_delta(sws, delta, 1, 4)
            for thc in range(0, 8):
                assert TP.wake_correction(delta, thc, sws) == \
                    JP.wake_correction(delta, thc, sws)
                assert TP.should_sleep_on_arrival(thc, sws) == \
                    JP.should_sleep_on_arrival(thc, sws)
                assert TP.release_quota(delta, thc, sws) == \
                    JP.release_quota(delta, thc, sws)
    for wuc in range(-4, 5):
        assert TP.latch_wuc(wuc) == JP.latch_wuc(wuc)


# --------------------------------------------------------------------------
# SimConfig -> columns, and the planner
# --------------------------------------------------------------------------
def _field_dicts():
    """SimConfig keyword dicts that touch every field and every registry
    row, from a numpy seed."""
    rng = np.random.default_rng(7)
    locks, oracles = sorted(JP.POLICY_IDS), sorted(JP.ORACLE_IDS)
    workloads, faults = list(JP.WORKLOAD_ROWS), list(JP.FAULT_ROWS)
    out = []
    for i in range(120):
        flt = faults[i % len(faults)]
        out.append(dict(
            lock=locks[i % len(locks)], threads=int(rng.integers(1, 65)),
            cores=int(rng.integers(1, 33)),
            cs=(0.0, float(rng.uniform(1e-6, 4e-4))),
            ncs=(float(rng.uniform(0, 1e-6)), float(rng.uniform(1e-6, 4e-4))),
            wake_latency=float(rng.uniform(2e-6, 5e-5)),
            alpha=None if i % 3 else float(rng.uniform(0, 0.2)),
            sws_init=int(rng.integers(1, 9)),
            sws_max=None if i % 4 else int(rng.integers(1, 40)),
            k=int(rng.integers(1, 31)),
            spin_budget=float(rng.uniform(1e-6, 4e-6)),
            seed=int(rng.integers(0, 2**32)),
            oracle=oracles[i % len(oracles)],
            workload=workloads[i % len(workloads)],
            wl_period=float(rng.uniform(1e-5, 1e-3)),
            wl_duty=float(rng.uniform(0.1, 1.0)),
            wl_burst=float(rng.uniform(1, 16)),
            wl_spread=float(rng.uniform(1, 8)),
            arrival_phase=float(rng.uniform(0, 2)),
            tie_break=("id", "random")[i % 2],
            fault=flt, fault_rate=0.0 if flt == "none" else 0.25,
            fault_scale=float(rng.uniform(1e-5, 1e-4)),
            park_cost=float(rng.choice([0.25, 1.0, 16.0]))))
    return out


def test_simconfig_fields_and_defaults_equal():
    import dataclasses

    jf = [(f.name, f.default) for f in dataclasses.fields(JP.SimConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TP.SimConfig)]
    assert tf == jf
    for kw in _field_dicts()[:20]:
        j, t = JP.SimConfig(**kw), TP.SimConfig(**kw)
        assert (t.alpha_eff, t.sws_max_eff, t.sws_start, t.open_loop) == \
            (j.alpha_eff, j.sws_max_eff, j.sws_start, j.open_loop)
    for bad in (dict(lock="nope"), dict(lock="tas", threads=0),
                dict(lock="tas", park_cost=0.0),
                dict(lock="tas", fault_rate=2.0)):
        kw = dict(threads=2, cores=2, cs=(0, 1e-6), ncs=(0, 1e-6)) | bad
        with pytest.raises(ValueError):
            TP.SimConfig(**kw)


def test_encode_configs_array_equal():
    kws = _field_dicts()
    jarr = JP.encode_configs([JP.SimConfig(**kw) for kw in kws])
    tarr = TP.encode_configs([TP.SimConfig(**kw) for kw in kws])
    assert list(tarr) == list(jarr)
    for key in jarr:
        assert tarr[key].dtype == jarr[key].dtype, key
        np.testing.assert_array_equal(tarr[key], jarr[key], err_msg=key)
    # the RAW-column path too, and its validation
    jraw = JP.config_columns([JP.SimConfig(**kw) for kw in kws])
    traw = TP.config_columns([TP.SimConfig(**kw) for kw in kws])
    for key in jraw:
        np.testing.assert_array_equal(traw[key], jraw[key], err_msg=key)
    tenc = TP.encode_columns(traw)
    for key in jarr:
        np.testing.assert_array_equal(tenc[key], jarr[key], err_msg=key)
    bad = dict(traw, queue_cap=np.full(len(kws), 10_000))
    with pytest.raises(ValueError, match="queue_cap"):
        TP.encode_columns(bad)
    assert TP.encode_columns(bad, strict=False)["q_cap"].max() == TP.QUEUE_MAX


@pytest.mark.parametrize("target_cs", [50, 300])
def test_plan_schedule_equal(target_cs):
    kws = _field_dicts()
    jdt, jsteps = jxdes.plan_schedule([JP.SimConfig(**kw) for kw in kws],
                                      target_cs)
    tdt, tsteps = txdes.plan_schedule([TP.SimConfig(**kw) for kw in kws],
                                      target_cs)
    np.testing.assert_array_equal(tdt, jdt)
    np.testing.assert_array_equal(tsteps, jsteps)
    jb, tb = jxdes.plan_buckets(jsteps), txdes.plan_buckets(tsteps)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(a, b)
    assert txdes.MAX_STEPS == jxdes.MAX_STEPS
    assert txdes.DEFAULT_BLOCK_STEPS == jxdes.DEFAULT_BLOCK_STEPS
    assert [txdes._pad_quantum(n) for n in range(1, 70)] == \
        [jxdes._pad_quantum(n) for n in range(1, 70)]


@pytest.mark.parametrize("factory,kwargs", [
    ("lock_fig3_grid", {}),
    ("lock_scenario_sweep", dict(n_scenarios=7)),
    ("lock_oracle_sweep", dict(n_scenarios=5)),
    ("lock_discipline_sweep", dict(n_scenarios=5, seed=3)),
    ("lock_arrival_sweep", dict(n_scenarios=3, seed=2)),
    ("lock_workload_sweep", dict(n_scenarios=3, seed=1)),
    ("lock_workload_sweep", dict(n_scenarios=2, workloads=("hetero",),
                                 disciplines=("mutable", "fifo"))),
    ("lock_fault_sweep", dict(n_scenarios=3, seed=4)),
    ("lock_fault_sweep", dict(n_scenarios=2, faults=("lostwake", "none"))),
    ("lock_park_sweep", dict(n_scenarios=3, seed=5)),
    ("lock_park_sweep", dict(n_scenarios=2, park_costs=(100.0, 0.1),
                             oracles=("aimd",))),
])
def test_catalog_specs_equal(factory, kwargs):
    import dataclasses

    jc = getattr(jcatalog, factory)(**kwargs)
    tc = getattr(tcatalog, factory)(**kwargs)
    assert [dataclasses.asdict(c) for c in tc] == \
        [dataclasses.asdict(c) for c in jc]
    assert tcatalog.lock_oracle_variants() == jcatalog.lock_oracle_variants()
    assert tcatalog.lock_discipline_variants() == \
        jcatalog.lock_discipline_variants()


#: The sweep-layer names of the catalog, compared by value (constants) or
#: called with defaults and overrides (builders of variants and params).
CATALOG_CONSTANTS = ("LOCK_WORKLOADS", "LOCK_FAULTS", "LOCK_FAULT_RATES",
                     "LOCK_PARK_COSTS")


@pytest.mark.parametrize("name", CATALOG_CONSTANTS)
def test_catalog_constant_equal(name):
    assert getattr(tcatalog, name) == getattr(jcatalog, name)


@pytest.mark.parametrize("factory,kwargs", [
    ("lock_workload_variants", {}),
    ("lock_workload_variants", dict(workloads=("jitter", "constant"),
                                    oracles=("fixed",))),
    ("lock_fault_variants", {}),
    ("lock_fault_variants", dict(faults=("oversub",),
                                 disciplines=("fissile", "sleep"))),
    ("lock_park_variants", {}),
    ("lock_park_variants", dict(park_costs=(10.0,),
                                disciplines=("hapax", "mutable"))),
    ("lock_fault_params", dict(sc=dict(cs_hi=3.7e-6, ncs_hi=2.1e-4))),
    ("lock_workload_params", dict(sc=dict(cs_hi=1e-5, ncs_hi=4e-4))),
])
def test_catalog_variant_builders_equal(factory, kwargs):
    assert getattr(tcatalog, factory)(**kwargs) == \
        getattr(jcatalog, factory)(**kwargs)


def test_catalog_has_every_name_of_the_reference():
    """Every top-level name of the reference catalog exists in the port's,
    and ``LOCK_SWEEPS`` names the same sweeps, each the port's own
    builder giving the reference's configs."""
    import dataclasses

    own = lambda m: {n for n in vars(m) if not n.startswith("__")}
    assert own(jcatalog) <= own(tcatalog)
    assert list(tcatalog.LOCK_SWEEPS) == list(jcatalog.LOCK_SWEEPS)
    for name, build in tcatalog.LOCK_SWEEPS.items():
        assert build.__module__ == tcatalog.__name__, name
        kw = {} if name == "fig3" else dict(n_scenarios=1)
        assert [dataclasses.asdict(c) for c in build(**kw)] == \
            [dataclasses.asdict(c)
             for c in jcatalog.LOCK_SWEEPS[name](**kw)], name

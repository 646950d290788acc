"""The open-loop slice of the port on ``device="cpu"``: the open stages of
the plain PyTorch versions and ``simulate_batch`` with open-arrival
configs, against ``repro.kernels.ref`` / ``repro.core.xdes`` and against
the port's own invariants.

Tolerance (ROADMAP.md "C"): against the reference run op by op
(``jax.disable_jit()``) every discrete field — the latency histogram, the
queue head / length, the request counters, ``qbuf`` and ``req_t`` — is
exact, and the float accumulators ``lat_sum`` / ``occ_int`` (and ``rem``,
``wake_at``, ``spin_cpu``) are held to ``rtol=1e-6``; against the jitted
reference, a 2 % band on seed-averaged cell means.  Rows use constant and
bursty workloads only, whose arithmetic has no transcendental besides the
latency bin's ``log2`` (equal between the two libraries, C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import policy as JP
from repro.core import xdes as jxdes
from repro.kernels import ref as jref
from repro_torch.core import policy as TP
from repro_torch.core import xdes as txdes
from repro_torch.core.policy import SimConfig
from repro_torch.kernels import lock_sim as tk
from repro_torch.kernels import ref as tref

SHORT = (0.0, 3.7e-6)
LONG = (0.0, 40e-6)
WAKE = 8e-6
OPEN_ROWS = [a for a in TP.ARRIVAL_ROWS if TP.ARRIVAL_IDS[a] != TP.AR_CLOSED]
CLOSED_FIELDS = ("completed", "completed_per_thread", "wake_count",
                 "final_sws", "t_end", "steps_run")
OPEN_EXACT = ("lat_hist", "arrived", "shed", "departed", "slo_viol",
              "in_flight")
OPEN_FLOAT = ("lat_sum", "occ_int", "spin_cpu")
ALL_NAMES = tref.BLOCK_STATE + tref.OPEN_STATE
FLOAT_RTOL = {"rem", "wake_at", "spin_cpu", "lat_sum", "occ_int"}


def _open_kwargs(seed=17, locks=("mutable", "ttas", "sleep", "fifo",
                                 "hapax", "fissile", "adaptive",
                                 "ttas_backoff"), closed_rows=2,
                 threads_hi=9):
    """Open rows over both arrival rows and a spread of disciplines (tie
    break, queue cap, SLO, load drawn per row), plus closed rows mixed
    in; keyword dicts so both packages can build them."""
    rng = np.random.default_rng(seed)
    out = []
    for arrival in OPEN_ROWS:
        for i, lock in enumerate(locks):
            out.append(dict(
                lock=lock, threads=int(rng.integers(2, threads_hi)),
                cores=int(rng.integers(2, 9)),
                cs=SHORT if i % 3 else LONG, ncs=SHORT, wake_latency=WAKE,
                seed=int(rng.integers(0, 1000)), arrival=arrival,
                arrival_rate=float(rng.uniform(5e4, 1.5e6)),
                queue_cap=int(rng.choice([2, 5, 16, 128])),
                slo=float(rng.uniform(2e-6, 4e-5)), wl_period=8e-5,
                wl_duty=float(rng.uniform(0.1, 0.9)),
                workload=("constant", "bursty")[i % 2],
                tie_break=("id", "random")[(i // 2) % 2]))
    for j in range(closed_rows):
        out.append(dict(lock=locks[j], threads=5, cores=4, cs=SHORT,
                        ncs=SHORT, wake_latency=WAKE, seed=100 + j))
    return out


def _cfgs(kws):
    return [SimConfig(**kw) for kw in kws]


def _assert_open_equal(a, b, msg="", float_exact=True):
    for f in CLOSED_FIELDS + OPEN_EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{msg}: {f}")
    for f in OPEN_FLOAT:
        g, w = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if float_exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {f}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"{msg}: {f}")


def check_open_invariants(res, i, cfg, rtol=1e-3, atol=1e-6):
    """Request conservation, the queue bound, histogram totals and the
    sharp Little's-law inequality ``0 <= occ_int - lat_sum <= in_flight *
    t_end`` (up to float32 accumulation)."""
    arrived, shed = int(res.arrived[i]), int(res.shed[i])
    departed, fly = int(res.departed[i]), int(res.in_flight[i])
    assert arrived - shed - departed - fly == 0, (i, cfg.lock)
    assert 0 <= fly <= cfg.queue_cap + cfg.threads, (i, cfg.lock)
    assert 0 <= shed <= arrived
    assert int(res.slo_viol[i]) <= departed
    assert int(res.lat_hist[i].sum()) == departed, (i, cfg.lock)
    occ, lat = float(res.occ_int[i]), float(res.lat_sum[i])
    slack = rtol * max(occ, lat) + atol
    assert occ - lat >= -slack, (i, cfg.lock, occ, lat)
    assert occ - lat <= fly * float(res.t_end[i]) + slack, (i, cfg.lock)


# --------------------------------------------------------------------------
# the open stages of the plain versions against the reference functions
# --------------------------------------------------------------------------
def _open_block(seed, C=24, T=8):
    """A random closed state + context (every policy id, both arrival rows
    and the closed row) and a random open state consistent with it:
    ``req_t`` set on busy slots, a ring of earlier arrival times."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 6, (C, T)).astype(np.int32)
    ticket = rng.integers(0, 50, (C, T)).astype(np.int32)
    ticket[rng.random((C, T)) < 0.5] = tref.NO_TICKET
    dt = rng.uniform(1e-7, 1e-6, C).astype(np.float32)
    now = (np.float32(40) * dt)
    state = [
        st,
        rng.uniform(-3e-6, 1e-5, (C, T)).astype(np.float32),     # rem
        rng.uniform(0, 1e-5, (C, T)).astype(np.float32),         # wake_at
        rng.integers(0, 2, (C, T)).astype(np.int32),             # slept
        rng.integers(0, 2, (C, T)).astype(np.int32),             # spun
        rng.integers(0, 2**32, (C, T)).astype(np.uint32),        # ctr
        ticket,
        rng.integers(0, 30, (C, T)).astype(np.int32),            # cpt
        rng.integers(1, 9, C).astype(np.int32),                  # sws
        rng.integers(0, 12, C).astype(np.int32),                 # cnt
        rng.integers(0, 257, C).astype(np.int32),                # ewma
        rng.integers(-3, 4, C).astype(np.int32),                 # wuc
        rng.integers(0, 3, C).astype(np.int32),                  # permits
        np.full(C, 60, np.int32),                                # nticket
        rng.integers(0, 100, C).astype(np.int32),                # completed
        rng.integers(0, 100, C).astype(np.int32),                # wake_count
        rng.uniform(0, 1e-3, C).astype(np.float32),              # spin_cpu
    ]
    policy = rng.integers(0, len(TP.POLICY_IDS), C).astype(np.int32)
    q_cap = rng.integers(1, TP.QUEUE_MAX + 1, C).astype(np.int32)
    qlen = (rng.random(C) * q_cap).astype(np.int32)
    req_t = np.where(st != TP.DONE,
                     rng.uniform(0, 1, (C, T)) * now[:, None],
                     -1.0).astype(np.float32)
    ostate = [
        req_t,
        (rng.uniform(0, 1, (C, TP.QUEUE_MAX)) * now[:, None]
         ).astype(np.float32),                                   # qbuf
        rng.integers(0, 5, (C, TP.LAT_NBINS)).astype(np.int32),  # hist
        rng.integers(0, TP.QUEUE_MAX, C).astype(np.int32),       # qhead
        qlen,
        rng.integers(100, 200, C).astype(np.int32),              # arrived
        rng.integers(0, 50, C).astype(np.int32),                 # shed
        rng.integers(0, 50, C).astype(np.int32),                 # departed
        rng.integers(0, 20, C).astype(np.int32),                 # slo_viol
        rng.uniform(0, 1e-4, C).astype(np.float32),              # lat_sum
        rng.uniform(0, 1e-4, C).astype(np.float32),              # occ_int
    ]
    alpha = rng.uniform(0.0, 0.2, C).astype(np.float32)
    cores = rng.integers(1, 12, C).astype(np.float32)
    has_budget = np.isin(policy, [TP.ADAPTIVE, TP.FISSILE])
    ctx = (
        policy,
        rng.integers(1, T + 1, C).astype(np.int32),              # threads
        dt, np.full(C, WAKE, np.float32),                        # dt, wake
        np.zeros(C, np.float32),                                 # cs_lo
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),           # cs_hi
        np.zeros(C, np.float32),                                 # ncs_lo
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),           # ncs_hi
        rng.integers(1, 31, C).astype(np.int32),                 # k
        rng.integers(12, 20, C).astype(np.int32),                # sws_max
        np.full(C, 2e-6, np.float32),                            # spin_budget
        rng.integers(0, 2**32, C).astype(np.uint32),             # seed
        rng.integers(0, 4, C).astype(np.int32),                  # oracle
        rng.integers(0, 2, C).astype(np.int32),                  # workload
        rng.uniform(1e-6, 2e-5, C).astype(np.float32),           # wl_period
        rng.uniform(0.1, 0.9, C).astype(np.float32),             # wl_duty
        rng.uniform(1.0, 16.0, C).astype(np.float32),            # wl_burst
        rng.uniform(1.0, 8.0, C).astype(np.float32),             # wl_spread
        (np.arange(C) % 3).astype(np.int32),                     # arrival
        rng.uniform(1e5, 2e7, C).astype(np.float32),             # arr_rate
        q_cap,
        rng.uniform(1e-7, 2e-6, C).astype(np.float32),           # slo
        rng.integers(0, 2, C).astype(np.int32),                  # tb
        rng.integers(0, 5, C).astype(np.int32),                  # fault
        rng.uniform(0.0, 0.5, C).astype(np.float32),             # flt_rate
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),           # flt_scale
        rng.uniform(0.25, 16.0, C).astype(np.float32),           # park_cost
    )
    return state, ostate, alpha, cores, has_budget, ctx


def _to_torch(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _assert_all_equal(got, want, names, msg=""):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "ctr":
            g = g.view(np.uint32)
        if name in FLOAT_RTOL:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=f"{msg}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {name}")


@pytest.mark.parametrize("stepi_kind", ["scalar", "column"])
def test_open_transitions_ref_matches_jax(stepi_kind):
    C = 24
    state, ostate, _, _, _, ctx = _open_block(1, C)
    dt = ctx[2]
    step_np = (np.int32(39) if stepi_kind == "scalar"
               else (30 + np.arange(C) % 17).astype(np.int32))
    step_t = 39 if stepi_kind == "scalar" else _to_torch(step_np)
    now2 = (step_np.astype(np.float32) + np.float32(1.0)) * dt
    want = jref.lock_transitions_ref(
        *map(jnp.asarray, state[:16]), jnp.asarray(now2),
        jnp.asarray(step_np), *map(jnp.asarray, ctx),
        open_state=list(map(jnp.asarray, ostate)))
    got = tref.lock_transitions_ref(
        *map(_to_torch, state[:16]), _to_torch(now2), step_t,
        *map(_to_torch, ctx), open_state=list(map(_to_torch, ostate)))
    names = tref.TRANSITION_THREAD_STATE + tref.TRANSITION_CONFIG_STATE \
        + tref.OPEN_STATE
    for t, name in zip(got, names):
        assert t.dtype in (torch.int32, torch.float32), name
    _assert_all_equal(got, want, names, stepi_kind)
    # every open stage did something somewhere in the block
    jo = [np.asarray(w) for w in want[16:]]
    assert (jo[5] > ostate[5]).any() and (jo[6] > ostate[6]).any()  # admit
    assert (jo[7] > ostate[7]).any()                             # depart
    assert (jo[4] < ostate[4] + jo[5] - ostate[5]).any()         # bind
    closed = ctx[18] == TP.AR_CLOSED                             # inert rows
    for i in (2, 3, 4, 5, 6, 7, 8):
        np.testing.assert_array_equal(jo[i][closed], ostate[i][closed])


@pytest.mark.parametrize("n_sub", [1, 8])
def test_open_block_ref_matches_jax(n_sub):
    """``lock_sim_block_ref`` with the open carry and a (C,) ``limit``
    that freezes rows mid-block, the 2-d ring / histogram included."""
    C = 16
    state, ostate, alpha, cores, has_budget, ctx = _open_block(2, C)
    step0 = 39
    limit = (step0 + np.arange(C) % (n_sub + 2)).astype(np.int32)
    with jax.disable_jit():
        want = jref.lock_sim_block_ref(
            *map(jnp.asarray, state), jnp.int32(step0),
            *map(jnp.asarray, (alpha, cores, has_budget)),
            *map(jnp.asarray, ctx), n_sub_steps=n_sub,
            limit=jnp.asarray(limit),
            open_state=tuple(map(jnp.asarray, ostate)))
    got = tref.lock_sim_block_ref(
        *map(_to_torch, state), step0,
        *map(_to_torch, (alpha, cores, has_budget)), *map(_to_torch, ctx),
        n_sub_steps=n_sub, limit=_to_torch(limit),
        open_state=tuple(map(_to_torch, ostate)))
    _assert_all_equal(got, want, ALL_NAMES, f"B={n_sub}")
    frozen = limit == step0                 # rows with no live sub-step
    for g, o in zip(got[17:], ostate):
        np.testing.assert_array_equal(g.numpy()[frozen], o[frozen])


def test_wrapper_open_on_cpu_is_the_plain_version():
    state, ostate, alpha, cores, has_budget, ctx = _open_block(3, 8)
    args = (*map(_to_torch, (alpha, cores, has_budget)),
            *map(_to_torch, ctx))
    before = (tk.lock_sim_block.launches, tk.lock_sim_block.open_launches)
    got = tk.lock_sim_block(*map(_to_torch, state), 7, *args, n_sub_steps=5,
                            limit=10, open_state=list(map(_to_torch, ostate)))
    want = tref.lock_sim_block_ref(
        *map(_to_torch, state), 7, *args, n_sub_steps=5, limit=10,
        open_state=list(map(_to_torch, ostate)))
    assert len(got) == 28
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tk.lock_sim_block.launches,
            tk.lock_sim_block.open_launches) == before


# --------------------------------------------------------------------------
# simulate_batch, open loop, against the reference engine
# --------------------------------------------------------------------------
def test_simulate_batch_open_exact_against_unjitted_reference():
    """Both open arrival rows x 6 disciplines + closed rows, T <= 8, 40
    steps: every discrete field and the histograms exact, the float
    accumulators rtol=1e-6."""
    kws = _open_kwargs(locks=("mutable", "ttas", "sleep", "fifo", "hapax",
                              "fissile"))
    with jax.disable_jit():
        want = jxdes.simulate_batch([JP.SimConfig(**kw) for kw in kws],
                                    n_steps=40, backend="ref", shard=False)
    got = txdes.simulate_batch(_cfgs(kws), n_steps=40, device="cpu")
    _assert_open_equal(got, want, "port vs un-jitted reference",
                       float_exact=False)
    np.testing.assert_array_equal(got.dt, want.dt)
    assert got.departed.sum() > 0 and got.arrived.sum() > got.departed.sum()
    # the host readouts agree too
    for q in ("p50", "p95", "p99", "slo_frac", "mean_latency"):
        np.testing.assert_allclose(getattr(got, q), getattr(want, q),
                                   rtol=1e-6, equal_nan=True, err_msg=q)


def test_simulate_batch_open_band_against_jitted_reference():
    """Poisson and bursty cells at moderate load, 3 seeds each, 500 steps:
    per-cell seed means of throughput and departures within 2 % of the
    jitted reference (whose XLA program may contract an FMA and fork a
    trajectory — ROADMAP C1)."""
    cells = [(a, lock) for a in OPEN_ROWS
             for lock in ("ttas", "mutable", "sleep")]
    kws = [dict(lock=lock, threads=4, cores=4, cs=SHORT, ncs=SHORT,
                wake_latency=WAKE, seed=seed, arrival=a, arrival_rate=2e5,
                wl_period=8e-5)
           for a, lock in cells for seed in (0, 1, 2)]
    want = jxdes.simulate_batch([JP.SimConfig(**kw) for kw in kws],
                                n_steps=500, backend="ref", shard=False)
    got = txdes.simulate_batch(_cfgs(kws), n_steps=500, device="cpu")
    for f in ("throughput", "departed", "arrived"):
        w = np.asarray(getattr(want, f), np.float64).reshape(-1, 3)
        g = np.asarray(getattr(got, f), np.float64).reshape(-1, 3)
        w, g = w.mean(axis=1), g.mean(axis=1)
        assert (w > 0).all(), f
        rel = np.abs(g - w) / w
        assert rel.max() <= 0.02, (f, dict(zip(cells, rel)))


# --------------------------------------------------------------------------
# inside the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def open_scan():
    cfgs = _cfgs(_open_kwargs(seed=5))
    return cfgs, txdes.simulate_batch(cfgs, n_steps=100, rollout="scan",
                                      backend="ref", device="cpu")


@pytest.mark.parametrize("block_steps", [1, 7, 32])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_open_blocked_equals_scan(open_scan, block_steps, backend):
    cfgs, scan = open_scan
    blk = txdes.simulate_batch(cfgs, n_steps=100, block_steps=block_steps,
                               backend=backend, device="cpu")
    _assert_open_equal(blk, scan, f"B={block_steps} {backend}")
    blk.validate()
    for i, c in enumerate(cfgs):
        if c.open_loop:
            check_open_invariants(blk, i, c)


def test_mixed_batch_closed_rows_equal_closed_run():
    """Closed rows inside an open batch: the open machinery is an exact
    no-op for them — their closed outputs equal a closed-only run, their
    open counters stay zero."""
    kws = _open_kwargs(seed=7, closed_rows=4)
    cfgs = _cfgs(kws)
    closed_idx = [i for i, c in enumerate(cfgs) if not c.open_loop]
    mixed = txdes.simulate_batch(cfgs, n_steps=90, device="cpu",
                                 max_threads=8)
    alone = txdes.simulate_batch([cfgs[i] for i in closed_idx], n_steps=90,
                                 dt=mixed.dt[closed_idx], device="cpu",
                                 max_threads=8)
    assert alone.lat_hist is None
    for f in CLOSED_FIELDS + ("spin_cpu",):
        np.testing.assert_array_equal(getattr(mixed, f)[closed_idx],
                                      getattr(alone, f), err_msg=f)
    for f in OPEN_EXACT:
        assert int(np.abs(getattr(mixed, f)[closed_idx]).sum()) == 0, f
    assert mixed.departed.sum() > 0


def test_forced_open_loop_on_closed_batch_equals_closed():
    cfgs = [SimConfig(lock, threads=5, cores=4, cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=s)
            for s, lock in enumerate(("ttas", "mutable", "sleep", "fifo"))]
    closed = txdes.simulate_batch(cfgs, n_steps=120, device="cpu")
    forced = txdes.simulate_batch(cfgs, n_steps=120, open_loop=True,
                                  device="cpu")
    off = txdes.simulate_batch(cfgs, n_steps=120, open_loop=False,
                               device="cpu")
    assert closed.lat_hist is None and off.lat_hist is None
    assert forced.lat_hist is not None
    for f in CLOSED_FIELDS + ("spin_cpu",):
        np.testing.assert_array_equal(getattr(closed, f),
                                      getattr(forced, f), err_msg=f)
    for f in OPEN_EXACT:
        assert int(getattr(forced, f).sum()) == 0, f


def test_queue_bound_and_shedding():
    """Offered load far past saturation with a tiny queue: the bound is
    never exceeded and the overflow is shed, not lost."""
    cfgs = [SimConfig("ttas", threads=4, cores=4, cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=s, arrival="poisson",
                      arrival_rate=5e6, queue_cap=8)
            for s in range(3)]
    res = txdes.simulate_batch(cfgs, n_steps=400, dt=5e-8, device="cpu")
    for i, c in enumerate(cfgs):
        check_open_invariants(res, i, c)
        assert int(res.shed[i]) > 0, "a saturated tiny queue must shed"


def test_littles_law_exact_invariant():
    """Both arrival rows x several locks at rates from under- to
    over-saturation: conservation and the sharp Little's-law bound."""
    rng = np.random.default_rng(1)
    cfgs = [SimConfig(lock, threads=int(rng.integers(2, 8)),
                      cores=int(rng.integers(2, 8)), cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=int(rng.integers(0, 1000)),
                      arrival=arrival,
                      arrival_rate=float(rng.uniform(5e4, 8e5)),
                      queue_cap=int(rng.integers(4, 64)),
                      slo=float(rng.uniform(1e-5, 1e-3)), wl_period=8e-5)
            for arrival in OPEN_ROWS
            for lock in ("ttas", "mutable", "sleep", "fifo")]
    res = txdes.simulate_batch(cfgs, n_steps=800, dt=5e-8, device="cpu")
    assert int(res.departed.sum()) > 0
    for i, c in enumerate(cfgs):
        check_open_invariants(res, i, c)


def test_open_state_carries_across_numpy():
    cfgs = _cfgs(_open_kwargs(seed=9)[:4])
    arrs = TP.encode_configs(cfgs)
    arrs["dt"], _ = txdes.plan_schedule(cfgs, 300)
    cols = txdes.columns_from_numpy(arrs, "cpu")
    state = txdes._init_state(cols, 8, open_loop=True)
    assert len(state) == 28
    back = txdes.state_from_numpy(txdes.state_to_numpy(state), "cpu")
    for a, b in zip(state, back):
        assert torch.equal(a, b)
    # open configs start empty, closed rows circulate
    st = state[0].numpy()
    for i, c in enumerate(cfgs):
        live = st[i, :c.threads]
        assert (live == (TP.DONE if c.open_loop else TP.NCS)).all()
    assert (state[17].numpy() == -1.0).all()


# --------------------------------------------------------------------------
# the latency readout
# --------------------------------------------------------------------------
def test_latency_percentiles_match_reference():
    np.testing.assert_array_equal(TP.latency_bin_edges(),
                                  JP.latency_bin_edges())
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 6, (40, TP.LAT_NBINS)).astype(np.int32)
    hist[rng.random((40, TP.LAT_NBINS)) < 0.7] = 0
    hist[:3] = 0                                  # nothing departed
    hist[3, 17] = 5                               # one occupied bin
    qs = (0.0, 0.1, 0.5, 0.95, 0.99, 1.0)
    got = TP.latency_percentiles(hist, qs)
    want = JP.latency_percentiles(hist, qs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[2][:3]).all() and np.isfinite(got[2][3:]).all()

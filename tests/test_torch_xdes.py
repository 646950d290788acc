"""The first slice of the port as a whole, on ``device="cpu"``:
``repro_torch.core.xdes.simulate_batch`` against itself (blocked == scan,
early exit, buckets, padding) and against ``repro.core.xdes``.

Cross-framework tolerance (ROADMAP.md "C"): against the reference run
under ``jax.disable_jit()`` every discrete field is exact and ``spin_cpu``
within ``rtol=1e-6`` (C <= 32, T <= 8, <= 48 steps, rows without
transcendentals); against the jitted reference, whose XLA program may
contract FMAs and fork a trajectory, a seed-averaged throughput band.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import policy as JP
from repro.core import xdes as jxdes
from repro_torch.configs import catalog as tcatalog
from repro_torch.core import policy as TP
from repro_torch.core import xdes as txdes
from repro_torch.core.policy import SimConfig
from repro_torch.kernels import ref as tref

SHORT = (0.0, 3.7e-6)
LONG = (0.0, 80e-6)
WAKE = 8e-6
DISCRETE = ("completed", "completed_per_thread", "wake_count", "final_sws",
            "t_end", "steps_run")


def _mixed_kwargs(seed=0, workloads=("constant", "bursty"), threads_hi=9):
    """Every policy id, oracle families, workload and fault rows mixed on
    a deterministic draw; keyword dicts so both packages can build them."""
    rng = np.random.default_rng(seed)
    locks, oracles = sorted(TP.POLICY_IDS), sorted(TP.ORACLE_IDS)
    faults = list(TP.FAULT_ROWS)
    out = []
    for i in range(3 * len(locks)):
        flt = faults[i % len(faults)]
        out.append(dict(
            lock=locks[i % len(locks)],
            threads=int(rng.integers(2, threads_hi)),
            cores=int(rng.integers(2, 9)),
            cs=SHORT if i % 2 else LONG, ncs=SHORT, wake_latency=WAKE,
            seed=int(rng.integers(0, 1000)), oracle=oracles[i % 4],
            workload=workloads[i % len(workloads)],
            tie_break=("id", "random")[(i // 2) % 2],
            fault=flt, fault_rate=0.0 if flt == "none" else 0.25,
            park_cost=(0.25, 1.0, 16.0)[i % 3]))
    return out


def _mixed(**kw):
    return [SimConfig(**d) for d in _mixed_kwargs(**kw)]


def _assert_equal(a, b, msg="", spin_exact=True):
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{msg}: {f}")
    if spin_exact:
        np.testing.assert_array_equal(a.spin_cpu, b.spin_cpu, err_msg=msg)
    else:
        np.testing.assert_allclose(a.spin_cpu, b.spin_cpu, rtol=1e-6,
                                   err_msg=msg)


# --------------------------------------------------------------------------
# inside the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scan_run():
    cfgs = _mixed(workloads=tuple(TP.WORKLOAD_ROWS))
    return cfgs, txdes.simulate_batch(cfgs, n_steps=130, rollout="scan",
                                      backend="ref", device="cpu")


@pytest.mark.parametrize("block_steps", [1, 7, 32])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_blocked_equals_scan(scan_run, block_steps, backend):
    """blocked == scan bit for bit, through the wrapper (which takes the
    plain version for CPU tensors) and through backend="ref"."""
    cfgs, scan = scan_run
    blk = txdes.simulate_batch(cfgs, n_steps=130, block_steps=block_steps,
                               backend=backend, device="cpu")
    _assert_equal(scan, blk, f"B={block_steps} {backend}")
    assert (blk.steps_run == 130).all()     # pinned horizon: no early exit
    blk.validate()
    per = blk.completed_per_thread.astype(np.int64)
    for i, c in enumerate(cfgs):            # conservation, padded lanes idle
        assert per[i, c.threads:].sum() == 0
        assert per[i].sum() == int(blk.completed[i])
    assert (blk.completed > 0).mean() > 0.8


def test_early_exit_equals_scan_prefix():
    # the two always-park rows need ~3x the planned horizon at this size,
    # so they would pin the batch to its full length: leave them out here
    cfgs = [SimConfig(lock, threads=4, cores=8, cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=i)
            for i, lock in enumerate(sorted(TP.POLICY_IDS))
            if lock not in ("sleep", "hapax")]
    res = txdes.simulate_batch(cfgs, target_cs=12, device="cpu")
    assert (res.completed >= 12).all()
    executed = int(res.steps_run[0])
    assert (res.steps_run == executed).all()
    assert executed < res.n_steps and executed % 32 == 0
    prefix = txdes.simulate_batch(cfgs, n_steps=executed, rollout="scan",
                                  backend="ref", dt=res.dt, device="cpu")
    _assert_equal(res, prefix, "early exit vs scan prefix")
    # a pinned horizon runs exactly it unless early exit is asked for
    pinned = txdes.simulate_batch(cfgs, n_steps=executed + 40, target_cs=12,
                                  device="cpu")
    assert (pinned.steps_run == executed + 40).all()
    asked = txdes.simulate_batch(cfgs, n_steps=executed + 40, target_cs=12,
                                 early_exit=True, device="cpu")
    assert (asked.steps_run == executed).all()


def test_bucketed_equals_per_bucket():
    cfgs = [SimConfig(lock, threads=3, cores=4, cs=cs, ncs=SHORT,
                      wake_latency=WAKE, seed=i)
            for i, (lock, cs) in enumerate(
                [("ttas", SHORT), ("mutable", SHORT), ("sleep", (0, 9e-6)),
                 ("fifo", (0, 9e-6)), ("hapax", (0, 2e-5))])]
    dt, steps = txdes.plan_schedule(cfgs, 4)
    buckets = txdes.plan_buckets(steps)
    assert len(buckets) > 1
    res = txdes.simulate_batch(cfgs, target_cs=4, bucket_steps=True,
                               keep_per_thread=False, device="cpu")
    assert res.completed_per_thread is None and res.fairness is not None
    for idx in buckets:
        part = txdes.simulate_batch(
            [cfgs[i] for i in idx], target_cs=4, dt=dt[idx],
            n_steps=int(steps[idx].max()), early_exit=True, device="cpu")
        for f in ("completed", "wake_count", "final_sws", "t_end",
                  "steps_run", "spin_cpu"):
            np.testing.assert_array_equal(getattr(res, f)[idx],
                                          getattr(part, f), err_msg=f)
        for j, i in enumerate(idx):
            assert res.fairness_spread(i) == part.fairness_spread(j)


def test_pad_configs_invariance():
    cfgs = _mixed(seed=5)[:7]
    a = txdes.simulate_batch(cfgs, n_steps=70, device="cpu")
    b = txdes.simulate_batch(cfgs, n_steps=70, pad_configs=16, device="cpu",
                             max_threads=12)
    for f in ("completed", "wake_count", "final_sws", "spin_cpu", "t_end"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    T = a.completed_per_thread.shape[1]
    np.testing.assert_array_equal(a.completed_per_thread,
                                  b.completed_per_thread[:, :T])
    assert b.completed_per_thread.shape == (7, 12)


def test_unported_paths_raise():
    """Open-arrival configs and ``rollout="scan"`` on the kernel backend
    run now (on CPU tensors the scan's wrappers take the plain versions,
    so it equals ``backend="ref"`` bit for bit); ``shard=True`` runs the
    config-axis split and equals ``shard=False`` bit for bit."""
    closed = SimConfig("mutable", 4, 4, SHORT, SHORT)
    opened = SimConfig("mutable", 4, 4, SHORT, SHORT, arrival="poisson",
                       arrival_rate=1e5)
    mixed = txdes.simulate_batch([closed, opened], n_steps=8, device="cpu")
    assert mixed.lat_hist.shape == (2, TP.LAT_NBINS)
    forced = txdes.simulate_batch([closed], n_steps=8, open_loop=True,
                                  device="cpu")
    assert forced.arrived.tolist() == [0]
    assert txdes.simulate_batch([closed], n_steps=8,
                                device="cpu").lat_hist is None
    split, whole = (txdes.simulate_batch([closed, opened], n_steps=8,
                                         shard=shard, device="cpu")
                    for shard in (True, False))
    for f in ("completed", "completed_per_thread", "wake_count",
              "final_sws", "spin_cpu", "t_end", "steps_run", "lat_hist",
              "departed"):
        np.testing.assert_array_equal(getattr(split, f), getattr(whole, f),
                                      err_msg=f)
    scans = [txdes.simulate_batch([closed, opened], n_steps=40,
                                  rollout="scan", backend=backend,
                                  device="cpu")
             for backend in ("kernel", "ref")]
    for f in ("completed", "completed_per_thread", "wake_count",
              "final_sws", "spin_cpu", "t_end", "steps_run", "lat_hist",
              "arrived", "departed", "lat_sum", "occ_int"):
        np.testing.assert_array_equal(getattr(scans[0], f),
                                      getattr(scans[1], f), err_msg=f)
    assert scans[0].completed.sum() > 0
    with pytest.raises(ValueError, match="backend"):
        txdes.simulate_batch([closed], n_steps=8, backend="pallas",
                             device="cpu")
    with pytest.raises(ValueError, match="MAX_STEPS"):
        txdes.simulate_batch([closed], n_steps=txdes.MAX_STEPS + 1,
                             device="cpu")


def test_step_cap_warning_names_worst_cell():
    cfgs = [SimConfig("ttas", 2, 2, SHORT, SHORT),
            SimConfig("sleep", 2, 2, (0, 4e-4), (0, 4e-4), wake_latency=1e-7)]
    _, steps = txdes.plan_schedule(cfgs, 300)
    assert steps.max() > txdes.MAX_STEPS
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        txdes._warn_undersampled(cfgs, steps, txdes.MAX_STEPS, 300)
    assert "config 1" in str(w[0].message) and "sleep" in str(w[0].message)


# --------------------------------------------------------------------------
# carrying state across: one mid-trajectory state, both engines
# --------------------------------------------------------------------------
def test_init_state_and_midrun_handover_match_reference():
    kws = _mixed_kwargs(seed=2)[:16]
    jcfgs = [JP.SimConfig(**kw) for kw in kws]
    arrs = JP.encode_configs(jcfgs)
    arrs["dt"], _ = jxdes.plan_schedule(jcfgs, 300)
    T = int(arrs["threads"].max())
    cols = txdes.columns_from_numpy(arrs, "cpu")
    assert cols["seed"].dtype == torch.int32          # bit pattern of uint32
    np.testing.assert_array_equal(
        cols["seed"].numpy().view(np.uint32), arrs["seed"])

    # the initial carry
    jstate = [np.asarray(a) for a in jxdes._init_state(arrs, T)]
    tstate = txdes.state_to_numpy(txdes._init_state(cols, T))
    for name, t, j in zip(tref.BLOCK_STATE, tstate, jstate):
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)

    # 16 reference steps, then both engines continue from THAT state
    from repro.kernels.ref import lock_sim_block_ref as jblock
    from repro_torch.kernels.ref import lock_sim_block_ref as tblock
    import jax.numpy as jnp

    has_budget = JP.discipline_flags(arrs["policy"])[2] > 0
    jargs = [jnp.asarray(v) for v in
             (arrs["alpha"], arrs["cores"], has_budget,
              *(arrs[f] for f in jxdes._PRM_FIELDS))]
    with jax.disable_jit():
        mid = jblock(*map(jnp.asarray, jstate), jnp.int32(0), *jargs,
                     n_sub_steps=16)
        want = jblock(*mid, jnp.int32(16), *jargs, n_sub_steps=24)
    mid_np = [np.asarray(a) for a in mid]
    targs = (cols["alpha"], cols["cores"],
             TP.discipline_flags(cols["policy"])[2] > 0,
             *(cols[f] for f in txdes._PRM_FIELDS))
    got = tblock(*txdes.state_from_numpy(mid_np, "cpu"), 16, *targs,
                 n_sub_steps=24)
    assert int(np.asarray(want[14]).sum()) > int(mid_np[14].sum())
    for name, g, w in zip(tref.BLOCK_STATE, txdes.state_to_numpy(got),
                          want):
        if name in ("rem", "wake_at", "spin_cpu"):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    with pytest.raises(ValueError, match="17"):
        txdes.state_from_numpy(mid_np[:16], "cpu")


# --------------------------------------------------------------------------
# port vs reference, end to end
# --------------------------------------------------------------------------
def test_simulate_batch_exact_against_unjitted_reference():
    """Fig.-3-shaped cells plus the registry mix at C <= 32, T <= 8, 48
    steps: every discrete field exact, spin_cpu rtol=1e-6."""
    kws = _mixed_kwargs(seed=4)[:24] + [
        dict(lock=lock, threads=tc, cores=4, cs=SHORT, ncs=SHORT,
             wake_latency=WAKE, seed=s)
        for lock in tcatalog.LOCK_DISCIPLINES[:4]
        for tc, s in ((2, 0), (8, 1))]
    with jax.disable_jit():
        want = jxdes.simulate_batch([JP.SimConfig(**kw) for kw in kws],
                                    n_steps=48, backend="ref", shard=False)
    got = txdes.simulate_batch([SimConfig(**kw) for kw in kws], n_steps=48,
                               backend="ref", device="cpu")
    _assert_equal(got, want, "port vs un-jitted reference", spin_exact=False)
    np.testing.assert_array_equal(got.dt, want.dt)
    assert got.completed.sum() > 0


def test_throughput_band_against_jitted_reference():
    """Fig. 3 short/short cells, 3 seeds each, 480 steps: throughput per
    (lock, threads) cell averaged over seeds within 2% of the jitted
    reference.  Measured basis: on this grid the jitted reference and the
    port agree in every discrete field (relative difference 0.0 in all 10
    cells, jax 0.9.0 CPU vs torch 2.13 CPU); the band leaves room for an
    XLA build that contracts an FMA and forks a few trajectories, which
    moves a 3-seed cell mean by well under a percent."""
    locks = tcatalog.LOCK_DISCIPLINES
    cells = [(lock, tc) for lock in locks for tc in (4, 20)]
    kws = [dict(lock=lock, threads=tc, cores=tcatalog.LOCK_CORES,
                cs=tcatalog.LOCK_SHORT, ncs=tcatalog.LOCK_SHORT,
                wake_latency=tcatalog.LOCK_WAKE, seed=seed)
           for lock, tc in cells for seed in (0, 1, 2)]
    want = jxdes.simulate_batch([JP.SimConfig(**kw) for kw in kws],
                                n_steps=480, backend="ref", shard=False)
    got = txdes.simulate_batch([SimConfig(**kw) for kw in kws], n_steps=480,
                               device="cpu")
    tw = want.throughput.reshape(len(cells), 3).mean(axis=1)
    tg = got.throughput.reshape(len(cells), 3).mean(axis=1)
    assert (tw > 0).all()
    rel = np.abs(tg - tw) / tw
    assert rel.max() <= 0.02, dict(zip(cells, rel))

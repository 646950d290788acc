"""The port's plain PyTorch kernels against the JAX reference functions.

The same numpy-seeded ``(C, T)`` inputs go through each function of
``repro.kernels.ref`` and its counterpart in ``repro_torch.kernels.ref``.

Tolerance (the parity contract of ROADMAP.md "C"): the JAX side runs op by
op (eager calls, ``jax.disable_jit()`` around anything that holds a
``fori_loop``), because a jitted XLA program contracts ``a*b+c`` into an
FMA and is not a bit-exact target.  Against that, every integer field is
compared **exactly** and every float field with ``rtol=1e-6``, for up to
64 steps, on rows whose arithmetic has no transcendental (constant and
bursty workloads, every fault row).  Hetero and jitter rows go through
``pow`` / ``log1p``, which differ by an ulp between the two libraries, so
they are compared after ONE step, before an ulp can fork a branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import policy as JP
from repro.kernels import ref as jref
from repro_torch.core import policy as TP
from repro_torch.core import xdes as txdes
from repro_torch.kernels import lock_sim as tk
from repro_torch.kernels import ref as tref

STATE_NAMES = tref.BLOCK_STATE
FLOAT_FIELDS = {"rem", "wake_at", "spin_cpu"}
WAKE = 8e-6


def _random_block(seed, C, T, workloads=(0, 1), faults=(0, 1, 2, 3, 4)):
    """A random mid-trajectory state + context, every policy / oracle /
    tie-break id drawn, workload and fault ids from the given sets.
    Returns ``(state17, alpha, cores, has_budget, ctx27)`` as numpy, in
    the argument order of ``lock_sim_block_ref`` after ``step0``."""
    rng = np.random.default_rng(seed)
    ticket = rng.integers(0, 50, (C, T)).astype(np.int32)
    ticket[rng.random((C, T)) < 0.5] = tref.NO_TICKET
    policy = rng.integers(0, len(TP.POLICY_IDS), C).astype(np.int32)
    state = [
        rng.integers(0, 6, (C, T)).astype(np.int32),            # st
        rng.uniform(-1e-7, 1e-5, (C, T)).astype(np.float32),    # rem
        rng.uniform(0, 1e-5, (C, T)).astype(np.float32),        # wake_at
        rng.integers(0, 2, (C, T)).astype(np.int32),            # slept
        rng.integers(0, 2, (C, T)).astype(np.int32),            # spun
        rng.integers(0, 2**32, (C, T)).astype(np.uint32),       # ctr
        ticket,
        rng.integers(0, 30, (C, T)).astype(np.int32),           # cpt
        rng.integers(1, 9, C).astype(np.int32),                 # sws
        rng.integers(0, 12, C).astype(np.int32),                # cnt
        rng.integers(0, 257, C).astype(np.int32),               # ewma
        rng.integers(-3, 4, C).astype(np.int32),                # wuc
        rng.integers(0, 3, C).astype(np.int32),                 # permits
        np.full(C, 60, np.int32),                               # nticket
        rng.integers(0, 100, C).astype(np.int32),               # completed
        rng.integers(0, 100, C).astype(np.int32),               # wake_count
        rng.uniform(0, 1e-3, C).astype(np.float32),             # spin_cpu
    ]
    alpha = rng.uniform(0.0, 0.2, C).astype(np.float32)
    cores = rng.integers(1, 12, C).astype(np.float32)
    has_budget = np.isin(policy, [TP.ADAPTIVE, TP.FISSILE])
    ctx = (
        policy,
        rng.integers(1, T + 1, C).astype(np.int32),             # threads
        rng.uniform(1e-7, 1e-6, C).astype(np.float32),          # dt
        np.full(C, WAKE, np.float32),                           # wake
        np.zeros(C, np.float32),                                # cs_lo
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),          # cs_hi
        np.zeros(C, np.float32),                                # ncs_lo
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),          # ncs_hi
        rng.integers(1, 31, C).astype(np.int32),                # k
        rng.integers(12, 20, C).astype(np.int32),               # sws_max
        np.full(C, 2e-6, np.float32),                           # spin_budget
        rng.integers(0, 2**32, C).astype(np.uint32),            # seed
        rng.integers(0, 4, C).astype(np.int32),                 # oracle
        rng.choice(workloads, C).astype(np.int32),              # workload
        rng.uniform(1e-5, 1e-4, C).astype(np.float32),          # wl_period
        rng.uniform(0.1, 0.9, C).astype(np.float32),            # wl_duty
        rng.uniform(1.0, 16.0, C).astype(np.float32),           # wl_burst
        rng.uniform(1.0, 8.0, C).astype(np.float32),            # wl_spread
        np.zeros(C, np.int32),                                  # arrival
        np.zeros(C, np.float32),                                # arr_rate
        np.full(C, 128, np.int32),                              # q_cap
        np.full(C, 1e-3, np.float32),                           # slo
        rng.integers(0, 2, C).astype(np.int32),                 # tb
        rng.choice(faults, C).astype(np.int32),                 # fault
        rng.uniform(0.0, 0.5, C).astype(np.float32),            # flt_rate
        rng.uniform(1e-6, 1e-5, C).astype(np.float32),          # flt_scale
        rng.uniform(0.25, 16.0, C).astype(np.float32),          # park_cost
    )
    return state, alpha, cores, has_budget, ctx


def _to_torch(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _assert_state_equal(got_torch, want_jax, names=STATE_NAMES, msg=""):
    """ints exact, floats rtol=1e-6 (inf == inf)."""
    got = txdes.state_to_numpy(got_torch) if len(got_torch) == 17 else \
        [t.numpy() for t in got_torch]
    for name, g, w in zip(names, got, want_jax):
        w = np.asarray(w)
        if name == "ctr":
            g = g.view(np.uint32)
        if name in FLOAT_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=f"{msg}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {name}")


# --------------------------------------------------------------------------
# counter_uniform: bit-exact
# --------------------------------------------------------------------------
def test_counter_uniform_bit_exact():
    rng = np.random.default_rng(0)
    n = 4096
    seed = rng.integers(0, 2**32, n).astype(np.uint32)
    tid = rng.integers(0, 128, n).astype(np.int32)
    ctr = rng.integers(0, 2**32, n).astype(np.uint32)
    ctr[:4] = (0, 1, 2**32 - 1, 2**31)                 # wrap-around edges
    want = np.asarray(jref.counter_uniform(jnp.asarray(seed),
                                           jnp.asarray(tid),
                                           jnp.asarray(ctr)))
    got = tref.counter_uniform(_to_torch(seed), _to_torch(tid),
                               _to_torch(ctr)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got >= 0).all() and (got <= 1).all()
    # salted streams: seed ^ SALT sets the high bit, shifts stay logical
    for salt in (JP.FLT_GATE_SALT, JP.TB_SALT, JP.BO_SALT, JP.WL_PHASE_SALT):
        want = np.asarray(jref.counter_uniform(
            jnp.asarray(seed) ^ jnp.uint32(salt), jnp.asarray(tid),
            jnp.uint32(7)))
        got = tref.counter_uniform(tref.xor_salt(_to_torch(seed), salt),
                                   _to_torch(tid), 7).numpy()
        np.testing.assert_array_equal(got, want, err_msg=hex(salt))


def test_counter_uniform_matches_scalar_mirror():
    for seed, tid, ctr in ((0, 0, 0), (123456789, 7, 3), (2**32 - 1, 127, 9)):
        got = tref.counter_uniform(torch.tensor([seed - 2**32 if seed >= 2**31
                                                 else seed], dtype=torch.int32),
                                   torch.tensor([tid], dtype=torch.int32), ctr)
        assert float(got[0]) == np.float32(
            TP.counter_uniform_scalar(seed, tid, ctr))


# --------------------------------------------------------------------------
# lock_sim_step_ref / fault_rewind
# --------------------------------------------------------------------------
def test_lock_sim_step_ref_matches_jax():
    state, alpha, cores, has_budget, ctx = _random_block(1, 32, 8)
    st, rem, dt = state[0], state[1], ctx[2]
    want_rem, want_burn = jref.lock_sim_step_ref(
        jnp.asarray(st), jnp.asarray(rem), jnp.asarray(alpha),
        jnp.asarray(cores), jnp.asarray(dt), jnp.asarray(has_budget))
    got_rem, got_burn = tref.lock_sim_step_ref(
        *map(_to_torch, (st, rem, alpha, cores, dt, has_budget)))
    # un-jitted JAX and torch agree bit for bit on rem; the port's burn is
    # the closed form n_spin * d_rate of the reference's order-dependent
    # lane sum (ROADMAP C2)
    np.testing.assert_array_equal(got_rem.numpy(), np.asarray(want_rem))
    np.testing.assert_allclose(got_burn.numpy(), np.asarray(want_burn),
                               rtol=1e-6)


@pytest.mark.parametrize("now_kind", ["scalar", "column"])
def test_fault_rewind_matches_jax(now_kind):
    state, alpha, cores, _, ctx = _random_block(2, 32, 8)
    st, rem, dt, seed = state[0], state[1], ctx[2], ctx[11]
    fault, flt_rate, flt_scale = ctx[23], ctx[24], ctx[25]
    if now_kind == "scalar":
        now_j, now_t = jnp.float32(3e-5), torch.tensor(3e-5)
    else:
        now = (np.arange(32) * 7 % 40).astype(np.float32) * dt
        now_j, now_t = jnp.asarray(now), _to_torch(now)
    want = jref.fault_rewind(*map(jnp.asarray, (st, rem, alpha, cores, dt)),
                             now_j, *map(jnp.asarray, (seed, fault, flt_rate,
                                                       flt_scale)))
    got = tref.fault_rewind(*map(_to_torch, (st, rem, alpha, cores, dt)),
                            now_t, *map(_to_torch, (seed, fault, flt_rate,
                                                    flt_scale)))
    assert (np.asarray(want) != rem).any()       # the faults did bite
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# lock_transitions_ref
# --------------------------------------------------------------------------
@pytest.mark.parametrize("workloads,label", [((0, 1), "exact-rows"),
                                             ((2, 3), "libm-rows")])
@pytest.mark.parametrize("stepi_kind", ["scalar", "column"])
def test_lock_transitions_ref_matches_jax(workloads, label, stepi_kind):
    C, T = 32, 8
    state, alpha, cores, has_budget, ctx = _random_block(
        3, C, T, workloads=workloads)
    dt = ctx[2]
    if stepi_kind == "scalar":
        step_np = np.int32(11)
        step_t = 11
    else:
        step_np = (np.arange(C) % 17).astype(np.int32)
        step_t = _to_torch(step_np)
    now2 = ((step_np.astype(np.float32) + np.float32(1.0)) * dt)
    want = jref.lock_transitions_ref(
        *map(jnp.asarray, state[:16]), jnp.asarray(now2),
        jnp.asarray(step_np), *map(jnp.asarray, ctx))
    got = tref.lock_transitions_ref(
        *map(_to_torch, state[:16]), _to_torch(now2), step_t,
        *map(_to_torch, ctx))
    for t, name in zip(got, STATE_NAMES):
        want_dtype = torch.float32 if name in FLOAT_FIELDS else torch.int32
        assert t.dtype == want_dtype, name           # no int64 leaks
    _assert_state_equal(got, want, STATE_NAMES[:16], label)
    assert any((np.asarray(w) != s).any() for w, s in zip(want, state))


def test_lock_transitions_ref_rejects_open_state():
    state, *_, ctx = _random_block(3, 4, 4)
    now2 = ctx[2]
    with pytest.raises(NotImplementedError, match="open-loop"):
        tref.lock_transitions_ref(*map(_to_torch, state[:16]),
                                  _to_torch(now2), 0, *map(_to_torch, ctx),
                                  open_state=())


# --------------------------------------------------------------------------
# lock_sim_block_ref
# --------------------------------------------------------------------------
def _block_both(state, alpha, cores, has_budget, ctx, step0, n_sub, limit,
                block_fn=None):
    j = lambda v: v if np.isscalar(v) or v is None else jnp.asarray(v)
    t = lambda v: (int(v) if np.isscalar(v) else None if v is None
                   else _to_torch(v))
    with jax.disable_jit():
        want = jref.lock_sim_block_ref(
            *map(jnp.asarray, state),
            jnp.int32(step0) if np.isscalar(step0) else jnp.asarray(step0),
            *map(jnp.asarray, (alpha, cores, has_budget)),
            *map(jnp.asarray, ctx), n_sub_steps=n_sub,
            limit=None if limit is None else
            (jnp.int32(limit) if np.isscalar(limit) else jnp.asarray(limit)))
    fn = block_fn or tref.lock_sim_block_ref
    got = fn(*map(_to_torch, state), t(step0),
             *map(_to_torch, (alpha, cores, has_budget)),
             *map(_to_torch, ctx), n_sub_steps=n_sub, limit=t(limit))
    return got, want


@pytest.mark.parametrize("n_sub", [1, 7, 32])
@pytest.mark.parametrize("limit_kind", ["none", "scalar", "column"])
def test_lock_sim_block_ref_matches_jax(n_sub, limit_kind):
    C, T = 16, 8
    block = _random_block(4 + n_sub, C, T)
    step0 = 11
    limit = {"none": None, "scalar": step0 + max(1, n_sub - 2),
             "column": (step0 + np.arange(C) % (n_sub + 2)).astype(np.int32)
             }[limit_kind]
    got, want = _block_both(*block, step0, n_sub, limit)
    _assert_state_equal(got, want, msg=f"B={n_sub} limit={limit_kind}")


def test_lock_sim_block_ref_64_steps_column_step0():
    """Two chained 32-step blocks from a (C,) ``step0``: 64 steps with
    every discrete field exact."""
    C, T = 12, 8
    state, alpha, cores, has_budget, ctx = _random_block(9, C, T)
    step0 = (np.arange(C) * 3).astype(np.int32)
    got, want = _block_both(state, alpha, cores, has_budget, ctx, step0, 32,
                            None)
    _assert_state_equal(got, want, msg="block 1")
    state2 = [np.asarray(w) for w in want]
    got2, want2 = _block_both(state2, alpha, cores, has_budget, ctx,
                              step0 + 32, 32, None)
    _assert_state_equal(got2, want2, msg="block 2")
    assert (np.asarray(want2[14]) > state[14]).any()     # CSes completed


def test_lock_sim_block_ref_libm_rows_one_step():
    """Hetero / jitter rows: one step, ints exact, floats rtol=1e-6."""
    block = _random_block(21, 32, 8, workloads=(2, 3))
    got, want = _block_both(*block, 5, 1, None)
    _assert_state_equal(got, want, msg="hetero/jitter, 1 step")


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """The kernel wrapper given CPU tensors takes the plain version (and
    counts no launch); it must equal the JAX reference just the same."""
    block = _random_block(30, 8, 8)
    before = tk.lock_sim_block.launches
    got, want = _block_both(*block, 3, 7, 8, block_fn=tk.lock_sim_block)
    _assert_state_equal(got, want, msg="wrapper/cpu")
    assert tk.lock_sim_block.launches == before


def test_pallas_interpret_block_kernel_matches_port():
    """``repro.kernels.lock_sim.lock_sim_block`` in interpret mode (the
    TPU kernel as the JAX package's own tests run it on the CPU) against
    the port's plain version, from one shared mid-trajectory state.  The
    Pallas call is jitted, so XLA may contract an FMA (ROADMAP C1): the
    comparison is held to 8 sub-steps, ints exact and floats rtol=1e-6."""
    from repro.kernels.lock_sim import lock_sim_block as pallas_block

    C, T = 16, 8
    state, alpha, cores, has_budget, ctx = _random_block(40, C, T)
    want = pallas_block(*map(jnp.asarray, state), jnp.int32(2),
                        *map(jnp.asarray, (alpha, cores, has_budget)),
                        *map(jnp.asarray, ctx), n_sub_steps=8,
                        interpret=True, limit=jnp.int32(9))
    got = tref.lock_sim_block_ref(
        *txdes.state_from_numpy(state, "cpu"), 2,
        *map(_to_torch, (alpha, cores, has_budget)), *map(_to_torch, ctx),
        n_sub_steps=8, limit=9)
    _assert_state_equal(got, want, msg="pallas-interpret vs port")


# --------------------------------------------------------------------------
# oracle_update_ref
# --------------------------------------------------------------------------
def test_oracle_update_ref_matches_jax():
    rng = np.random.default_rng(5)
    n = 2048
    args = (rng.integers(0, 4, n), rng.integers(0, 2, n),
            rng.integers(0, 2, n), rng.integers(1, 33, n),
            rng.integers(0, 40, n), rng.integers(0, 257, n),
            rng.integers(1, 31, n), rng.integers(33, 64, n))
    args = [a.astype(np.int32) for a in args]
    want = jref.oracle_update_ref(*map(jnp.asarray, args))
    got = tref.oracle_update_ref(*map(_to_torch, args))
    for g, w, name in zip(got, want, ("delta", "cnt", "ewma")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    sws2 = args[3] + got[0].numpy()
    assert (sws2 >= 1).all() and (sws2 <= args[7]).all()

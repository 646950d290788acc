"""The per-step kernels' wrappers on CPU tensors against the JAX package's
Pallas kernels, and what the wrappers refuse before a launch.

``repro.kernels.lock_sim``'s ``lock_sim_step``, ``lock_transitions_step``
(closed and with ``open_state``) and ``oracle_step`` run in Pallas
interpret mode, as the JAX package's own tests run them on the CPU; the
port's wrappers of the same names get the same numpy-seeded inputs as CPU
tensors, which they hand to their plain versions.  The Pallas calls are
jitted, so XLA may contract an FMA (ROADMAP.md C1): integers are compared
exactly and floats at ``rtol=1e-6``.  The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.kernels import lock_sim as jls
from repro_torch.core import policy as TP
from repro_torch.kernels import lock_sim as tk
from repro_torch.kernels import ref as tref
from test_torch_open_loop import _open_block
from test_torch_ref import _random_block, _to_torch

THREAD_NAMES = tref.TRANSITION_THREAD_STATE
NAMES = THREAD_NAMES + tref.TRANSITION_CONFIG_STATE
FLOATS = {"rem", "wake_at", "req_t", "qbuf", "lat_sum", "occ_int"}


def _counts():
    return (tk.lock_sim_step.launches, tk.lock_transitions_step.launches,
            tk.lock_transitions_step.open_launches, tk.oracle_step.launches,
            tk.lock_sim_block.launches, tk.lock_sim_block.open_launches)


def _assert_close(got, want, names, msg=""):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "ctr":
            g = g.view(np.uint32)
        if name in FLOATS:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=f"{msg}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {name}")


# --------------------------------------------------------------------------
# lock_sim_step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T", [8, 40])
def test_lock_sim_step_matches_pallas(T):
    state, alpha, cores, has_budget, ctx = _random_block(50 + T, 32, T)
    st, rem, dt = state[0], state[1], ctx[2]
    want_rem, want_burn = jls.lock_sim_step(
        *map(jnp.asarray, (st, rem, alpha, cores, dt, has_budget)),
        interpret=True)
    before = _counts()
    got_rem, got_burn = tk.lock_sim_step(
        *map(_to_torch, (st, rem, alpha, cores, dt, has_budget)))
    assert _counts() == before                # the CPU path counts nothing
    assert (got_rem.dtype, got_burn.dtype) == (torch.float32,) * 2
    np.testing.assert_allclose(got_rem.numpy(), np.asarray(want_rem),
                               rtol=1e-6, atol=0)
    # the port's burn is the closed form n_spin * d_rate (ROADMAP C5)
    np.testing.assert_allclose(got_burn.numpy(), np.asarray(want_burn),
                               rtol=1e-6)
    assert (np.asarray(want_burn) > 0).any()
    assert (got_rem.numpy() != rem).any()


# --------------------------------------------------------------------------
# lock_transitions_step
# --------------------------------------------------------------------------
def _step_forms(kind, C, dt):
    """(stepi for JAX, stepi for the port, now2 for JAX, now2 for the
    port) in the argument forms the wrappers take."""
    if kind == "column":
        step = (np.arange(C) % 17).astype(np.int32)
        now2 = (step.astype(np.float32) + np.float32(1.0)) * dt
        return step, _to_torch(step), now2, _to_torch(now2)
    step = np.int32(11)
    now2 = (np.float32(12.0) * dt).astype(np.float32)
    if kind == "scalar":      # a Python int and a (C,) now2
        return step, 11, now2, _to_torch(now2)
    # 0-d tensors for both; now2 one value for every row
    return (step, torch.tensor(11, dtype=torch.int32), now2[0],
            torch.tensor(now2[0]))


@pytest.mark.parametrize("kind", ["scalar", "column", "zero_dim"])
@pytest.mark.parametrize("workloads", [(0, 1), (2, 3)])
def test_lock_transitions_step_matches_pallas(kind, workloads):
    C, T = 16, 8
    state, _, _, _, ctx = _random_block(60 + len(kind), C, T,
                                        workloads=workloads)
    jstep, tstep, jnow, tnow = _step_forms(kind, C, ctx[2])
    want = jls.lock_transitions_step(
        *map(jnp.asarray, state[:16]), jnp.asarray(jnow),
        jnp.asarray(jstep), *map(jnp.asarray, ctx), interpret=True)
    before = _counts()
    got = tk.lock_transitions_step(*map(_to_torch, state[:16]), tnow, tstep,
                                   *map(_to_torch, ctx))
    assert _counts() == before
    _assert_close(got, want, NAMES, kind)
    assert any((np.asarray(w) != s).any() for w, s in zip(want, state))


@pytest.mark.parametrize("kind", ["scalar", "column"])
def test_open_lock_transitions_step_matches_pallas(kind):
    C = 16
    state, ostate, _, _, _, ctx = _open_block(70, C)
    jstep, tstep, jnow, tnow = _step_forms(kind, C, ctx[2])
    want = jls.lock_transitions_step(
        *map(jnp.asarray, state[:16]), jnp.asarray(jnow),
        jnp.asarray(jstep), *map(jnp.asarray, ctx),
        open_state=tuple(map(jnp.asarray, ostate)), interpret=True)
    before = _counts()
    got = tk.lock_transitions_step(*map(_to_torch, state[:16]), tnow, tstep,
                                   *map(_to_torch, ctx),
                                   open_state=tuple(map(_to_torch, ostate)))
    assert _counts() == before
    _assert_close(got, want, NAMES + tref.OPEN_STATE, f"open {kind}")
    jo = [np.asarray(w) for w in want[16:]]
    assert (jo[5] > ostate[5]).any() and (jo[7] > ostate[7]).any()


def test_transitions_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper returns exactly what the plain version
    does, for every argument form of ``now2``."""
    C, T = 12, 8
    state, _, _, _, ctx = _random_block(80, C, T)
    args = list(map(_to_torch, state[:16]))
    cols = list(map(_to_torch, ctx))
    now2 = (np.float32(5.0) * ctx[2]).astype(np.float32)
    want = tref.lock_transitions_ref(*args, _to_torch(now2), 4, *cols)
    for now in (_to_torch(now2), torch.tensor(now2[3]), float(now2[3])):
        got = tk.lock_transitions_step(*args, now, 4, *cols)
        if isinstance(now, torch.Tensor) and now.ndim == 1:
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        assert len(got) == 16
        assert [g.dtype for g in got] == [w.dtype for w in want]


# --------------------------------------------------------------------------
# oracle_step
# --------------------------------------------------------------------------
def _oracle_inputs(seed, n=4096):
    """The simulator's domain plus negative sws, cnt and k + 1, where
    floor division and C's truncating division differ."""
    rng = np.random.default_rng(seed)
    sws_max = rng.integers(1, 64, n)
    sws = rng.integers(1, sws_max + 1)
    odd = rng.integers(0, 6, n)
    sws = np.where(odd == 0, rng.integers(-64, 0, n), sws)
    cnt = np.where(odd == 1, rng.integers(-40, 0, n), rng.integers(0, 40, n))
    k = np.where(odd == 2, rng.integers(-40, -1, n), rng.integers(1, 31, n))
    cols = (rng.integers(0, len(TP.ORACLE_IDS), n), rng.integers(0, 2, n),
            rng.integers(0, 2, n), sws, cnt, rng.integers(0, 257, n), k,
            sws_max)
    return [c.astype(np.int32) for c in cols]


@pytest.mark.parametrize("flags", ["int32", "bool"])
def test_oracle_step_matches_pallas(flags):
    args = _oracle_inputs(3)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(_to_torch, args))
    if flags == "bool":
        jargs[1:3] = [a.astype(bool) for a in jargs[1:3]]
        targs[1:3] = [t.bool() for t in targs[1:3]]
    want = jls.oracle_step(*jargs, interpret=True)
    before = _counts()
    got = tk.oracle_step(*targs)
    assert _counts() == before
    for g, w, name in zip(got, want, ("delta", "cnt", "ewma")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    # the negative rows exercise floor division (sws // 2 on AIMD rows,
    # EWMA_ONE // (k + 1) on history rows)
    aimd = (args[0] == TP.ORACLE_IDS["aimd"]) & (args[3] < 0) & (args[3] % 2
                                                                 == 1)
    assert aimd.any()
    assert ((args[0] == TP.ORACLE_IDS["history"]) & (args[6] < -1)).any()


# --------------------------------------------------------------------------
# what the wrappers refuse before a launch (meta tensors: a CUDA-like
# device type without a runtime)
# --------------------------------------------------------------------------
meta = lambda t: _to_torch(t).to("meta")


def _meta_transitions(C, T, open_loop=False):
    if open_loop:
        state, ostate, _, _, _, ctx = _open_block(90, C, T)
        ostate = tuple(map(meta, ostate))
    else:
        state, _, _, _, ctx = _random_block(90, C, T)
        ostate = None
    now2 = meta(ctx[2])
    return list(map(meta, state[:16])), now2, list(map(meta, ctx)), ostate


def test_wrappers_refuse_other_devices():
    state, alpha, cores, has_budget, ctx = _random_block(91, 8, 8)
    before = _counts()
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.lock_sim_step(*map(meta, (state[0], state[1], alpha, cores,
                                     ctx[2], has_budget)))
    st, now2, cols, _ = _meta_transitions(8, 8)
    for stepi in (3, torch.tensor(3, dtype=torch.int32).to("meta"),
                  meta(np.arange(8, dtype=np.int32))):
        with pytest.raises(ValueError, match="cuda or cpu"):
            tk.lock_transitions_step(*st, now2, stepi, *cols)
    st, now2, cols, ostate = _meta_transitions(8, 8, open_loop=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.lock_transitions_step(*st, now2, 3, *cols, open_state=ostate)
    args = list(map(meta, _oracle_inputs(4, 16)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.oracle_step(*args)
    args[1] = args[1].bool()           # bool flags pass the checks too
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.oracle_step(*args)
    assert _counts() == before


def test_wrappers_refuse_more_than_max_threads():
    T = tk.MAX_THREADS + 1
    state, alpha, cores, has_budget, ctx = _random_block(92, 4, T)
    with pytest.raises(ValueError, match="MAX_THREADS"):
        tk.lock_sim_step(*map(meta, (state[0], state[1], alpha, cores,
                                     ctx[2], has_budget)))
    st, now2, cols, _ = _meta_transitions(4, T)
    with pytest.raises(ValueError, match="MAX_THREADS"):
        tk.lock_transitions_step(*st, now2, 3, *cols)


def test_wrappers_refuse_malformed_operands():
    st, now2, cols, ostate = _meta_transitions(8, 8, open_loop=True)
    with pytest.raises(ValueError, match="11 OPEN_STATE"):
        tk.lock_transitions_step(*st, now2, 3, *cols, open_state=ostate[:10])
    bad_qbuf = (ostate[0], ostate[1][:, :64]) + ostate[2:]
    with pytest.raises(ValueError, match="qbuf"):
        tk.lock_transitions_step(*st, now2, 3, *cols, open_state=bad_qbuf)
    with pytest.raises(ValueError, match="now2"):
        tk.lock_transitions_step(*st, now2[:5], 3, *cols)
    with pytest.raises(TypeError, match="stepi"):
        tk.lock_transitions_step(*st, now2, now2, *cols)
    args = list(map(meta, _oracle_inputs(5, 16)))
    args[3] = args[3].to(torch.int64)
    with pytest.raises(TypeError, match="sws"):
        tk.oracle_step(*args)
    with pytest.raises(ValueError, match="oracle_id"):
        tk.oracle_step(args[0][:, None], *args[1:])


@pytest.mark.parametrize("column,bad", [("oracle", 4), ("oracle", -1),
                                        ("policy", 10), ("policy", -1)])
def test_out_of_registry_ids_are_refused(column, bad):
    """The id checks the wrappers run on CUDA tensors before a launch
    (``check_oracle_ids`` for ``oracle_step``, ``check_id_columns`` for the
    transition and block kernels)."""
    col = lambda *v: torch.tensor(v, dtype=torch.int32)
    ok = dict(policy=col(0, 9), oracle=col(0, 3), workload=col(0, 3),
              fault=col(0, 4), tb=col(0, 1), arrival=col(0, 0))
    tk.check_id_columns(**ok)
    tk.check_oracle_ids(ok["oracle"])
    with pytest.raises(ValueError, match=column):
        tk.check_id_columns(**{**ok, column: col(0, bad)})
    if column == "oracle":
        with pytest.raises(ValueError, match="oracle ids span"):
            tk.check_oracle_ids(col(0, bad, 2))

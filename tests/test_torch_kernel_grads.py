"""The backwards of the port's LM kernels (K5 flash attention, K6 the RWKV6
scan, K7 the mamba scan, K8 RMSNorm) on the CPU, against ``jax.vjp`` of
the JAX package's functions: ``repro.kernels.ref.flash_attention_ref`` /
``rmsnorm_ref``, ``repro.models.rwkv6._wkv_chunk_scan`` and
``repro.models.mamba._ssm_chunk_scan`` (what the reference differentiates
when it trains).  Inputs and output gradients are drawn from a seed with
numpy; every input gradient lies within 3e-5 * max(1, max|JAX's|) (f32).

Then the wiring: each wrapper's output carries its autograd function's
``grad_fn`` when an input requires grad, on the CPU and, with the launch
stubbed on meta tensors (no CUDA here), on the path a card tensor takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import rwkv6_scan as RW

torch.set_num_threads(1)
TOL = 3e-5


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max|d| {err} over {lim}"


def _leaves(arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 80), (1, 2048)])
def test_rmsnorm_backward_matches_jax_vjp(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w), x, w)
    dx, dw = vjp(jnp.asarray(g))
    tx, tw = _leaves((x, w))
    y = RN.rmsnorm(tx, tw)
    _close(y, want, "y")
    gx, gw = torch.autograd.grad(y, (tx, tw), torch.tensor(g))
    _close(gx, dx, "dx")
    _close(gw, dw, "dw")


def test_rmsnorm_backward_keeps_the_dtypes():
    x = torch.randn(4, 16, dtype=torch.bfloat16, requires_grad=True)
    w = torch.zeros(16, dtype=torch.bfloat16, requires_grad=True)
    gx, gw = torch.autograd.grad(RN.rmsnorm(x, w).float().sum(), (x, w))
    assert gx.dtype == gw.dtype == torch.bfloat16


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------
FLASH_CASES = [
    # BH, BKV, Sq, Sk, hd, causal, window, softcap, backward tile
    (4, 4, 16, 16, 16, True, 0, 0.0, 512),
    (8, 2, 33, 33, 16, True, 0, 0.0, 512),   # GQA
    (8, 2, 33, 33, 16, True, 0, 0.0, 7),     # ... over tiles, a ragged one
    (8, 2, 24, 24, 32, True, 5, 0.0, 512),   # window
    (8, 2, 24, 24, 32, True, 5, 0.0, 7),
    (4, 1, 20, 20, 16, True, 0, 30.0, 512),  # softcap, MQA
    (4, 2, 12, 12, 16, True, 4, 2.0, 5),     # window + a tight softcap
    (4, 2, 9, 14, 16, False, 0, 0.0, 512),   # not causal, Sq != Sk
    (4, 2, 9, 14, 16, False, 3, 5.0, 4),
    (4, 2, 20, 12, 16, True, 3, 0.0, 512),   # rows past Sk masked whole
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_backward_matches_jax_vjp(case, monkeypatch):
    BH, BKV, Sq, Sk, hd, causal, window, softcap, tile = case
    monkeypatch.setattr(FA, "BWD_TILE", tile)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((BH, Sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((BKV, Sk, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((BH, Sq, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, **kw), q, k, v)
    dq, dk, dv = vjp(jnp.asarray(g))
    tq, tk, tv = _leaves((q, k, v))
    out = FA.FlashAttention.apply(tq, tk, tv, causal, window, softcap)
    _close(out, want, "o")
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for name, a, b in zip("qkv", got, (dq, dk, dv)):
        _close(a, b, f"d{name}")


def test_flash_attention_backward_tiles_agree():
    """The tile size changes no gradient beyond rounding."""
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((8, 40, 16)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((2, 40, 16)),
                         dtype=torch.float32) for _ in range(2))
    o = FA.flash_attention(q, k, v, window=9)
    do = torch.tensor(rng.standard_normal(o.shape), dtype=torch.float32)
    whole = FA.flash_attention_backward(q, k, v, o, do, window=9)
    for tile in (1, 8, 13):
        for a, b in zip(FA.flash_attention_backward(q, k, v, o, do, window=9,
                                                    tile=tile), whole):
            lim = 1e-6 * max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) <= lim


# --------------------------------------------------------------------------
# K6 (model layout through ops.wkv)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 40, 130])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_scan_backward_matches_jax_vjp(T, with_s0):
    B, H, n = 2, 2, 16
    D = H * n
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, T, D)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-7, -1, (B, T, D)))).astype(np.float32)
    u = rng.standard_normal(D).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((B, H, n, n))).astype(np.float32)
    gy = rng.standard_normal((B, T, D)).astype(np.float32)
    gS = rng.standard_normal((B, H, n, n)).astype(np.float32)
    args = (r, k, v, w, u) + ((s0,) if with_s0 else ())

    def jfn(r, k, v, w, u, s0=None):
        return jrwkv6._wkv_chunk_scan(r, k, v, w, u, n, state0=s0,
                                      return_state=True)

    (wy, wS), vjp = jax.vjp(jfn, *args)
    want = vjp((jnp.asarray(gy), jnp.asarray(gS)))
    leaves = _leaves(args)
    y, S = ops.wkv(*leaves[:5], n, s0=leaves[5] if with_s0 else None)
    assert type(y.grad_fn).__name__ != "NoneType"
    _close(y, wy, "y")
    _close(S, wS, "S_T")
    got = torch.autograd.grad((y, S), leaves, (torch.tensor(gy),
                                               torch.tensor(gS)))
    for name, a, b in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        _close(a, b, f"d{name}")


def test_rwkv6_scan_backward_without_a_state_gradient():
    """Only y feeds the loss: S_T's gradient is None, not a zero tensor."""
    rng = np.random.default_rng(4)
    r, k, v = _leaves([rng.standard_normal((3, 9, 16)).astype(np.float32)
                       for _ in range(3)])
    w = torch.full((3, 9, 16), 0.9, requires_grad=True)
    u = torch.zeros((3, 16), requires_grad=True)
    y, _ = RW.rwkv6_scan(r, k, v, w, u)
    got = torch.autograd.grad(y.sum(), (r, w))
    y2, _ = RW.wkv_chunk_scan(r, k, v, w, u, chunk=4)
    want = torch.autograd.grad(y2.sum(), (r, w))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-6)


# --------------------------------------------------------------------------
# K7
# --------------------------------------------------------------------------
def _ssm_inputs(B, T, d, N, seed):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(1e-3, 0.2, (B, T, d)).astype(np.float32)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (d, N)).astype(np.float32)
    return dt, x, Bm, Cm, a


@pytest.mark.parametrize("T", [1, 40, 130])
def test_mamba_scan_backward_matches_jax_vjp(T):
    dt, x, Bm, Cm, a = _ssm_inputs(2, T, 12, 4, 5)
    gy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    wy, vjp = jax.vjp(lambda dt, B, C, x, a: jmamba._ssm_chunk_scan(
        dt, B, C, x, a, 64), dt, Bm, Cm, x, a)
    ddt, dB, dC, dx, da = vjp(jnp.asarray(gy))
    leaves = _leaves((dt, x, Bm, Cm, a))
    y, _ = ops.selective_scan(*leaves)
    _close(y, wy, "y")
    got = torch.autograd.grad(y, leaves, torch.tensor(gy))
    for name, g, w in zip(("dt", "x", "Bm", "Cm", "a"), got,
                          (ddt, dx, dB, dC, da)):
        _close(g, w, f"d{name}")


def test_mamba_scan_final_state_gradient_matches_jax_vjp():
    """s_T's gradient: column n of s_T is the reference scan's last y with
    C_T = e_n, so ``_ssm_chunk_scan`` gives it under jax.vjp too."""
    dt, x, Bm, Cm, a = _ssm_inputs(2, 70, 8, 4, 7)
    N = a.shape[1]
    gS = np.random.default_rng(8).standard_normal((2, 8, N)).astype(
        np.float32)

    def s_T(dt, B, x, a):
        cols = []
        for n in range(N):
            C = jnp.asarray(Cm).at[:, -1].set(jnp.eye(N)[n])
            cols.append(jmamba._ssm_chunk_scan(dt, B, C, x, a, 64)[:, -1])
        return jnp.stack(cols, axis=-1)

    wS, vjp = jax.vjp(s_T, dt, Bm, x, a)
    want = vjp(jnp.asarray(gS))
    leaves = _leaves((dt, x, Bm, Cm, a))
    _, S = MS.mamba_scan(*leaves)
    _close(S, wS, "s_T")
    got = torch.autograd.grad(S, leaves, torch.tensor(gS), allow_unused=True)
    for name, g, w in zip(("dt", "Bm", "x", "a"),
                          (got[0], got[2], got[1], got[4]), want):
        _close(g, w, f"d{name}")
    assert got[3] is None or not got[3].any()


# --------------------------------------------------------------------------
# Wiring: a wrapper's output has a grad_fn where an input requires grad
# --------------------------------------------------------------------------
def _calls(dev):
    z = lambda *s: torch.zeros(s, device=dev)
    return {
        "rmsnorm": (RN, lambda t: RN.rmsnorm(t(4, 16), t(16)), "RMSNorm"),
        "flash_attention": (FA, lambda t: FA.flash_attention(
            t(4, 8, 16), t(2, 8, 16), t(2, 8, 16)), "FlashAttention"),
        "rwkv6_scan": (RW, lambda t: RW.rwkv6_scan(
            t(2, 8, 16), t(2, 8, 16), t(2, 8, 16), t(2, 8, 16), t(2, 16))[0],
            "RWKV6Scan"),
        "mamba_scan": (MS, lambda t: MS.mamba_scan(
            t(1, 8, 4), t(1, 8, 4), t(1, 8, 4), t(1, 8, 4), t(4, 4))[0],
            "MambaScan"),
    }, z


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "rwkv6_scan", "mamba_scan"])
def test_outputs_carry_grad_fn_on_the_cpu(name):
    calls, z = _calls("cpu")
    _, call, fn = calls[name]
    out = call(lambda *s: z(*s).requires_grad_())
    assert type(out.grad_fn).__name__ == fn + "Backward"
    assert call(z).grad_fn is None


@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "rwkv6_scan", "mamba_scan"])
def test_outputs_carry_grad_fn_on_the_card_path(name, monkeypatch):
    """The card's route with the launch stubbed: tensors on the meta device
    pass the same dispatch as CUDA tensors (no CUDA here)."""
    calls, z = _calls("meta")
    mod, call, fn = calls[name]
    launched = []

    def fake(*args):
        launched.append(args[0].device.type)
        first = args[0]
        out = torch.empty_like(first)
        return out if name in ("rmsnorm", "flash_attention") else \
            (out, out.new_empty(()))

    monkeypatch.setattr(mod, "_forward", fake)
    out = call(lambda *s: z(*s).requires_grad_())
    assert launched == ["meta"]
    assert type(out.grad_fn).__name__ == fn + "Backward"

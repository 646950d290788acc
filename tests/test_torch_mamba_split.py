"""K7's and K8's order of operations on the CPU: emulations of the Hopper
kernels' arithmetic (``src/repro_torch/kernels/csrc/mamba_scan.cu``,
``csrc/rmsnorm.cu``) against the plain versions and the JAX package.

K7 splits a channel's N states over L lanes of a warp, K = N / L states
a lane.  A step is ``s_n = fma(s_n, 2^(dt a'_n), (dt x) B_n)`` with ``a' =
a * log2(e)`` rounded once to f32; ``y_t`` is a balanced tree over the
pairs of states, pair m being ``fma(s_{2m+1}, C_{2m+1}, s_{2m} C_{2m})``:
each lane adds its own pairs, and a reduce-scatter over a group of L steps
adds the lanes' sums (level m = 1, 2, ..., L/2: a lane keeps the half of
its sums whose step has bit m equal to its own and adds its partner's), so
that lane g ends with y of step g of the group.  :func:`emulate_mamba`
follows that order, lane by lane, with FMAs taken in float64 and rounded
once to float32 (the product of two floats is exact in float64) and
``torch.exp2`` for the card's ``ex2.approx``.  It stages ``chunk`` steps
at a time and pads a chunk's last group, as the kernel does, so that an
order that came to depend on the chunk or on L would show here.

* The emulation against ``ref.mamba_scan_ref`` within 1e-5 * max(1,
  max|plain|), the limit ``chip_smoke.py`` holds the kernel to, at N 4, 8
  and 16, T {1, 7, 130, 1024}, with dt from the mamba init's range and
  from U(1e-3, 1).
* Bit for bit across chunk {1, 16, 64, 128} and across every L from 2 to
  N / 2 (the kernel is built for L = N / 2, two states a lane, with 1, 2
  or 4 channels a lane, which enter no sum).
* Against JAX's Pallas ``mamba_scan`` in interpret mode at a small shape.

K8 holds a row's 16-byte vectors j, j + TPR, ... in thread j of the row's
TPR threads, adds each thread's squares into one partial sum per lane of
the vector (then those by a tree), the warp's by a ``__shfl_xor`` butterfly
and the row's warps' in order.  :func:`emulate_rmsnorm` follows that
order; it is held to ``ref.rmsnorm_ref`` within rtol 2e-6 in f32 and one
bf16 ulp at D 64, 80, 2048, 8192 and 16 384.

The CUDA kernels, and their launchers' choices of L and TPR, run only on
the card (``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import bf16_ulp

torch.set_num_threads(1)

#: The limit chip_smoke.py holds K7 to: max|d| of y and s_T each at most
#: this times max(1, max|plain|).
LIMIT = 1e-5
#: Lanes a channel, every power of two from 2 to N / 2: the kernel's own
#: L = N / 2 last.
LANES = {4: (2,), 8: (2, 4), 16: (2, 4, 8)}
LOG2E = np.float32(1.4426950408889634)


def _fma(a, b, c):
    """fmaf: the exact product plus c, rounded once (to double, then to
    float: the emulation's one liberty)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sums(s, C, L):
    """Each lane's subtree: (B, d, L) from the states s and C_t (B, N)."""
    Bn, d, N = s.shape
    p = _fma(s[..., 1::2], C[:, None, 1::2], s[..., 0::2] * C[:, None, 0::2])
    p = p.reshape(Bn, d, L, N // 2 // L)
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _reduce_scatter(v):
    """v: (B, d, L lanes, L steps) -> (B, d, L): lane g's sum of step g, by
    the kernel's levels (keep + the partner's send)."""
    L = v.shape[-1]
    g = torch.arange(L)
    m = 1
    while v.shape[-1] > 1:
        hi = (g & m).bool()[:, None]
        lo_v, hi_v = v[..., 0::2], v[..., 1::2]
        send = torch.where(hi, lo_v, hi_v)
        keep = torch.where(hi, hi_v, lo_v)
        v = keep + send[..., g ^ m, :]
        m *= 2
    return v[..., 0]


def emulate_mamba(dt, x, Bm, Cm, a, *, lanes, chunk=64):
    """The kernel's arithmetic on CPU tensors: (y (B, T, d), s_T (B, d, N))
    f32, ``lanes`` lanes a channel, ``chunk`` steps staged at a time."""
    Bn, T, d = x.shape
    N = a.shape[1]
    a2 = a * LOG2E
    s = torch.zeros((Bn, d, N), dtype=torch.float32)
    y = torch.empty((Bn, T, d), dtype=torch.float32)
    for t0 in range(0, T, chunk):
        cl = min(chunk, T - t0)
        for t in range(0, cl, lanes):
            v = torch.zeros((Bn, d, lanes, lanes), dtype=torch.float32)
            for j in range(min(lanes, cl - t)):
                ts = t0 + t + j
                dtt = dt[:, ts, :, None]
                dtx = dt[:, ts] * x[:, ts]
                s = _fma(s, torch.exp2(dtt * a2),
                         dtx[..., None] * Bm[:, ts, None])
                v[..., j] = _lane_sums(s, Cm[:, ts], lanes)
            out = _reduce_scatter(v)                 # (B, d, lanes)
            n = min(lanes, cl - t)
            y[:, t0 + t:t0 + t + n] = out[..., :n].transpose(1, 2)
    return y, s


def _mamba_inputs(B, T, d, N, dt_range, seed=0):
    """chip_smoke.py's operands from a numpy seed: dt the softplus of a
    projection around the mamba init's bias (log-uniform in [1e-3, 0.1],
    "model") or U(1e-3, 1) ("wide"); x, B, C normal; a = -(1..N) times
    U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, T, d))
    if dt_range == "model":
        dt0 = np.exp(np.log(1e-3) + np.log(100.0) * u)
        pre = np.log(np.expm1(dt0)) + 0.1 * rng.standard_normal((B, T, d))
        dt = np.logaddexp(0.0, pre)
    else:
        dt = 1e-3 + (1.0 - 1e-3) * u
    x = rng.standard_normal((B, T, d))
    Bm, Cm = (rng.standard_normal((B, T, N)) for _ in range(2))
    a = -np.arange(1, N + 1) * (0.5 + 1.5 * rng.uniform(size=(d, N)))
    return [v.astype(np.float32) for v in (dt, x, Bm, Cm, a)]


def _torch(arrays):
    return [torch.from_numpy(v) for v in arrays]


def _excess(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / (LIMIT * scale)


@pytest.mark.parametrize("dt_range", ["model", "wide"])
@pytest.mark.parametrize("T", [1, 7, 130, 1024])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_mamba_order_matches_the_plain_version(N, T, dt_range):
    args = _torch(_mamba_inputs(2, T, 6, N, dt_range, seed=T + N))
    y, sT = emulate_mamba(*args, lanes=max(LANES[N]))
    want_y, want_sT = ref.mamba_scan_ref(*args)
    assert y.shape == want_y.shape and sT.shape == want_sT.shape
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    assert _excess(y, want_y) <= 1.0
    assert _excess(sT, want_sT) <= 1.0


@pytest.mark.parametrize("N", [4, 8, 16])
def test_mamba_order_is_bit_equal_across_chunks_and_lanes(N):
    args = _torch(_mamba_inputs(2, 130, 5, N, "wide", seed=5))
    y0, s0 = emulate_mamba(*args, lanes=LANES[N][0], chunk=64)
    for chunk in (1, 16, 64, 128):
        for lanes in LANES[N]:
            y, sT = emulate_mamba(*args, lanes=lanes, chunk=chunk)
            assert torch.equal(y, y0) and torch.equal(sT, s0), (chunk, lanes)


@pytest.mark.parametrize("N,T", [(8, 37), (16, 9)])
def test_mamba_order_matches_jax_pallas(N, T):
    arrays = _mamba_inputs(3, T, 20, N, "wide", seed=11)
    y, _ = emulate_mamba(*_torch(arrays), lanes=max(LANES[N]), chunk=16)
    want = pallas_mamba_scan(*(jnp.asarray(v) for v in arrays), chunk=16,
                             block_d=8, interpret=True)
    assert _excess(y, torch.from_numpy(np.array(want, dtype=np.float32))) \
        <= 1.0


def emulate_rmsnorm(x, w, *, tpr, eps=1e-6):
    """K8's arithmetic on CPU tensors, ``tpr`` threads a row: x (rows, D)
    f32 or bf16, w (D,) alike; returns x's dtype."""
    rows, D = x.shape
    vec = 16 // x.element_size()
    nv = D // vec
    xf = x.float().reshape(rows, nv, vec)
    part = torch.zeros((rows, tpr, vec), dtype=torch.float32)
    for i in range(nv):                  # thread i % tpr, its vectors in order
        part[:, i % tpr] = _fma(xf[:, i], xf[:, i], part[:, i % tpr])
    while part.shape[-1] > 1:            # the vector's lanes by a tree
        part = part[..., 0::2] + part[..., 1::2]
    ss = part[..., 0].reshape(rows, tpr // 32, 32)
    for off in (16, 8, 4, 2, 1):         # the warp's butterfly
        ss = ss + ss[..., torch.arange(32) ^ off]
    total = torch.zeros((rows,), dtype=torch.float32)
    for k in range(tpr // 32):           # the row's warps, in order
        total = total + ss[:, k, 0]
    r = torch.rsqrt(total * np.float32(1.0 / D) + np.float32(eps))
    return (x.float() * r[:, None] * (1.0 + w.float())).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 80, 2048, 8192, 16384])
def test_rmsnorm_order_matches_the_plain_version(D, dtype):
    rng = np.random.default_rng(D)
    x = torch.from_numpy(3.0 * rng.standard_normal((3, D)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(0.1 * rng.standard_normal(D).astype(
        np.float32)).to(dtype)
    want = ref.rmsnorm_ref(x, w)
    for tpr in (32, 128, 256, 512):
        got = emulate_rmsnorm(x, w, tpr=tpr)
        assert got.dtype == dtype and got.shape == x.shape
        d = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float((d / want.abs().clamp_min(1e-30)).max()) <= 2e-6
        else:
            assert float((d / bf16_ulp(want)).max()) <= 1.0

"""K6's order of operations on the CPU: an emulation of the Hopper kernel's
arithmetic (``src/repro_torch/kernels/csrc/rwkv6_scan.cu``) against the
plain version and the JAX package.

The kernel splits a head's n columns over CTAs and each column's rows over
the lanes of a warp: lane (g, s) keeps rows 4 (s + G q) + e of two
columns (G = 16 segments at n = 64, 4 at n = 16).  A step's ``y_t[j]`` is each
lane's partial sum (a product, then three FMAs a quad, the quads added in
order), summed over the segments by a ``__shfl_xor`` tree (G/2, ..., 1),
plus ``bonus_t * v_t[j]`` by one FMA; the bonus ``r_t . (u * k_t)`` is
one lane's FMA chain over the quads of i starting at quad t mod n/4 (t the
global step); the state is ``S = fma(w, S, k * v)``.  :func:`emulate` follows that order
with FMAs taken in float64 and rounded once to float32 (the product of
two floats is exact in float64).  It stages ``chunk`` steps at a time and
walks one CTA's columns at a time, as the kernel does, so that an order
that came to depend on either would show here.

* The emulation against ``ref.rwkv6_scan_ref`` within 1e-5 * max(1,
  max|plain|), the limit ``chip_smoke.py`` holds the kernel to, at n 64
  and 16, T {1, 7, 130, 1024}, with and without s0, at the decay of an
  rwkv6-1.6b layer at init and at U(0.01, 1).
* Bit for bit across chunk {1, 16, 64, 128} and across 1, 2 and 4 CTAs a
  head (the kernel takes 4 or 2 at n = 64, 1 at n = 16).
* Against JAX's Pallas ``rwkv6_scan`` in interpret mode at a small shape.

The CUDA kernel itself, and its launcher's choice of split, run only on
the card (``chip_smoke.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan
from repro_torch.kernels import ref

torch.set_num_threads(1)

#: The limit chip_smoke.py holds the kernel to: max|d| of y and S_T each
#: at most this times max(1, max|plain|).
LIMIT = 1e-5
#: The kernel's lanes a column's rows are split over (``segments<N>()``),
#: one quad of rows each, and the columns a lane keeps (``CPL``).
SEGMENTS = {64: 16, 16: 4}
LANE_COLS = 2


def _fma(a, b, c):
    """fmaf: the exact product plus c, rounded once (to double, then to
    float: the emulation's one liberty)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(r, k, v, w, u, s0=None, *, chunk=64, ctas=1):
    """The kernel's arithmetic on CPU tensors: (y (BH, T, n), S_T (BH, n,
    n)) f32, staging ``chunk`` steps at a time and walking the columns of
    each of ``ctas`` CTAs apart."""
    BH, T, n = r.shape
    G = SEGMENTS[n]
    quads = n // 4 // G
    cols = n // ctas
    y = torch.empty((BH, T, n), dtype=torch.float32)
    sT = torch.empty((BH, n, n), dtype=torch.float32)
    xor = [torch.arange(G) ^ (G >> k) for k in range(1, G.bit_length())]
    for c0 in range(0, n, cols):
        S = (torch.zeros((BH, n, cols)) if s0 is None
             else s0[:, :, c0:c0 + cols].clone())
        for t0 in range(0, T, chunk):
            cl = min(chunk, T - t0)
            # the producer's bonus terms: step t0 + t by one lane, by quads
            # of i from quad (t0 + t) mod n / 4
            tt = torch.arange(cl)
            bonus = torch.zeros((BH, cl))
            for q in range(n // 4):
                quad = (q + t0 + tt) % (n // 4)
                for e in range(4):
                    i = 4 * quad + e
                    bonus = _fma(r[:, t0 + tt, i] * u[:, i],
                                 k[:, t0 + tt, i], bonus)
            for t in range(cl):
                ts = t0 + t
                vj = v[:, ts, c0:c0 + cols]                   # (BH, cols)
                rq = r[:, ts].reshape(BH, quads, G, 4, 1)
                Sq = S.reshape(BH, quads, G, 4, cols)
                a = rq[:, :, :, 0] * Sq[:, :, :, 0]
                for e in range(1, 4):
                    a = _fma(rq[:, :, :, e], Sq[:, :, :, e], a)
                p = a[:, 0]                                   # (BH, G, cols)
                for q in range(1, quads):
                    p = p + a[:, q]
                for perm in xor:
                    p = p + p[:, perm]
                y[:, ts, c0:c0 + cols] = _fma(bonus[:, t, None], vj, p[:, 0])
                S = _fma(w[:, ts, :, None], S,
                         k[:, ts, :, None] * vj[:, None, :])
        sT[:, :, c0:c0 + cols] = S
    return y, sT


def _inputs(BH, T, n, decay, with_s0, seed=0):
    """chip_smoke.py's operands from a numpy seed: r, k, v, s0 normal, u
    half-normal; the decay of an rwkv6-1.6b layer at init, exp(-exp(-6 +
    U(-1, 1))) ("model"), or U(0.01, 1) ("wide")."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, T, n)).astype(np.float32)
               for _ in range(3))
    if decay == "model":
        w = np.exp(-np.exp(-6.0 + rng.uniform(-1, 1, (BH, T, n))))
    else:
        w = rng.uniform(0.01, 1.0, (BH, T, n))
    u = (0.5 * rng.standard_normal((BH, n))).astype(np.float32)
    s0 = (rng.standard_normal((BH, n, n)).astype(np.float32) if with_s0
          else None)
    return r, k, v, w.astype(np.float32), u, s0


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _excess(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / (LIMIT * scale)


@pytest.mark.parametrize("decay", ["model", "wide"])
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("T", [1, 7, 130, 1024])
@pytest.mark.parametrize("n", [64, 16])
def test_split_order_matches_the_plain_version(n, T, with_s0, decay):
    args = _torch(_inputs(2, T, n, decay, with_s0, seed=T + n))
    y, sT = emulate(*args, chunk=64, ctas=1 if n == 16 else 4)
    want_y, want_sT = ref.rwkv6_scan_ref(*args)
    assert y.shape == want_y.shape and sT.shape == want_sT.shape
    assert _excess(y, want_y) <= 1.0
    assert _excess(sT, want_sT) <= 1.0


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("n", [64, 16])
def test_split_order_is_bit_equal_across_chunks_and_splits(n, with_s0):
    args = _torch(_inputs(2, 130, n, "wide", with_s0, seed=5))
    y0, s0 = emulate(*args, chunk=64, ctas=1)
    for chunk in (1, 16, 64, 128):
        for ctas in (1, 2, 4):
            y, sT = emulate(*args, chunk=chunk, ctas=ctas)
            assert torch.equal(y, y0) and torch.equal(sT, s0), (chunk, ctas)


@pytest.mark.parametrize("n,T", [(16, 37), (64, 9)])
def test_split_order_matches_jax_pallas(n, T):
    arrays = _inputs(3, T, n, "wide", True, seed=11)
    y, sT = emulate(*_torch(arrays), chunk=16, ctas=1 if n == 16 else 4)
    wy, wsT = pallas_rwkv6_scan(*(jnp.asarray(a) for a in arrays),
                                chunk=64, interpret=True)
    for got, want in ((y, wy), (sT, wsT)):
        want = torch.from_numpy(np.array(want, dtype=np.float32))
        assert _excess(got, want) <= 1.0

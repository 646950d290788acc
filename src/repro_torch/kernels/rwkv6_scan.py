"""RWKV6 WKV scan: the hand-written Hopper kernel K6 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``: per row
of B*H, the state S (n, n) carried across the sequence,
``y_t = r_t S + (r_t . (u * k_t)) v_t`` and ``S <- diag(w_t) S + k_t^T v_t``,
the exact diagonal recurrence in f32 (``csrc/rwkv6_scan.cu``; plain version
:func:`repro_torch.kernels.ref.rwkv6_scan_ref`).

The kernel splits a head's n columns over CTAs and each column's rows
over the lanes of a warp (a lane keeping two columns), and stages
``chunk`` steps of r, k, w and the CTA's columns of v at a time in a
two-slot ring of shared memory (copies completed on mbarriers, one
producer warp).  The launcher picks the split from the rows, the staged
steps and the card's SM count (``plan_cols`` in the source), and
``rwkv6_scan.ctas_per_head`` records the CTAs a head of the last launch
took.  Neither the split nor ``chunk`` changes a bit of the result: every
sum's order is fixed by n alone.

Layout: r, k, v, w (BH, T, n); u (BH, n); s0 (BH, n, n) or None;
:func:`repro_torch.kernels.ops.wkv` maps the model's (B, T, D) tensors to
it and back.

Training goes through :class:`RWKV6Scan`, an autograd function whose
forward is the launch and whose backward differentiates
:func:`wkv_chunk_scan`, the port of the reference model's
``_wkv_chunk_scan`` (``repro/models/rwkv6.py``), recomputed from the saved
inputs: that chunked scan, each chunk under activation checkpointing, is
what the reference differentiates when it trains.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import costanalysis

from . import lm_lib, ref
from .grad import counting_meta, meta_grads, scan_grads

#: Head dims the kernel is built for: the catalog's (64) and the tiny
#: configs' (16).
HEAD_DIMS = (16, 64)
#: Most time steps the kernel stages in shared memory at once.
MAX_CHUNK = 128
#: Steps a chunk of :func:`wkv_chunk_scan` holds (the reference's
#: ``_CHUNK``).
SCAN_CHUNK = 64


def occupancy(device=None, chunk: int = 64) -> dict:
    """Blocks and warps of each instantiation resident on one SM of
    ``device`` (default: the current CUDA device) at ``chunk``, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them at the
    launch's block size and shared memory: ``{"<n, cols>": {"blocks_per_sm",
    "warps_per_sm", "threads", "smem_bytes"}}`` (0 blocks where the shared
    memory exceeds a block's).  Builds the library if needed; launches
    nothing."""
    out = (ctypes.c_int * 64)()
    lm_lib.query("rwkv6_scan_occupancy", device, int(chunk), out)
    res = {}
    for i in range(out[0]):
        n, cols, blocks, nthreads, smem = out[1 + 5 * i: 6 + 5 * i]
        res[f"<{n}, {cols}>"] = {"blocks_per_sm": blocks,
                                 "warps_per_sm": blocks * nthreads // 32,
                                 "threads": nthreads, "smem_bytes": smem}
    return res


def check_operands(r, k, v, w, u, s0, chunk):
    """Raise unless the kernel takes the operands: f32 (``TypeError``), one
    device, r / k / v / w (BH, T, n) alike, u (BH, n), s0 (BH, n, n) or
    None, n in :data:`HEAD_DIMS`, 1 <= chunk <= :data:`MAX_CHUNK`,
    contiguous and 16-byte aligned (``ValueError``)."""
    ops = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        ops.append(("s0", s0))
    for name, t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32")
        if t.device != r.device:
            raise ValueError(f"{name}: on {t.device}, r is on {r.device}")
    if r.ndim != 3:
        raise ValueError(f"r: expected (B*heads, T, n), got "
                         f"{tuple(r.shape)}")
    BH, T, n = r.shape
    for name, t in ops[1:4]:
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (BH, n):
        raise ValueError(f"u {tuple(u.shape)}: expected {(BH, n)}")
    if s0 is not None and tuple(s0.shape) != (BH, n, n):
        raise ValueError(f"s0 {tuple(s0.shape)}: expected {(BH, n, n)}")
    if n not in HEAD_DIMS:
        raise ValueError(f"head dim n={n}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if BH == 0:
        raise ValueError("BH=0: no rows")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel stages 1 to "
                         f"{MAX_CHUNK} steps at once")
    for name, t in ops:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             f"aligned")


def meta_cost(r, k, v, w, u, s0) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: 5n^2 + 5n f32 operations a head and
    step, the inputs read and y, S_T written once."""
    BH, T, n = r.shape
    ins = (r, k, v, w, u) + (() if s0 is None else (s0,))
    n_bytes = 4 * (sum(t.numel() for t in ins) + r.numel() + BH * n * n)
    return float(BH * T * (5 * n * n + 5 * n)), n_bytes


def _forward(r, k, v, w, u, s0, chunk):
    """:func:`rwkv6_scan` outside autograd: the launch, or the plain
    version on CPU tensors, or the meta branch."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    check_operands(r, k, v, w, u, s0, chunk)
    BH, T, n = r.shape
    if r.device.type == "meta" and costanalysis.active() is not None:
        costanalysis.add_kernel("rwkv6_scan", *meta_cost(r, k, v, w, u, s0))
        return (torch.empty_like(r),
                r.new_empty((BH, n, n), dtype=torch.float32))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu tensors (meta "
                         f"ones under a cost counter), not {r.device}")
    y = torch.empty_like(r)
    sT = torch.empty((BH, n, n), dtype=torch.float32, device=r.device)
    cols = ctypes.c_int(0)
    lm_lib.launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  None if s0 is None else s0.data_ptr(), y.data_ptr(),
                  sT.data_ptr(), BH, T, n, int(chunk), ctypes.byref(cols))
    rwkv6_scan.launches += 1
    rwkv6_scan.ctas_per_head = n // cols.value
    return y, sT


def _wkv_steps(S, r, k, v, w, u):
    """The steps of one chunk from state S: (S after them, y (BH, c, n))."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(torch.einsum("bk,bkv->bv", r[:, t], S + u[..., None] * kv))
        S = w[:, t, :, None] * S + kv
    return S, torch.stack(ys, dim=1)


def wkv_chunk_scan(r, k, v, w, u, s0=None, chunk: int = SCAN_CHUNK):
    """The WKV recurrence as differentiable tensor code, in the kernel's
    layout and f32: the port of the reference model's ``_wkv_chunk_scan``,
    the steps of each ``chunk`` under activation checkpointing (the last
    chunk may be short; the reference pads it with w = 1, which leaves the
    state as it is).  Returns (y (BH, T, n), S_T (BH, n, n))."""
    BH, T, n = r.shape
    S = (torch.zeros((BH, n, n), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    ys = []
    for t0 in range(0, T, chunk):
        c = slice(t0, t0 + chunk)
        S, y = checkpoint(_wkv_steps, S, r[:, c], k[:, c], v[:, c], w[:, c],
                          u, use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else r.new_zeros((BH, 0, n))
    return y, S


class RWKV6Scan(torch.autograd.Function):
    """K6 under autograd: the forward launches the kernel (the plain
    version on CPU tensors), the backward differentiates
    :func:`wkv_chunk_scan` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, s0, chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad[:6]
        if counting_meta(saved):
            return (*meta_grads("rwkv6_scan_grad", saved, needs,
                                meta_cost(*saved)), None)
        return (*scan_grads(wkv_chunk_scan, saved, needs, (gy, gs)), None)


def rwkv6_scan(r, k, v, w, u, s0=None, *, chunk: int = 64):
    """r, k, v, w: (BH, T, n), w the decay in (0, 1); u: (BH, n); s0:
    (BH, n, n) or None.  Returns (y (BH, T, n) f32, S_T (BH, n, n) f32).

    CPU tensors go through the plain version.  Other tensors are checked
    (:func:`check_operands`) and, on CUDA, launch the kernel on the current
    stream, adding one to ``rwkv6_scan.launches`` and setting
    ``rwkv6_scan.ctas_per_head`` to the CTAs a head the launch took; there
    is no fallback.  ``chunk`` is how many steps the kernel stages at once;
    the result does not depend on it.  Meta tensors under a cost counter
    (:mod:`repro_torch.launch.costanalysis`) launch nothing: the outputs
    are empty meta tensors and the counter takes :func:`meta_cost`.  Where
    an input requires grad (and grad mode is on) the call goes through
    :class:`RWKV6Scan`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return RWKV6Scan.apply(r, k, v, w, u, s0, chunk)
    return _forward(r, k, v, w, u, s0, chunk)


rwkv6_scan.launches = 0
rwkv6_scan.ctas_per_head = None

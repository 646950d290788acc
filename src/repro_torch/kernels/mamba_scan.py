"""Mamba selective scan: the hand-written Hopper kernel K7 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/mamba_scan.py``: per
batch row and channel, the state row s (N) carried across the sequence from
zero, ``s <- exp(dt_t a) * s + (dt_t x_t) B_t`` and ``y_t = s . C_t``, in
f32 (``csrc/mamba_scan.cu``; plain version
:func:`repro_torch.kernels.ref.mamba_scan_ref`).  Beside y it returns the
final state, which the reference's wrapper does not: the prefill cache
takes it from the same pass.

On the H100 the exps bound it: one a state and step, on the special-
function units, 0.064 ms at a jamba prefill layer (B 1, T 1024, d 16 384,
N 16) beside 0.061 ms of bytes.  The kernel splits each channel's N
states over N / 2 lanes of a warp,
two states a lane, and gives a lane 1, 2 or 4 neighbouring channels (B
and C then read once for all of them); it takes each step's exp as one
``ex2`` on ``a * log2(e)``, and stages ``chunk`` steps of dt, x, B and C
at a time in a two-slot ring of shared memory filled by asynchronous
copies.  The launcher picks the channels a lane from B, d, N and the
card's SMs (``plan_split`` in the source), and
``mamba_scan.lanes_per_channel`` / ``mamba_scan.channels_per_lane``
record the split of the last launch.  Neither the split nor ``chunk``
changes a bit of the result: every sum's order is fixed by N alone.

Layout: dt, x (B, T, d); Bm, Cm (B, T, N); a (d, N) -- the model's own, so
:func:`repro_torch.kernels.ops.selective_scan` maps nothing.

Training goes through :class:`MambaScan`, an autograd function whose
forward is the launch and whose backward differentiates
:func:`ssm_chunk_scan`, the port of the reference model's
``_ssm_chunk_scan`` (``repro/models/mamba.py``), recomputed from the saved
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

#: State sizes the kernel is built for: the catalog's (16), the tiny
#: configs' (4) and the JAX kernel tests' (8).
STATE_SIZES = (4, 8, 16)
#: Most time steps the kernel stages in shared memory at once.
MAX_CHUNK = 128
#: Steps a chunk of :func:`ssm_chunk_scan` holds (the reference's
#: ``_CHUNK``).
SCAN_CHUNK = 64


def occupancy(device=None, chunk: int = 64) -> dict:
    """Blocks and warps of each instantiation resident on one SM of
    ``device`` (default: the current CUDA device) with slots of ``chunk``
    steps, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them
    at the launch's block size and shared memory: ``{"<N, lanes a
    channel, channels a lane>":
    {"blocks_per_sm", "warps_per_sm", "threads", "smem_bytes"}}`` (0 blocks
    where the shared memory exceeds a block's).  Builds the library if
    needed; launches nothing."""
    out = (ctypes.c_int * 256)()
    lm_lib.query("mamba_scan_occupancy", device, int(chunk), out)
    res = {}
    for i in range(out[0]):
        n, lanes, cpl, blocks, nthreads, smem = out[1 + 6 * i: 7 + 6 * i]
        res[f"<{n}, {lanes}, {cpl}>"] = {
            "blocks_per_sm": blocks, "warps_per_sm": blocks * nthreads // 32,
            "threads": nthreads, "smem_bytes": smem}
    return res


def check_operands(dt, x, Bm, Cm, a, chunk):
    """Raise unless the kernel takes the operands: f32 (``TypeError``), one
    device, dt / x (B, T, d) alike, Bm / Cm (B, T, N), a (d, N), N in
    :data:`STATE_SIZES`, B and d at least 1, 1 <= chunk <= :data:`MAX_CHUNK`,
    contiguous and 16-byte aligned (``ValueError``)."""
    ops = [("dt", dt), ("x", x), ("Bm", Bm), ("Cm", Cm), ("a", a)]
    for name, t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x is on {x.device}")
    if x.ndim != 3 or a.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} / a {tuple(a.shape)}: expected "
                         f"(B, T, d) and (d, N)")
    B, T, d = x.shape
    N = a.shape[1]
    if tuple(dt.shape) != (B, T, d):
        raise ValueError(f"dt {tuple(dt.shape)} does not match x "
                         f"{(B, T, d)}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (B, T, N):
            raise ValueError(f"{name} {tuple(t.shape)}: expected {(B, T, N)}")
    if a.shape[0] != d:
        raise ValueError(f"a {tuple(a.shape)}: expected {(d, N)}")
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N}: the kernel is built for "
                         f"{STATE_SIZES}")
    if B == 0 or d == 0:
        raise ValueError(f"B={B}, d={d}: no rows")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel stages 1 to "
                         f"{MAX_CHUNK} steps at once")
    for name, t in ops:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: not contiguous or not 16-byte "
                             f"aligned")


def meta_cost(dt, x, Bm, Cm, a) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: six f32 operations a (step, channel,
    state) beside its exp, the inputs read and y, s_T written once."""
    B, T, d = x.shape
    N = a.shape[1]
    n_bytes = sum(t.numel() * t.element_size() for t in (dt, x, Bm, Cm, a))
    return 6.0 * B * T * d * N, n_bytes + 4 * (B * T * d + B * d * N)


def _forward(dt, x, Bm, Cm, a, chunk):
    """:func:`mamba_scan` outside autograd: the launch, or the plain
    version on CPU tensors, or the meta branch."""
    if x.device.type == "cpu":
        return ref.mamba_scan_ref(dt, x, Bm, Cm, a)
    check_operands(dt, x, Bm, Cm, a, chunk)
    B, T, d = x.shape
    N = a.shape[1]
    if x.device.type == "meta" and costanalysis.active() is not None:
        costanalysis.add_kernel("mamba_scan", *meta_cost(dt, x, Bm, Cm, a))
        return (x.new_empty((B, T, d), dtype=torch.float32),
                x.new_empty((B, d, N), dtype=torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu tensors (meta "
                         f"ones under a cost counter), not {x.device}")
    y = torch.empty_like(x)
    sT = torch.empty((B, d, N), dtype=torch.float32, device=x.device)
    split = (ctypes.c_int * 2)()
    lm_lib.launch("mamba_scan", x.device, dt.data_ptr(), x.data_ptr(),
                  Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(), y.data_ptr(),
                  sT.data_ptr(), B, T, d, N, int(chunk), split)
    mamba_scan.launches += 1
    mamba_scan.lanes_per_channel, mamba_scan.channels_per_lane = split
    return y, sT


def _ssm_steps(s, dt, Bm, Cm, x, a):
    """The steps of one chunk from state s: (s after them, y (B, c, d))."""
    ys = []
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a)
        s = s * da + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", s, Cm[:, t]))
    return s, torch.stack(ys, dim=1)


def ssm_chunk_scan(dt, x, Bm, Cm, a, chunk: int = SCAN_CHUNK):
    """The selective scan as differentiable tensor code, in f32: the port
    of the reference model's ``_ssm_chunk_scan``, the steps of each
    ``chunk`` under activation checkpointing (the last chunk may be short;
    the reference pads it with dt = 0, which leaves the state as it is).
    Returns (y (B, T, d), s_T (B, d, N)); the reference's returns y
    alone."""
    B, T, d = x.shape
    s = torch.zeros((B, d, a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    dt, x, Bm, Cm, a = (v.float() for v in (dt, x, Bm, Cm, a))
    ys = []
    for t0 in range(0, T, chunk):
        c = slice(t0, t0 + chunk)
        s, y = checkpoint(_ssm_steps, s, dt[:, c], Bm[:, c], Cm[:, c],
                          x[:, c], a, use_reentrant=False)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((B, 0, d))
    return y, s


class MambaScan(torch.autograd.Function):
    """K7 under autograd: the forward launches the kernel (the plain
    version on CPU tensors), the backward differentiates
    :func:`ssm_chunk_scan` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, a, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, x, Bm, Cm, a)
        return _forward(dt, x, Bm, Cm, a, chunk)

    @staticmethod
    def backward(ctx, gy, gs):
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad[:5]
        if counting_meta(saved):
            return (*meta_grads("mamba_scan_grad", saved, needs,
                                meta_cost(*saved)), None)
        return (*scan_grads(ssm_chunk_scan, saved, needs, (gy, gs)), None)


def mamba_scan(dt, x, Bm, Cm, a, *, chunk: int = 64):
    """dt, x: (B, T, d), dt > 0; Bm, Cm: (B, T, N); a: (d, N), negative.
    Returns (y (B, T, d) f32, s_T (B, d, N) f32).

    CPU tensors go through the plain version.  Other tensors are checked
    (:func:`check_operands`) and, on CUDA, launch the kernel on the current
    stream, adding one to ``mamba_scan.launches`` and setting
    ``mamba_scan.lanes_per_channel`` and ``mamba_scan.channels_per_lane``
    to the split the launch took; there is no fallback.  ``chunk`` is how
    many steps the kernel stages at once (at most T); the result does not
    depend on it.  Meta tensors under a cost counter
    (:mod:`repro_torch.launch.costanalysis`) launch nothing: the outputs
    are empty meta tensors and the counter takes :func:`meta_cost`.  Where
    an input requires grad (and grad mode is on) the call goes through
    :class:`MambaScan`."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, x, Bm, Cm, a)):
        return MambaScan.apply(dt, x, Bm, Cm, a, chunk)
    return _forward(dt, x, Bm, Cm, a, chunk)


mamba_scan.launches = 0
mamba_scan.lanes_per_channel = mamba_scan.channels_per_lane = None

"""Fused RMSNorm: the hand-written Hopper kernel K8 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py``:
``y = x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, f32 math,
output in x's dtype (``csrc/rmsnorm.cu``; plain version
:func:`repro_torch.kernels.ref.rmsnorm_ref`).

Bytes bound it on the H100 (x and w read, y written once); with few rows
(a decode step) the launch itself is most of the time.  The kernel reads
device memory once: a row's threads hold its 16-byte vectors of x and w
in registers, every load in flight at once, reduce the squares
(shuffles, then shared memory where a row spans warps) and write y from
the registers.  The launcher picks the threads a row from
the rows, D and the card's resident threads: a warp or a few a row when
rows are many, a 256-thread block a row when they are few (a decode
step), so that a launch costs one trip to memory beside its own floor.

Training goes through :class:`RMSNorm`, an autograd function whose
forward is the launch above and whose backward is
:func:`rmsnorm_backward`, the closed form in f32 (tensor code, the same on
both devices: the reference trains through XLA's autodiff of its own
``layers.rmsnorm`` and has no backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.launch import costanalysis

from . import lm_lib, ref


def occupancy(device=None) -> dict:
    """Blocks and warps of each instantiation (dtype, V vectors a thread)
    resident on one SM of ``device`` (default: the current CUDA device), as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them at 256
    threads a block and at 512, the most a launch takes: ``{"<float32 |
    bfloat16, V>": {"blocks_per_sm", "warps_per_sm", "blocks_per_sm_512",
    "warps_per_sm_512"}}``.  Builds the library if needed; launches
    nothing."""
    out = (ctypes.c_int * 64)()
    lm_lib.query("rmsnorm_occupancy", device, out)
    names = {code: str(dt).removeprefix("torch.")
             for dt, code in lm_lib.DTYPE_CODE.items()}
    res = {}
    for i in range(out[0]):
        dtype, v, blocks, blocks_512 = out[1 + 4 * i: 5 + 4 * i]
        res[f"<{names[dtype]}, {v}>"] = {
            "blocks_per_sm": blocks, "warps_per_sm": blocks * 256 // 32,
            "blocks_per_sm_512": blocks_512,
            "warps_per_sm_512": blocks_512 * 512 // 32}
    return res


def meta_cost(x, w) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: 4 a value (square, sum, scale,
    weight), x and w read and y written once."""
    return 4.0 * x.numel(), x.element_size() * (2 * x.numel() + w.numel())


def _forward(x, w, eps):
    """:func:`rmsnorm` outside autograd: the launch, or the plain version
    on CPU tensors, or the meta branch."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.dtype not in lm_lib.DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x {x.dtype} / w {w.dtype}: the kernel takes "
                        f"float32 or bfloat16, alike")
    D = x.shape[-1] if x.ndim else 0
    if x.ndim == 0 or tuple(w.shape) != (D,):
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)}: "
                         f"expected (..., D) and (D,)")
    vec = 16 // x.element_size()
    if D % vec:
        raise ValueError(f"D={D}: the kernel takes a multiple of {vec} "
                         f"for {x.dtype}")
    if w.device != x.device:
        raise ValueError(f"w: on {w.device}, x is on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.device.type == "meta" and costanalysis.active() is not None:
        costanalysis.add_kernel("rmsnorm", *meta_cost(x, w))
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors (meta ones "
                         f"under a cost counter), not {x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    lm_lib.launch("rmsnorm", x.device, x.data_ptr(), w.data_ptr(),
                  out.data_ptr(), rows, D, float(eps),
                  lm_lib.DTYPE_CODE[x.dtype])
    rmsnorm.launches += 1
    return out


def rmsnorm_backward(x, w, g, eps: float = 1e-6):
    """The gradients of ``y = x * r * (1 + w)``, ``r = rsqrt(mean(x^2) +
    eps)``, for the output's gradient g: in f32, with x^ = x * r,
    ``dx = r * ((1 + w) g - x^ * mean(x^ (1 + w) g))`` and ``dw = sum over
    rows of g x^``, returned in x's and w's dtypes."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    xhat = xf * r
    gw = gf * (1.0 + w.float())
    dx = r * (gw - xhat * torch.mean(xhat * gw, dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


class RMSNorm(torch.autograd.Function):
    """K8 under autograd: the forward launches the kernel (the plain
    version on CPU tensors), the backward is :func:`rmsnorm_backward`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*rmsnorm_backward(x, w, g, ctx.eps), None)


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D) f32 or bf16; w: (D,) in x's dtype.  Returns x's dtype.

    CPU tensors go through the plain version.  CUDA tensors launch the
    kernel on the current stream after checking dtype, device, shape,
    contiguity and 16-byte vectors (D a multiple of 4 f32 / 8 bf16, rows
    aligned) (``ValueError`` / ``TypeError``), adding one to
    ``rmsnorm.launches``; there is no fallback.  Meta tensors under a cost
    counter (:mod:`repro_torch.launch.costanalysis`) launch nothing: the
    output is an empty meta tensor and the counter takes
    :func:`meta_cost`.  Where x or w requires grad (and grad mode is on)
    the call goes through :class:`RMSNorm`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)


rmsnorm.launches = 0

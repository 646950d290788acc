"""Fused RMSNorm: the hand-written Hopper kernel K8 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py``:
``y = x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, f32 math,
output in x's dtype, one pass over the rows (``csrc/rmsnorm.cu``; plain
version :func:`repro_torch.kernels.ref.rmsnorm_ref`).
"""

from __future__ import annotations

import torch

from . import lm_lib, ref


def rmsnorm(x, w, eps: float = 1e-6):
    """x: (..., D) f32 or bf16; w: (D,) in x's dtype.  Returns x's dtype.

    CPU tensors go through the plain version.  CUDA tensors launch the
    kernel on the current stream after checking dtype, device, shape,
    contiguity and 16-byte vectors (D a multiple of 4 f32 / 8 bf16, rows
    aligned) (``ValueError`` / ``TypeError``), adding one to
    ``rmsnorm.launches``; there is no fallback."""
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
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not "
                         f"{x.device}")
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


rmsnorm.launches = 0

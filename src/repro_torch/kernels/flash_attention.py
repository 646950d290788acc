"""Flash attention: the hand-written Hopper kernel K5 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``:
blockwise online-softmax attention with causal masking, a sliding window,
GQA (query head ``b`` reads kv head ``b // (BH // BKV)``) and a logit
softcap, f32 accumulation (``csrc/flash_attention.cu``; plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`).

Layout: q (BH, Sq, hd), k / v (BKV, Sk, hd); :func:`repro_torch.kernels.ops.attention`
maps the model's (B, S, H, hd) tensors to it and back.
"""

from __future__ import annotations

import math

import torch

from . import lm_lib, ref

#: Largest head dim the kernel takes (a multiple of 8 up to it).
MAX_HEAD_DIM = 256


def check_operands(q, k, v):
    """Raise unless the kernel takes q, k, v: 3-d, one device, f32 or bf16
    alike, contiguous and 16-byte aligned rows, hd a multiple of 8 in
    [8, 256], BH a multiple of BKV, Sk > 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 3:
            raise ValueError(f"{name}: expected (B*heads, S, hd), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in lm_lib.DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16, alike for q, k, v")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q is on {q.device}")
    BH, Sq, hd = q.shape
    BKV, Sk, hdk = k.shape
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim hd={hd}: the kernel takes a multiple of "
                         f"8 up to {MAX_HEAD_DIM}")
    if hdk != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if BKV == 0 or BH % BKV or BH > 65535:
        raise ValueError(f"BH={BH} must be a multiple of BKV={BKV} and at "
                         f"most 65535")
    if Sk == 0:
        raise ValueError("Sk=0: nothing to attend to")
    align = 8 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: not contiguous or not {align}-byte "
                             f"aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (BH, Sq, hd); k, v: (BKV, Sk, hd).  Returns (BH, Sq, hd) in q's
    dtype.

    CPU tensors go through the plain version.  Other tensors are checked
    (:func:`check_operands`) and, on CUDA, launch the kernel on the current
    stream, adding one to ``flash_attention.launches``; there is no
    fallback."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    check_operands(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    BH, Sq, hd = q.shape
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    lm_lib.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), BH, k.shape[0], Sq,
                  k.shape[1], hd, int(bool(causal)), int(window),
                  float(softcap), 1.0 / math.sqrt(hd),
                  lm_lib.DTYPE_CODE[q.dtype])
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

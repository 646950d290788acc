"""Flash attention: the hand-written Hopper kernel K5 and its wrapper.

The port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``:
blockwise online-softmax attention with causal masking, a sliding window,
GQA (query head ``b`` reads kv head ``b // (BH // BKV)``) and a logit
softcap, f32 accumulation (plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`).  Two kernels behind
one C entry point, chosen by the operands (:func:`tensor_core_path`):
bf16 with hd 64, 80, 128 or 256 runs on the tensor cores
(``csrc/flash_attention_sm90.cu``: TMA, ``wgmma``), everything else (f32,
and bf16 at the tiny test models' head dims) on the SIMT kernel
(``csrc/flash_attention.cu``).

Layout: q (BH, Sq, hd), k / v (BKV, Sk, hd); :func:`repro_torch.kernels.ops.attention`
maps the model's (B, S, H, hd) tensors to it and back.

Training goes through :class:`FlashAttention`, an autograd function whose
forward is the launch and whose backward is
:func:`flash_attention_backward`: tensor code, the same on both devices,
that recomputes the scores from the saved q, k, v and output over tiles
of at most :data:`BWD_TILE` query rows (the reference trains through XLA's
autodiff of its own attention and has no backward kernel).
"""

from __future__ import annotations

import math

import torch

from repro_torch.launch import costanalysis

from . import lm_lib, ref

#: Largest head dim the kernel takes (a multiple of 8 up to it).
MAX_HEAD_DIM = 256
#: Head dims of the tensor-core path, bf16 only: llama3.2-1b's 64,
#: stablelm-3b's 80, jamba's 128 and gemma3-4b's 256.
TC_HEAD_DIMS = (64, 80, 128, 256)
#: K5 against its plain version: max|d| within this in f32; in bf16 this
#: caps the limit of :func:`excess`.
LIMIT = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: Query rows a tile of the backward recomputes its scores for.
BWD_TILE = 512
#: (query rows, keys) of a tile: the tensor-core kernel's CTA
#: (``flash_attention_sm90.cu``: BM, BN) up to hd TC_WIDE_HD, and the SIMT
#: kernel's (BQ, BK).
TC_TILE = (128, 64)
SIMT_TILE = (64, 64)
#: Above this head dim the tensor-core kernel runs one consumer warpgroup
#: a CTA instead of two: half of TC_TILE's query rows
#: (``Tiles<HD>::BM``).
TC_WIDE_HD = 128


def tensor_core_path(dtype, hd) -> bool:
    """Whether :func:`flash_attention` runs operands of ``dtype`` and head
    dim ``hd`` on the tensor-core kernel: bf16 with hd in
    :data:`TC_HEAD_DIMS`.  Everything else runs on the SIMT kernel; f32
    stays there because its 2e-5 limit rules out TF32.  The C entry point
    ``flash_attention_launch`` makes the same choice."""
    return dtype == torch.bfloat16 and hd in TC_HEAD_DIMS


def tile(tc: bool, hd) -> tuple[int, int]:
    """(query rows, keys) of the tile of the kernel :func:`tensor_core_path`
    picks (``tc``) at head dim ``hd``."""
    if not tc:
        return SIMT_TILE
    BM, BN = TC_TILE
    return (BM // 2, BN) if hd > TC_WIDE_HD else TC_TILE


def bf16_ulp(x):
    """One bf16 ulp at each value of x (f32), 2^-133 at 0."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def excess(got, want):
    """max over the outputs of |got - want| / limit: the limit is
    :data:`LIMIT` in f32; in bf16 it is the smaller of :data:`LIMIT` and two
    bf16 ulps of the plain output plus the f32 limit (the f32 math's own
    error, which the final rounding can turn into one ulp), so that it
    shrinks with the output.  At most 1 where the kernel agrees."""
    d = (got.float() - want.float()).abs()
    lim = LIMIT[got.dtype]
    if got.dtype == torch.bfloat16:
        lim = torch.clamp(2.0 * bf16_ulp(want) + LIMIT[torch.float32],
                          max=lim)
    return float((d / lim).max())


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


def tiles(Sq, Sk, causal, window, tc: bool, hd) -> int:
    """The (query block, key block) tiles a launch at head dim ``hd``
    computes for one head: the key blocks each query block visits, as the
    kernels' loops bound them (``key_blocks`` in
    ``flash_attention_sm90.cu``, the loop's break and skip in
    ``flash_attention.cu``)."""
    BM, BN = tile(tc, hd)
    nk = -(-Sk // BN)
    n = 0
    for q0 in range(0, Sq, BM):
        kb1 = min(nk, (q0 + BM - 1) // BN + 1) if causal else nk
        t = q0 - window - BN + 2
        kb0 = -(-t // BN) if window > 0 and t > 0 else 0
        n += max(0, kb1 - kb0)
    return n


def meta_cost(q, k, causal, window) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch: QK^T and PV, 4·hd a (row, key) pair,
    over every pair of the tiles the kernel computes (:func:`tiles`, whole
    tiles as the hardware computes them), and q, k, v read and the output
    written once."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    tc = tensor_core_path(q.dtype, hd)
    BM, BN = tile(tc, hd)
    flops = 4.0 * hd * BM * BN * BH * tiles(Sq, Sk, causal, window, tc, hd)
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return flops, n_bytes


def _forward(q, k, v, causal, window, softcap):
    """:func:`flash_attention` outside autograd: the launch, or the plain
    version on CPU tensors, or the meta branch."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    check_operands(q, k, v)
    if q.device.type == "meta" and costanalysis.active() is not None:
        costanalysis.add_kernel("flash_attention",
                                *meta_cost(q, k, causal, window))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors (meta "
                         f"ones under a cost counter), not {q.device}")
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
    flash_attention.tc_launches += int(tensor_core_path(q.dtype, hd))
    return out


def flash_attention_backward(q, k, v, o, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             tile: int = BWD_TILE):
    """The gradients (dq, dk, dv) of :func:`flash_attention` for the
    output's gradient ``do``, from the saved q, k, v and output o.  Over
    tiles of at most ``tile`` query rows it recomputes the scores (with the
    softcap, then the causal / window mask: masked scores get no gradient)
    and P, forms ``dS = P * (dP - rowsum(dO * O))`` with ``dP = dO V^T``,
    times ``1 - tanh^2`` under a softcap, and sums dk and dv over each KV
    head's group of query heads.  Accumulates in f32 and returns the
    inputs' dtypes.  Under causal masking a tile reads only the keys up to
    its last row."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    g = BH // BKV
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qg, og, dog = (t.reshape(BKV, g, Sq, hd) for t in (q, o, do))
    kf, vf = k.float(), v.float()
    dq = torch.empty((BKV, g, Sq, hd), dtype=f32, device=q.device)
    dk = torch.zeros((BKV, Sk, hd), dtype=f32, device=q.device)
    dv = torch.zeros((BKV, Sk, hd), dtype=f32, device=q.device)
    for i0 in range(0, Sq, tile):
        i1 = min(Sq, i0 + tile)
        # keys past the tile's last row are masked for all its rows (a row
        # masked whole lies at or past Sk, where hi is Sk)
        hi = min(Sk, i1) if causal else Sk
        qt, dot = qg[:, :, i0:i1].float(), dog[:, :, i0:i1].float()
        kt, vt = kf[:, :hi], vf[:, :hi]
        s = torch.einsum("bgqd,bkd->bgqk", qt, kt) * scale
        if softcap:
            th = torch.tanh(s / softcap)
            s = th * softcap
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(hi, device=q.device)[None, :]
        m = torch.ones((i1 - i0, hi), dtype=torch.bool, device=q.device)
        if causal:
            m &= qp >= kp
        if window:
            m &= (qp - kp) < window
        p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
        del s
        rowsum = (dot * og[:, :, i0:i1].float()).sum(-1, keepdim=True)
        ds = torch.einsum("bgqd,bkd->bgqk", dot, vt).sub_(rowsum).mul_(p)
        ds.masked_fill_(~m, 0.0)
        if softcap:
            ds.mul_(1.0 - th * th)
            del th
        dq[:, :, i0:i1] = torch.einsum("bgqk,bkd->bgqd", ds, kt) * scale
        dk[:, :hi] += torch.einsum("bgqk,bgqd->bkd", ds, qt) * scale
        dv[:, :hi] += torch.einsum("bgqk,bgqd->bkd", p, dot)
    return (dq.reshape(BH, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """K5 under autograd: the forward launches the kernel (the plain
    version on CPU tensors), the backward is
    :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o = _forward(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        return (*flash_attention_backward(q, k, v, o, do, causal=causal,
                                          window=window, softcap=softcap),
                None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (BH, Sq, hd); k, v: (BKV, Sk, hd).  Returns (BH, Sq, hd) in q's
    dtype.

    CPU tensors go through the plain version.  Other tensors are checked
    (:func:`check_operands`) and, on CUDA, launch one of the two kernels on
    the current stream, adding one to ``flash_attention.launches`` and, on
    the tensor-core path, to ``flash_attention.tc_launches``; there is no
    fallback.  Meta tensors under a cost counter
    (:mod:`repro_torch.launch.costanalysis`) launch nothing: the output is
    an empty meta tensor and the counter takes :func:`meta_cost`.  Where q,
    k or v requires grad (and grad mode is on) the call goes through
    :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap)


flash_attention.launches = 0
flash_attention.tc_launches = 0

"""GQA attention: prefill through the flash-attention kernel, and decode.

The port of the serving half of ``repro/models/attention.py``:

* **Prefill** (:func:`self_attention`) always goes through
  :func:`repro_torch.kernels.ops.attention`: K5 on a CUDA tensor,
  ``flash_attention_ref`` on a CPU one.  The layer's window is a Python
  int here (the port loops over layers in Python; it carries no schedule as
  traced scan data), so the reference's ``static_window`` condition and its
  XLA memory workarounds (``attend_blockwise``, ``attend_qchunk``, whose job
  K5 does) have no counterpart.
* **Decode** (:func:`decode_attention_cp`, the no-mesh branch of the
  reference): the new token's k / v are written into the cache by index
  (in place), then :func:`attend_dense` attends over the valid prefix.

Cache layout.  The port keeps each layer's cache as (B, KV, Smax, hd) so
that decode reads k as a plain batched-matrix operand;
:mod:`repro_torch.models.convert` maps it to and from the reference's
(B, Smax, KV, hd).

* **Under a mesh** (:func:`repro_torch.sharding.specs.use_mesh`) prefill
  and training attend on the rank's heads: q / k / v column-parallel over
  ``heads`` (K5 on the local heads), ``wo`` row-parallel and summed over
  the axis.  Where the kv heads do not split with the query heads, k / v
  are computed whole and each rank takes its query heads' groups.  Decode
  is the reference's mesh branch of :func:`decode_attention_cp`: where
  the cache is split over ``kvseq`` the rank writes the new token's k / v
  only where its shard owns the slot, takes a local masked max, and
  combines max, denominator and numerator over the ``kvseq`` axes, never
  expanding the GQA groups; where it is split over ``kvheads`` (the rules
  give them the axis when ``kvseq`` does not divide the positions) the
  rank holds its kv heads over every position, with the query heads of
  their groups, and attends locally.

* **Cross-attention** (:func:`cross_attention`, the encoder-decoder
  stacks) is plain tensor code, as the reference's ``attend_dense`` is: a
  non-causal softmax over the projected encoder positions, scores in f32.
  :func:`project_enc_kv` gives the encoder's k / v in the cache layout
  (B, KV, S_enc, hd).  The encoder's own self-attention is
  :func:`self_attention` with ``causal=False, use_rope=False``: K5 on the
  card.  Under a mesh both run on the rank's heads where ``wq`` / ``wk``
  split them, as self-attention does.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.sharding import comm

from .layers import apply_rope, fan_in_init, rmsnorm, zeros

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------
def init_attention(gen, acfg: AttentionConfig, d_model: int, dtype, device):
    H, KV, hd = acfg.num_heads, acfg.num_kv_heads, acfg.head_dim
    p = {
        "wq": fan_in_init(gen, (d_model, H, hd), dtype, device, fan_axis=0),
        "wk": fan_in_init(gen, (d_model, KV, hd), dtype, device, fan_axis=0),
        "wv": fan_in_init(gen, (d_model, KV, hd), dtype, device, fan_axis=0),
        "wo": fan_in_init(gen, (H, hd, d_model), dtype, device, fan_axis=1),
    }
    if acfg.qkv_bias:
        p["bq"] = zeros((H, hd), dtype, device)
        p["bk"] = zeros((KV, hd), dtype, device)
        p["bv"] = zeros((KV, hd), dtype, device)
    if acfg.out_bias:
        p["bo"] = zeros((d_model,), dtype, device)
    if acfg.qk_norm:
        p["q_norm"] = zeros((hd,), dtype, device)
        p["k_norm"] = zeros((hd,), dtype, device)
    return p


def _project(x, w):
    """x (B, S, D) @ w (D, heads, hd) -> (B, S, heads, hd)."""
    D, n, hd = w.shape
    return (x @ w.reshape(D, n * hd)).unflatten(-1, (n, hd))


def _out_project(acfg: AttentionConfig, params, out, dtype):
    """out (B, S, H, hd) -> (B, S, D) through wo (+ bo); under a mesh
    ``out`` holds the rank's heads and the products are summed over the
    axes that split them."""
    wo = comm.weight(params["wo"])
    H, hd, D = wo.shape
    y = out.to(dtype).flatten(-2) @ wo.reshape(H * hd, D)
    y = comm.reduce(y, comm.split_axes(params["wo"], 0))
    if acfg.out_bias:
        y = y + params["bo"]
    return y


def _q(acfg: AttentionConfig, params, x, positions, rope_theta, norm_eps):
    heads = comm.split_axes(params["wq"], 1)
    q = _project(comm.copy(x, heads), comm.weight(params["wq"]))
    if acfg.qkv_bias:
        q = q + params["bq"]
    if acfg.qk_norm:
        # replicated, applied to the rank's heads: its gradient sums
        q = rmsnorm(q, comm.copy(params["q_norm"], heads), norm_eps)
    if acfg.use_rope:
        q = apply_rope(q, positions, rope_theta)
    return q


def _kv(acfg: AttentionConfig, params, x, positions, rope_theta, norm_eps):
    kvheads = comm.split_axes(params["wk"], 1)
    xk = comm.copy(x, kvheads)
    k = _project(xk, comm.weight(params["wk"]))
    v = _project(xk, comm.weight(params["wv"]))
    if acfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    if acfg.qk_norm:
        k = rmsnorm(k, comm.copy(params["k_norm"], kvheads), norm_eps)
    if acfg.use_rope:
        k = apply_rope(k, positions, rope_theta)
    return k, v


def qkv_project(acfg: AttentionConfig, params, x, positions, rope_theta,
                norm_eps: float = 1e-6):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), rope applied.
    Under a mesh: the rank's query heads and kv heads (all kv heads where
    they do not split)."""
    q = _q(acfg, params, x, positions, rope_theta, norm_eps)
    k, v = _kv(acfg, params, x, positions, rope_theta, norm_eps)
    return q, k, v


def _kv_for_heads(acfg: AttentionConfig, params, k, v):
    """The k / v that the rank's query heads read: as they are, unless the
    query heads split and the kv heads do not; then each rank takes its
    query heads' groups of the whole k / v."""
    heads = comm.split_axes(params["wq"], 1)
    if not heads or comm.split_axes(params["wk"], 1):
        return k, v
    g = acfg.num_heads // acfg.num_kv_heads
    return (comm.split(t.repeat_interleave(g, dim=2), 2, heads)
            for t in (k, v))


def _softcap(scores, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


# --------------------------------------------------------------------------
# Dense (materialized-scores) path: decode
# --------------------------------------------------------------------------
def attend_dense(acfg: AttentionConfig, q, k, v, q_pos, window, kv_len):
    """One query position per sequence against its cache.

    q: (B, 1, H, hd); k, v: (B, KV, Smax, hd) (the port's cache layout);
    q_pos, kv_len: (B,) integer; window: int (0 = full).  Query head h
    reads kv head ``h // (H // KV)`` without expanding k / v.  Scores are
    the product in the input dtype, then f32, as in the reference."""
    B, _, H, hd = q.shape
    KV, Smax = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    scale = 1.0 / math.sqrt(acfg.head_dim)
    scores = (qg @ k.transpose(-1, -2)).float() * scale      # (B, KV, g, S)
    scores = _softcap(scores, acfg.logit_softcap)
    dk = torch.arange(Smax, device=q.device)[None, :]
    dq = q_pos[:, None]
    mask = dk < kv_len[:, None]
    if acfg.causal:
        mask = mask & (dq >= dk)
    if window > 0:
        mask = mask & (dq - dk < window)
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p.to(v.dtype) @ v                                  # (B, KV, g, hd)
    return out.reshape(B, 1, H, hd)


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------
def self_attention(acfg: AttentionConfig, params, x, positions, window: int,
                   rope_theta, norm_eps: float = 1e-6):
    """Prefill self-attention.  x: (B, S, D); positions: (S,).  Returns
    (y (B, S, D), (k, v) each (B, S, KV, hd))."""
    q, k, v = qkv_project(acfg, params, x, positions, rope_theta, norm_eps)
    ka, va = _kv_for_heads(acfg, params, k, v)
    out = ops.attention(q, ka, va, causal=acfg.causal, window=window,
                        softcap=acfg.logit_softcap)
    return _out_project(acfg, params, out, x.dtype), (k, v)


def decode_project_kv(acfg: AttentionConfig, params, x, cache_len,
                      rope_theta, norm_eps: float = 1e-6):
    """Project the new token's k/v (rope at position cache_len - 1); under
    a mesh every kv head (the cache holds them all)."""
    positions = (cache_len - 1)[:, None]
    k, v = _kv(acfg, params, x, positions, rope_theta, norm_eps)
    kvheads = comm.split_axes(params["wk"], 1)
    return comm.gather(k, 2, kvheads), comm.gather(v, 2, kvheads)


def decode_attention(acfg: AttentionConfig, params, x, cache_k, cache_v,
                     cache_len, window: int, rope_theta,
                     norm_eps: float = 1e-6):
    """Single-step decode.  x: (B, 1, D); cache_k/v: (B, KV, Smax, hd) with
    ``cache_len`` (B,) valid slots, the new token's k/v already written.
    Positions: new token at ``cache_len - 1``."""
    pos = cache_len - 1
    q = _q(acfg, params, x, pos[:, None], rope_theta, norm_eps)
    out = attend_dense(acfg, q, cache_k, cache_v, pos, window, cache_len)
    return _out_project(acfg, params, out, x.dtype)


def decode_attention_cp(acfg: AttentionConfig, params, x, cache_k, cache_v,
                        k_new, v_new, cache_len, window: int, rope_theta,
                        norm_eps: float = 1e-6):
    """The reference's no-mesh branch: write the new token's k/v at
    ``cache_len - 1`` of each sequence (in place; a sequence whose cache is
    full writes nothing, as the reference's one-hot write), then attend.
    Under a mesh, the mesh branch (:func:`_decode_attention_mesh`).
    Returns (y, cache_k, cache_v)."""
    if comm.active():
        return _decode_attention_mesh(acfg, params, x, cache_k, cache_v,
                                      k_new, v_new, cache_len, window,
                                      rope_theta, norm_eps)
    B, Smax = cache_k.shape[0], cache_k.shape[2]
    idx = (cache_len - 1).long()
    fits = (idx < Smax)[:, None, None]
    at = idx.clamp(max=Smax - 1)
    rows = torch.arange(B, device=x.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        old = cache[rows, :, at]                              # (B, KV, hd)
        cache[rows, :, at] = torch.where(fits, new[:, 0].to(cache.dtype),
                                         old)
    y = decode_attention(acfg, params, x, cache_k, cache_v, cache_len,
                         window, rope_theta, norm_eps)
    return y, cache_k, cache_v


def _regroup(t, dim: int, have: tuple, want: tuple):
    """``t``'s heads (dim ``dim``) split over ``have`` as split over
    ``want`` instead."""
    if have == want:
        return t
    return comm.split(comm.gather(t, dim, have), dim, want)


def _decode_attention_mesh(acfg: AttentionConfig, params, x, cache_k,
                           cache_v, k_new, v_new, cache_len, window: int,
                           rope_theta, norm_eps):
    """Flash-decode on this rank's block of the cache (B, KV_loc, S_loc,
    hd), its kv heads split over the ``kvheads`` axes and its sequence
    over the ``kvseq`` axes its spec names.  The rank takes the query
    heads of its kv heads' groups and their new k / v; the new token's
    k / v are written only by the shard that owns the slot (in place);
    then a local masked partial softmax, whose max, denominator and
    numerator are combined over the ``kvseq`` axes.  Scores and the
    numerator accumulate in f32 (the reference's
    ``preferred_element_type``); the groups are never expanded."""
    spec = comm.spec_of(cache_k) or (None,) * 4
    head_axes = comm.entry_axes(spec[1])
    kv_axes = comm.entry_axes(spec[2])
    B, KV, S_loc, hd = cache_k.shape
    H = acfg.num_heads * KV // acfg.num_kv_heads
    pos = (cache_len - 1).long()
    heads = comm.split_axes(params["wq"], 1)
    q = _regroup(_q(acfg, params, x, pos[:, None], rope_theta, norm_eps), 2,
                 heads, head_axes)                         # (B, 1, H, hd)
    k_new, v_new = (comm.split(t, 2, head_axes) for t in (k_new, v_new))
    base = comm.axes_index(kv_axes) * S_loc if kv_axes else 0
    local = pos - base
    fits = ((local >= 0) & (local < S_loc))[:, None, None]
    at = local.clamp(0, S_loc - 1)
    rows = torch.arange(B, device=x.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        old = cache[rows, :, at]                              # (B, KV, hd)
        cache[rows, :, at] = torch.where(fits, new[:, 0].to(cache.dtype),
                                         old)
    qg = q.reshape(B, KV, H // KV, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = (qg @ cache_k.float().transpose(-1, -2)) * scale   # (B, KV, g, S)
    s = _softcap(s, acfg.logit_softcap)
    dk = base + torch.arange(S_loc, device=x.device)[None, :]
    dq = pos[:, None]
    mask = (dq >= dk) & (dk < cache_len[:, None])
    if window > 0:
        mask = mask & (dq - dk < window)
    s = torch.where(mask[:, None, None, :], s, _NEG_INF)
    m = comm.all_reduce_max(s.max(dim=-1, keepdim=True).values, kv_axes)
    p = torch.exp(s - m)
    den = comm.reduce(p.sum(-1, keepdim=True), kv_axes)
    num = comm.reduce(p.to(cache_v.dtype).float() @ cache_v.float(),
                      kv_axes)                            # (B, KV, g, hd)
    out = (num / torch.clamp_min(den, 1e-30)).reshape(B, 1, H, hd)
    out = _regroup(out.to(q.dtype), 2, head_axes, heads)
    return _out_project(acfg, params, out, x.dtype), cache_k, cache_v


def _grouped_attention(acfg: AttentionConfig, q, k, v):
    """Every query against every key, no mask.  q: (B, Sq, H, hd); k, v:
    (B, KV, Sk, hd).  Query head h reads kv head ``h // (H // KV)``; the
    scores are the product in the input dtype, then f32, as in the
    reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[1]
    qg = q.transpose(1, 2).reshape(B, KV, (H // KV) * Sq, hd)
    scale = 1.0 / math.sqrt(acfg.head_dim)
    scores = (qg @ k.transpose(-1, -2)).float() * scale
    scores = _softcap(scores, acfg.logit_softcap)
    p = torch.softmax(scores, dim=-1)
    out = p.to(v.dtype) @ v                          # (B, KV, g * Sq, hd)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def _enc_kv_for_heads(acfg: AttentionConfig, params, k, v):
    """The encoder k / v (B, KV, S_enc, hd) that the rank's query heads
    read: as they are, unless the query heads split and the kv heads do
    not; then each rank takes its query heads' groups."""
    heads = comm.split_axes(params["wq"], 1)
    if not heads or comm.split_axes(params["wk"], 1):
        return k, v
    g = acfg.num_heads // acfg.num_kv_heads
    return (comm.split(t.repeat_interleave(g, dim=1), 1, heads)
            for t in (k, v))


def cross_attention(acfg: AttentionConfig, params, x, enc_kv,
                    norm_eps: float = 1e-6):
    """Decoder cross-attention.  x: (B, S, D); enc_kv = (k, v), each (B, KV,
    S_enc, hd), projected once per sequence (:func:`project_enc_kv`; under
    a mesh the rank's kv heads)."""
    heads = comm.split_axes(params["wq"], 1)
    q = _project(comm.copy(x, heads), comm.weight(params["wq"]))
    if acfg.qkv_bias:
        q = q + params["bq"]
    if acfg.qk_norm:
        q = rmsnorm(q, comm.copy(params["q_norm"], heads), norm_eps)
    out = _grouped_attention(acfg, q, *_enc_kv_for_heads(acfg, params,
                                                         *enc_kv))
    return _out_project(acfg, params, out, x.dtype)


def project_enc_kv(acfg: AttentionConfig, params, enc_out):
    """The cross-attention k / v of the encoder's output (B, S_enc, D), each
    (B, KV, S_enc, hd); under a mesh the rank's kv heads where ``wk``
    splits them."""
    kvheads = comm.split_axes(params["wk"], 1)
    x = comm.copy(enc_out, kvheads)
    k = _project(x, comm.weight(params["wk"]))
    v = _project(x, comm.weight(params["wv"]))
    if acfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    if acfg.qk_norm:
        k = rmsnorm(k, comm.copy(params["k_norm"], kvheads))
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()

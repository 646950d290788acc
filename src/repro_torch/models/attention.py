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
(B, Smax, KV, hd).  Cross-attention waits for the enc-dec slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops

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
    """out (B, S, H, hd) -> (B, S, D) through wo (+ bo)."""
    H, hd, D = params["wo"].shape
    y = out.to(dtype).flatten(-2) @ params["wo"].reshape(H * hd, D)
    if acfg.out_bias:
        y = y + params["bo"]
    return y


def _q(acfg: AttentionConfig, params, x, positions, rope_theta, norm_eps):
    q = _project(x, params["wq"])
    if acfg.qkv_bias:
        q = q + params["bq"]
    if acfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], norm_eps)
    if acfg.use_rope:
        q = apply_rope(q, positions, rope_theta)
    return q


def _kv(acfg: AttentionConfig, params, x, positions, rope_theta, norm_eps):
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if acfg.qkv_bias:
        k, v = k + params["bk"], v + params["bv"]
    if acfg.qk_norm:
        k = rmsnorm(k, params["k_norm"], norm_eps)
    if acfg.use_rope:
        k = apply_rope(k, positions, rope_theta)
    return k, v


def qkv_project(acfg: AttentionConfig, params, x, positions, rope_theta,
                norm_eps: float = 1e-6):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), rope applied."""
    q = _q(acfg, params, x, positions, rope_theta, norm_eps)
    k, v = _kv(acfg, params, x, positions, rope_theta, norm_eps)
    return q, k, v


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
    out = ops.attention(q, k, v, causal=acfg.causal, window=window,
                        softcap=acfg.logit_softcap)
    return _out_project(acfg, params, out, x.dtype), (k, v)


def decode_project_kv(acfg: AttentionConfig, params, x, cache_len,
                      rope_theta, norm_eps: float = 1e-6):
    """Project the new token's k/v (rope at position cache_len - 1)."""
    positions = (cache_len - 1)[:, None]
    return _kv(acfg, params, x, positions, rope_theta, norm_eps)


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
    Returns (y, cache_k, cache_v)."""
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

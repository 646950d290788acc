"""RWKV6 ("Finch") mixer and channel-mix.

The port of ``repro/models/rwkv6.py``.  Time-mix recurrence per head
(state S: (head_dim, head_dim)):

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

with the decay w_t ∈ (0, 1) computed from the input and u a learned bonus
for the current token.  The reference's model scans in XLA
(``_wkv_chunk_scan``); here the scan always goes through
:func:`repro_torch.kernels.ops.wkv`, i.e. kernel K6 on a CUDA tensor and
``rwkv6_scan_ref`` on a CPU one, in prefill and in decode alike.  Dtypes
follow the reference: ddlerp and decay in f32, projections in x's dtype,
the scan in f32.

Channel-mix (``rwkv_ffn``) is the squared-relu K/V gating of the paper.

Under a mesh (:func:`repro_torch.sharding.specs.use_mesh`) the token
shift, the ddlerp and the decay run whole (their parameters are
replicated); ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` are column-parallel over
``ffn``, so the scan (K6) and the per-head groupnorm run on the rank's
heads, with its blocks of the decay, ``u``, ``ln_w`` and ``ln_b``; ``w_o``
is row-parallel and summed over the axis.  The channel-mix's ``w_k`` is
column-parallel, ``w_v`` row-parallel and summed, ``w_r`` replicated over
``model``.  The decode state ``wkv`` holds the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKV6Config
from repro_torch.kernels import ops
from repro_torch.sharding import comm

from .layers import fan_in_init, normal, zeros


def init_rwkv6(gen, rcfg: RWKV6Config, d_model: int, dtype, device):
    D = d_model
    f32 = torch.float32
    p = {
        # ddlerp token-shift mixers: 5 targets (w, k, v, r, g) + base
        "mu_base": normal(gen, (D,), 0.02, f32, device),
        "mu_wkvrg": normal(gen, (5, D), 0.02, f32, device),
        "ddlerp_a": normal(gen, (D, 5 * rcfg.lora_mix), 0.02, f32, device),
        "ddlerp_b": normal(gen, (5, rcfg.lora_mix, D), 0.02, f32, device),
        # decay: w = exp(-exp(w0 + tanh(xw @ A) @ B))
        "w0": normal(gen, (D,), 0.02, f32, device) - 6.0,
        "lora_wa": normal(gen, (D, rcfg.lora_w), 0.02, f32, device),
        "lora_wb": normal(gen, (rcfg.lora_w, D), 0.02, f32, device),
        "u": normal(gen, (D,), 0.02, f32, device),
        "w_r": fan_in_init(gen, (D, D), dtype, device),
        "w_k": fan_in_init(gen, (D, D), dtype, device),
        "w_v": fan_in_init(gen, (D, D), dtype, device),
        "w_g": fan_in_init(gen, (D, D), dtype, device),
        "w_o": fan_in_init(gen, (D, D), dtype, device),
        "ln_w": zeros((D,), f32, device),
        "ln_b": zeros((D,), f32, device),
    }
    return p


def init_rwkv_ffn(gen, d_model: int, d_ff: int, dtype, device):
    f32 = torch.float32
    return {
        "mu_k": normal(gen, (d_model,), 0.02, f32, device),
        "mu_r": normal(gen, (d_model,), 0.02, f32, device),
        "w_k": fan_in_init(gen, (d_model, d_ff), dtype, device),
        "w_v": fan_in_init(gen, (d_ff, d_model), dtype, device),
        "w_r": fan_in_init(gen, (d_model, d_model), dtype, device),
    }


def _token_shift(x, last=None):
    """Previous token's x; the first position takes ``last`` (decode
    cache) or 0."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(p, x, xx):
    """RWKV6 data-dependent lerp producing the 5 mixed inputs (w, k, v, r,
    g): f32 (5, B, T, D)."""
    sx = (xx - x).float()
    xf = x.float()
    base = xf + sx * p["mu_base"]
    low = torch.tanh(base @ p["ddlerp_a"])
    B, T, _ = x.shape
    low = low.reshape(B, T, 5, -1)
    adj = torch.einsum("btsm,smd->sbtd", low, p["ddlerp_b"])
    return xf[None] + sx[None] * (p["mu_wkvrg"][:, None, None, :] + adj)


def _decay(p, xw):
    """w_t in (0, 1): exp(-exp(w0 + lora(xw)))."""
    lo = torch.tanh(xw @ p["lora_wa"]) @ p["lora_wb"]
    return torch.exp(-torch.exp(p["w0"] + lo))


def _groupnorm(x, w, b, H: int, eps: float = 64e-5):
    """Per-head groupnorm (RWKV normalizes each head's output), population
    variance."""
    B, T, D = x.shape
    xh = x.reshape(B, T, H, D // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(B, T, D)
    return y * w + b


def _heads_axes(params, D: int, n: int) -> tuple:
    """The axes that split the time-mix's heads (``w_r``'s columns); a
    head's n columns never straddle two ranks."""
    heads = comm.split_axes(params["w_r"], 1)
    if (D // n) % comm.axes_size(heads):
        raise NotImplementedError(
            f"rwkv6 heads {D // n} do not split over {heads} "
            f"({comm.axes_size(heads)} ranks)")
    return heads


def rwkv6_forward(rcfg: RWKV6Config, params, x, shift_state=None,
                  wkv_state=None, return_state: bool = False):
    """x: (B, T, D).  Optional decode states (last token (B, D), S matrix
    (B, H, n, n) f32, under a mesh the rank's heads); with
    ``return_state`` also returns the new ones."""
    B, T, D = x.shape
    n = rcfg.head_dim
    heads = _heads_axes(params, D, n)
    xx = _token_shift(x, shift_state)
    xw, xk, xv, xr, xg = _ddlerp(params, x, xx)
    w = comm.split(_decay(params, xw), 2, heads)
    u, ln_w, ln_b = (comm.split(params[k], 0, heads)
                     for k in ("u", "ln_w", "ln_b"))
    r, k, v, g = (comm.copy(t.to(x.dtype), heads) @ comm.weight(params[name])
                  for t, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"),
                                  (xg, "w_g")))
    g = F.silu(g)
    out, S = ops.wkv(r.float(), k.float(), v.float(), w, u, n, s0=wkv_state)
    y = _groupnorm(out, ln_w, ln_b, out.shape[-1] // n)
    y = (y * g.float()).to(x.dtype) @ comm.weight(params["w_o"])
    y = comm.reduce(y, comm.split_axes(params["w_o"], 0))
    if return_state:
        return y, (x[:, -1], S)
    return y


def rwkv_ffn_forward(params, x, shift_state=None, return_state: bool = False):
    xx = _token_shift(x, shift_state)
    sx = (xx - x).float()
    xf = x.float()
    xk = (xf + sx * params["mu_k"]).to(x.dtype)
    xr = (xf + sx * params["mu_r"]).to(x.dtype)
    ffn = comm.split_axes(params["w_k"], 1)
    k = torch.square(F.relu(comm.copy(xk, ffn) @ comm.weight(params["w_k"])))
    kv = comm.reduce(k @ comm.weight(params["w_v"]), ffn)
    y = torch.sigmoid(xr @ comm.weight(params["w_r"])) * kv
    if return_state:
        return y, x[:, -1]
    return y


# -- decode ------------------------------------------------------------------
def rwkv6_decode_init(rcfg: RWKV6Config, d_model: int, batch: int, dtype,
                      device):
    H = d_model // rcfg.head_dim
    return {
        "att_shift": zeros((batch, d_model), dtype, device),
        "ffn_shift": zeros((batch, d_model), dtype, device),
        "wkv": zeros((batch, H, rcfg.head_dim, rcfg.head_dim),
                     torch.float32, device),
    }


def rwkv6_decode_step(rcfg: RWKV6Config, params, ffn_params, x, cache,
                      norm1_fn, norm2_fn):
    """One token through time-mix + channel-mix with cached states."""
    h = norm1_fn(x)
    y, (att_shift, wkv) = rwkv6_forward(
        rcfg, params, h, shift_state=cache["att_shift"],
        wkv_state=cache["wkv"], return_state=True)
    x = x + y
    h = norm2_fn(x)
    y, ffn_shift = rwkv_ffn_forward(ffn_params, h,
                                    shift_state=cache["ffn_shift"],
                                    return_state=True)
    x = x + y
    return x, {"att_shift": att_shift, "ffn_shift": ffn_shift, "wkv": wkv}

"""Mamba-1 selective-state-space mixer (Jamba flavor).

The port of ``repro/models/mamba.py``.  Per expanded channel (state s:
(d_state,)):

    s_t = exp(dt_t a) ⊙ s_{t-1} + (dt_t x_t) B_t
    y_t = s_t · C_t + d x_t

with dt, B and C computed from the input.  The reference's model scans in
XLA (``_ssm_chunk_scan``, a chunked ``lax.scan``); here the prefill scan
goes through :func:`repro_torch.kernels.ops.selective_scan`, i.e. kernel K7
on a CUDA tensor and ``mamba_scan_ref`` on a CPU one, and the same pass
returns the final state for the decode cache.  Decode is one elementwise
step, as in the reference, and runs no scan kernel.  Dtypes follow the
reference: the projections in the parameters' dtype, cast to f32 after
them; ``a_log`` and ``d`` are f32 parameters; the scan is f32.

Cache: ``{"conv": (B, d_conv - 1, d_in), "ssm": (B, d_in, d_state) f32}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.kernels import ops

from .layers import fan_in_init, normal, rmsnorm, zeros


def dt_rank_of(mcfg: MambaConfig, d_model: int) -> int:
    return mcfg.dt_rank or -(-d_model // 16)


def init_mamba(gen, mcfg: MambaConfig, d_model: int, dtype, device):
    d_in = mcfg.expand * d_model
    R = dt_rank_of(mcfg, d_model)
    N = mcfg.d_state
    f32 = torch.float32
    # S4D-real initialization for A
    a = torch.arange(1, N + 1, dtype=f32, device=device)[None, :].repeat(
        d_in, 1)
    return {
        "in_proj": fan_in_init(gen, (d_model, 2 * d_in), dtype, device),
        "conv_w": normal(gen, (mcfg.d_conv, d_in), 0.02, dtype, device),
        "conv_b": zeros((d_in,), dtype, device),
        "x_dt": fan_in_init(gen, (d_in, R), dtype, device),
        "x_b": fan_in_init(gen, (d_in, N), dtype, device),
        "x_c": fan_in_init(gen, (d_in, N), dtype, device),
        "dt_proj": normal(gen, (R, d_in), R ** -0.5, dtype, device),
        "dt_bias": _dt_bias_init(gen, d_in, device),
        "a_log": torch.log(a),
        "d": torch.ones((d_in,), dtype=f32, device=device),
        "norm": zeros((d_in,), dtype, device),
        "out_proj": fan_in_init(gen, (d_in, d_model), dtype, device),
    }


def _dt_bias_init(gen, d_in, device, dt_min=1e-3, dt_max=0.1):
    """The inverse softplus of dt drawn log-uniform in [dt_min, dt_max]."""
    if gen is None:
        return torch.empty((d_in,), dtype=torch.float32, device=device)
    u = torch.rand((d_in,), generator=gen, device=gen.device,
                   dtype=torch.float32)
    dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                   + math.log(dt_min))
    return torch.log(torch.expm1(dt)).to(device)


def _causal_conv(x, w, b):
    """Depthwise causal conv; x: (B, T, d_in), w: (K, d_in)."""
    K, T = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for j in range(K):
        shift = K - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :T]
        out = out + xs * w[j]
    return out + b


def _ssm_inputs(params, xc):
    """(dt, B, C, a) of the scan from the conv output xc (B, T, d_in): the
    projections in xc's dtype, then f32."""
    dt_low = xc @ params["x_dt"]
    dt = (dt_low @ params["dt_proj"]).float()
    dt = F.softplus(dt + params["dt_bias"])
    Bm = (xc @ params["x_b"]).float()
    Cm = (xc @ params["x_c"]).float()
    a = -torch.exp(params["a_log"])
    return dt, Bm, Cm, a


def mamba_forward(mcfg: MambaConfig, params, x):
    """x: (B, T, D) -> ((B, T, D), the decode cache after the prompt:
    ``conv`` the last d_conv - 1 pre-conv activations (zeros before the
    first token), ``ssm`` the scan's final state)."""
    B, T, D = x.shape
    d_in = mcfg.expand * D
    h = x @ params["in_proj"]
    xz, z = h[..., :d_in], h[..., d_in:]
    xc = F.silu(_causal_conv(xz, params["conv_w"], params["conv_b"]))

    xf = xc.float()
    dt, Bm, Cm, a = _ssm_inputs(params, xc)
    y, ssm = ops.selective_scan(dt, xf, Bm, Cm, a)
    y = y + xf * params["d"]
    y = y.to(x.dtype)
    y = rmsnorm(y, params["norm"]) * F.silu(z)
    out = y @ params["out_proj"]
    K = mcfg.d_conv
    conv = F.pad(xz[:, -(K - 1):], (0, 0, max(0, K - 1 - T), 0))
    return out, {"conv": conv, "ssm": ssm}


# --------------------------------------------------------------------------
# Decode: O(1) per step.  Cache = {"conv": (B, K-1, d_in), "ssm": (B, d_in, N)}
# --------------------------------------------------------------------------
def mamba_decode_init(mcfg: MambaConfig, d_model: int, batch: int, dtype,
                      device):
    d_in = mcfg.expand * d_model
    return {
        "conv": zeros((batch, mcfg.d_conv - 1, d_in), dtype, device),
        "ssm": zeros((batch, d_in, mcfg.d_state), torch.float32, device),
    }


def mamba_decode_step(mcfg: MambaConfig, params, x, cache):
    """x: (B, 1, D); returns (y (B, 1, D), cache')."""
    B, _, D = x.shape
    d_in = mcfg.expand * D
    h = x @ params["in_proj"]
    xz, z = h[..., :d_in], h[..., d_in:]

    window = torch.cat([cache["conv"], xz], dim=1)            # (B, K, d_in)
    conv = torch.einsum("bke,ke->be", window, params["conv_w"]) \
        + params["conv_b"]
    xc = F.silu(conv)[:, None, :]                             # (B, 1, d_in)
    new_conv = window[:, 1:]

    dt, Bm, Cm, a = _ssm_inputs(params, xc)
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]                 # (B, d_in), (B, N)
    s = cache["ssm"]
    da = torch.exp(dt[..., None] * a)
    xf = xc[:, 0].float()
    s = s * da + (dt * xf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", s, Cm) + xf * params["d"]
    y = y.to(x.dtype)[:, None, :]
    y = rmsnorm(y, params["norm"]) * F.silu(z)
    out = y @ params["out_proj"]
    return out, {"conv": new_conv, "ssm": s}

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

Under a mesh (:func:`repro_torch.sharding.specs.use_mesh`) the expanded
channels d_in split over ``ffn``.  ``in_proj``'s spec splits its
concatenated (x, z) columns contiguously, so a rank's block of them is
not its channels of each half: its product is gathered over the axis
(:func:`~repro_torch.sharding.comm.gather_sum`, whose backward sums and
scatters) and each rank takes its channel block of x and of z.  The conv,
``dt_proj``, ``dt_bias``, ``a_log``, ``d`` and the scan (K7) are local to
those channels; ``x_dt`` / ``x_b`` / ``x_c`` are row-parallel, so
``dt_low``, B and C are summed over the axis before use; the gated norm
runs on whole rows (K8), its input's channels gathered and the rank's
block of its output kept; ``out_proj`` is row-parallel and summed.  The
cache's ``conv`` and ``ssm`` hold the rank's channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.kernels import ops
from repro_torch.sharding import comm

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


def _split_in_proj(params, x, d_in: int):
    """(the axes that split the channels, the rank's channels of x and of
    z) of ``in_proj``'s product with x (B, T, D)."""
    ffn = comm.split_axes(params["in_proj"], 1)
    n = comm.axes_size(ffn)
    if d_in % n:
        raise NotImplementedError(
            f"mamba d_in {d_in} does not split over {ffn} ({n} ranks)")
    h = comm.copy(x, ffn) @ comm.weight(params["in_proj"])
    if not ffn:
        return ffn, h[..., :d_in], h[..., d_in:]
    # the gathered product is channel-major: each half's block is copied
    # out row-major, as the scan's operands must be
    h = comm.gather_sum(h, 2, ffn)
    c = d_in // n
    lo = comm.axes_index(ffn) * c
    return ffn, h[..., lo:lo + c].contiguous(), \
        h[..., d_in + lo:d_in + lo + c].contiguous()


def _ssm_inputs(params, xc, ffn: tuple = ()):
    """(dt, B, C, a) of the scan from the conv output xc (B, T, d_in): the
    projections in xc's dtype, then f32.  Under a mesh xc holds the rank's
    channels (``ffn``): the row-parallel products are summed over the
    axes, and each whole sum enters the rank's part of the layer."""
    part = lambda w: comm.copy(comm.reduce(xc @ comm.weight(params[w]), ffn),
                               ffn)
    dt = (part("x_dt") @ params["dt_proj"]).float()
    dt = F.softplus(dt + params["dt_bias"])
    Bm = part("x_b").float()
    Cm = part("x_c").float()
    a = -torch.exp(params["a_log"])
    return dt, Bm, Cm, a


def _gated_norm(params, y, z, ffn: tuple):
    """``rmsnorm(y, norm) * silu(z)`` over the whole of d_in: under a mesh
    y's channels are gathered, K8 runs on whole rows and the rank keeps
    its block."""
    y = comm.split(rmsnorm(comm.gather(y, 2, ffn),
                           comm.gather(params["norm"], 0, ffn)), 2, ffn)
    return y * F.silu(z)


def _out_proj(params, y, ffn: tuple):
    return comm.reduce(y @ comm.weight(params["out_proj"]), ffn)


def mamba_forward(mcfg: MambaConfig, params, x):
    """x: (B, T, D) -> ((B, T, D), the decode cache after the prompt:
    ``conv`` the last d_conv - 1 pre-conv activations (zeros before the
    first token), ``ssm`` the scan's final state)."""
    B, T, D = x.shape
    ffn, xz, z = _split_in_proj(params, x, mcfg.expand * D)
    xc = F.silu(_causal_conv(xz, params["conv_w"], params["conv_b"]))

    xf = xc.float()
    dt, Bm, Cm, a = _ssm_inputs(params, xc, ffn)
    y, ssm = ops.selective_scan(dt, xf, Bm, Cm, a)
    y = y + xf * params["d"]
    y = _gated_norm(params, y.to(x.dtype), z, ffn)
    out = _out_proj(params, y, ffn)
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
    ffn, xz, z = _split_in_proj(params, x, mcfg.expand * D)

    window = torch.cat([cache["conv"], xz], dim=1)            # (B, K, d_in)
    conv = torch.einsum("bke,ke->be", window, params["conv_w"]) \
        + params["conv_b"]
    xc = F.silu(conv)[:, None, :]                             # (B, 1, d_in)
    new_conv = window[:, 1:]

    dt, Bm, Cm, a = _ssm_inputs(params, xc, ffn)
    dt, Bm, Cm = dt[:, 0], Bm[:, 0], Cm[:, 0]                 # (B, d_in), (B, N)
    s = cache["ssm"]
    da = torch.exp(dt[..., None] * a)
    xf = xc[:, 0].float()
    s = s * da + (dt * xf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", s, Cm) + xf * params["d"]
    y = _gated_norm(params, y.to(x.dtype)[:, None, :], z, ffn)
    return _out_proj(params, y, ffn), {"conv": new_conv, "ssm": s}

"""Shared building blocks: inits, norms, rotary embeddings, embeddings and
the gated FFN.

The port of the serving half of ``repro/models/layers.py``: the same
functions over dicts of tensors, in the reference's layouts and dtypes.
Inits draw from an explicit ``torch.Generator`` (not JAX's keys: the two
give different numbers from one seed; the tests carry JAX's parameters over
with :func:`repro_torch.models.convert.params_from_numpy`).  The sharding
annotations of the reference are identities without a mesh and are
dropped.  The losses wait for the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import rmsnorm as kernel_rmsnorm


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------
# Initializers: f32 normal draws on the generator's device, scaled, cast
# --------------------------------------------------------------------------
def normal(gen, shape, std, dtype, device):
    """N(0, std^2) drawn from ``gen``; with ``gen=None``, an uninitialised
    tensor of the same shape (for shapes alone, on the meta device)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def fan_in_init(gen, shape, dtype, device, fan_axis: int = -2):
    """Scaled init: std = 1/sqrt(fan_in)."""
    fan_in = shape[fan_axis] if len(shape) > 1 else shape[0]
    return normal(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype, device)


def zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm in f32 (returned in x's dtype), through K8 on the card."""
    return kernel_rmsnorm(x.contiguous(), w, eps)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu_sq": lambda x: torch.square(F.relu(x)),
        "relu": F.relu,
    }[name]


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def apply_rope(x, positions, theta, head_dim: int | None = None):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = head_dim or x.shape[-1]
    half = hd // 2
    theta = torch.tensor(theta, dtype=torch.float32, device=x.device)
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv_freq = theta ** (-exponent)                           # (half,)
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def init_embed(gen, vocab, d_model, dtype, device, tie: bool):
    # std = 1/sqrt(d): tied-embedding logits come out O(1) per component
    p = {"tok": normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model),
                       dtype, device)}
    if not tie:
        p["head"] = fan_in_init(gen, (d_model, vocab), dtype, device)
    return p


def embed(params, tokens, scale: bool, d_model: int):
    x = params["tok"][tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed_logits(params, x, tie: bool):
    w = params["tok"].t() if tie else params["head"]
    return x @ w


# --------------------------------------------------------------------------
# Dense (SwiGLU / GeGLU) FFN
# --------------------------------------------------------------------------
def init_mlp(gen, d_model, d_ff, dtype, device):
    return {"w_gate": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_in": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_out": fan_in_init(gen, (d_ff, d_model), dtype, device)}


def mlp(params, x, act: str):
    h = x @ params["w_gate"]
    u = x @ params["w_in"]
    return (act_fn(act)(h) * u) @ params["w_out"]

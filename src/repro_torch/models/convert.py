"""Carrying the reference's parameters and decode caches into the port.

The reference keeps its parameters as a pytree whose layer leaves are
stacked over periods (``stack[j][name]`` of shape ``(num_periods, ...)``
for pattern position ``j``) and its decode cache as ``{"stack": ({"k",
"v"} of shape (periods, B, S, KV, hd),), "len": (B,)}``.  The port holds
one :class:`~repro_torch.models.transformer.Layer` per layer and one
(B, KV, S, hd) cache entry per layer.  These functions map numpy trees
(``jax.tree.map(np.asarray, tree)`` on the reference side) to and from the
port's objects; they import nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import transformer


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no torch twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _numpy(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _layer_index(cfg: ModelConfig, l: int):
    """(pattern position, period) of layer ``l``."""
    P = cfg.layers_per_period
    return l % P, l // P


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter pytree (numpy leaves) as the port's
    module, on ``device`` (default: the card)."""
    device = resolve_device(device)
    transformer.check_supported(cfg)
    t = lambda a: _tensor(a, device)
    layers = []
    for l in range(cfg.num_layers):
        j, p = _layer_index(cfg, l)
        st = tree["stack"][j]
        layers.append((t(st["norm1"][p]), t(st["norm2"][p]),
                       {k: t(v[p]) for k, v in st["attn"].items()},
                       {k: t(v[p]) for k, v in st["mlp"].items()}))
    return transformer.build(
        cfg, {k: t(v) for k, v in tree["embed"].items()},
        t(tree["final_norm"]), layers)


def cache_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's decode (or prefill) cache as the port's."""
    device = resolve_device(device)
    layers = []
    for l in range(cfg.num_layers):
        j, p = _layer_index(cfg, l)
        e = tree["stack"][j]
        layers.append({n: _tensor(e[n][p], device).transpose(1, 2)
                       .contiguous() for n in ("k", "v")})
    return {"layers": layers,
            "len": _tensor(tree["len"], device, torch.int32)}


def cache_to_numpy(cfg: ModelConfig, cache):
    """The port's cache in the reference's layout (numpy, f32 for bf16)."""
    P, n = cfg.layers_per_period, cfg.num_periods
    stack = []
    for j in range(P):
        e = {}
        for name in ("k", "v"):
            e[name] = np.stack([_numpy(cache["layers"][p * P + j][name]
                                       .transpose(1, 2)) for p in range(n)])
        stack.append(e)
    return {"stack": tuple(stack), "len": _numpy(cache["len"])}

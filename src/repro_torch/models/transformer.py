"""Decoder-stack assembly: init / prefill / decode for dense decoders.

The port of the serving half of ``repro/models/transformer.py``.  The
reference stacks each pattern position's parameters over periods and runs
the stack under one ``lax.scan`` with the per-layer window and rope theta
as scan data; here the stack is an ``nn.ModuleList`` of :class:`Layer`
looped in Python, and each layer carries its window and theta as plain
numbers (:func:`layer_schedules`).

Only ``LayerSpec("attention", "dense")`` stacks are ported: mamba, rwkv6,
MoE and enc-dec configs raise ``NotImplementedError`` naming the slice that
will port them.  The losses wait for the training slice.

Cache: ``{"layers": [{"k", "v"} per layer, each (B, KV, Smax, hd)],
"len": (B,) int32}`` (:mod:`repro_torch.models.attention`).  Decode
writes the new token into it in place and returns it.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from .layers import (dtype_of, embed, init_embed, init_mlp, mlp, rmsnorm,
                     unembed_logits, zeros)

_NOT_YET = {
    "mamba": "the mamba mixer lands with kernel K7 mamba_scan in the next "
             "slice of the port (ROADMAP.md S2)",
    "rwkv6": "the rwkv6 mixer lands with kernel K6 rwkv6_scan in the next "
             "slice of the port (ROADMAP.md S2)",
    "moe": "MoE FFNs land in a later slice of the port (ROADMAP.md S2)",
    "rwkv_ffn": "the rwkv6 channel-mix lands with kernel K6 in the next "
                "slice of the port (ROADMAP.md S2)",
    "encdec": "encoder-decoder stacks land in a later slice of the port "
              "(ROADMAP.md S2)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is a
    dense attention layer of a decoder-only stack."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: {_NOT_YET['encdec']}")
    for spec in cfg.pattern:
        if spec.mixer != "attention":
            raise NotImplementedError(f"{cfg.name}: {_NOT_YET[spec.mixer]}")
        if spec.ffn != "dense":
            raise NotImplementedError(f"{cfg.name}: {_NOT_YET[spec.ffn]}")


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Layer(nn.Module):
    """One pre-norm residual layer: attention mixer + dense FFN, with its
    window (0 = full) and rope theta."""

    def __init__(self, norm1, norm2, attn_params, mlp_params, window: int,
                 theta: float):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.attn = _frozen(attn_params)
        self.mlp = _frozen(mlp_params)
        self.window = int(window)
        self.theta = float(theta)


class Transformer(nn.Module):
    """The decoder's parameters: ``embed`` (``tok``, and ``head`` when the
    embeddings are not tied), ``final_norm`` and the ``layers``."""

    def __init__(self, embed_params, final_norm, layers):
        super().__init__()
        self.embed = _frozen(embed_params)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(layers)


# --------------------------------------------------------------------------
# Per-layer schedules (window, rope theta)
# --------------------------------------------------------------------------
def layer_schedules(cfg: ModelConfig):
    """Per layer: (windows, thetas) as two lists of length num_layers."""
    L, P = cfg.num_layers, cfg.layers_per_period
    win, theta = [], []
    for l in range(L):
        spec = cfg.pattern[l % P]
        if spec.mixer == "attention" and cfg.attention is not None:
            if cfg.window_pattern is not None:
                w = cfg.window_pattern[l % len(cfg.window_pattern)]
            else:
                w = cfg.attention.window
            if cfg.rope_theta_pattern is not None:
                th = cfg.rope_theta_pattern[l % len(cfg.rope_theta_pattern)]
            else:
                th = cfg.attention.rope_theta
        else:
            w, th = 0, 1.0
        win.append(w)
        theta.append(th)
    return win, theta


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def build(cfg: ModelConfig, embed_params, final_norm, layer_params):
    """The module from parameter tensors; ``layer_params`` holds one
    ``(norm1, norm2, attn, mlp)`` per layer."""
    check_supported(cfg)
    win, theta = layer_schedules(cfg)
    return Transformer(embed_params, final_norm,
                       [Layer(*p, w, th) for p, w, th in
                        zip(layer_params, win, theta)])


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device) -> Transformer:
    """Random parameters, drawn in order from ``gen`` (embeddings, then
    layer by layer), on ``device``; ``gen=None`` allocates uninitialised
    tensors (``device="meta"`` for shapes alone)."""
    check_supported(cfg)
    dtype = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    embed_params = init_embed(gen, cfg.vocab_size, D, dtype, device,
                              cfg.tie_embeddings)
    layers = [(zeros((D,), dtype, device), zeros((D,), dtype, device),
               attn.init_attention(gen, cfg.attention, D, dtype, device),
               init_mlp(gen, D, cfg.d_ff, dtype, device))
              for _ in range(cfg.num_layers)]
    return build(cfg, embed_params, zeros((D,), dtype, device), layers)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from shapes alone (no allocation)."""
    model = init_params(cfg, None, "meta")
    return sum(p.numel() for p in model.parameters())


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------
def _apply_layer(cfg: ModelConfig, layer: Layer, h, positions,
                 collect_cache: bool):
    y, (k, v) = attn.self_attention(
        cfg.attention, layer.attn, rmsnorm(h, layer.norm1, cfg.norm_eps),
        positions, layer.window, layer.theta, cfg.norm_eps)
    h = h + y
    h = h + mlp(layer.mlp, rmsnorm(h, layer.norm2, cfg.norm_eps), cfg.act)
    cache = ({"k": k.transpose(1, 2).contiguous(),
              "v": v.transpose(1, 2).contiguous()}
             if collect_cache else None)
    return h, cache


def forward_hidden(cfg: ModelConfig, model: Transformer, x, positions,
                   collect_cache: bool = False):
    """x: (B, S, D) embeddings -> (h, caches | None)."""
    caches = []
    h = x
    for layer in model.layers:
        h, c = _apply_layer(cfg, layer, h, positions, collect_cache)
        caches.append(c)
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    return h, (caches if collect_cache else None)


def prefill(cfg: ModelConfig, model: Transformer, tokens):
    """tokens (B, S) -> (last-token logits (B, V), cache at length S)."""
    x = embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    h, caches = forward_hidden(cfg, model, x, positions, collect_cache=True)
    logits = unembed_logits(model.embed, h[:, -1], cfg.tie_embeddings)
    return logits, {"layers": caches,
                    "len": torch.full((B,), S, dtype=torch.int32,
                                      device=x.device)}


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Empty decode cache sized for ``max_seq`` total positions."""
    check_supported(cfg)
    a = cfg.attention
    dtype = dtype_of(cfg.dtype)
    shape = (batch, a.num_kv_heads, max_seq, a.head_dim)
    return {"layers": [{"k": zeros(shape, dtype, device),
                        "v": zeros(shape, dtype, device)}
                       for _ in range(cfg.num_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_layer(cfg: ModelConfig, layer: Layer, c, h, new_len):
    hn = rmsnorm(h, layer.norm1, cfg.norm_eps)
    k, v = attn.decode_project_kv(cfg.attention, layer.attn, hn, new_len,
                                  layer.theta, cfg.norm_eps)
    y, ck, cv = attn.decode_attention_cp(
        cfg.attention, layer.attn, hn, c["k"], c["v"], k, v, new_len,
        layer.window, layer.theta, cfg.norm_eps)
    h = h + y
    h = h + mlp(layer.mlp, rmsnorm(h, layer.norm2, cfg.norm_eps), cfg.act)
    return h, {"k": ck, "v": cv}


def decode_step(cfg: ModelConfig, model: Transformer, cache, tokens):
    """tokens (B, 1) -> (logits (B, V), cache').  The cache's tensors are
    updated in place."""
    x = embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)
    new_len = cache["len"] + 1
    layers = []
    h = x
    for layer, c in zip(model.layers, cache["layers"]):
        h, c = _decode_layer(cfg, layer, c, h, new_len)
        layers.append(c)
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    logits = unembed_logits(model.embed, h[:, 0], cfg.tie_embeddings)
    return logits, {"layers": layers, "len": new_len}


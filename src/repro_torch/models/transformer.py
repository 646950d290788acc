"""Decoder-stack assembly: init / forward / loss / prefill / decode for
decoder-only stacks of attention, rwkv6 and mamba layers with dense, MoE or
rwkv FFNs.

The port of ``repro/models/transformer.py``.  The
reference stacks each pattern position's parameters over periods and runs
the stack under one ``lax.scan`` with the per-layer window and rope theta
as scan data; here the stack is an ``nn.ModuleList`` of :class:`Layer`
looped in Python, and each layer carries its window and theta as plain
numbers (:func:`layer_schedules`).

Encoder-decoder configs are :mod:`repro_torch.models.encdec`'s.

Training (:func:`loss_fn`) runs :func:`forward_hidden` in ``mode="train"``:
the MoE layers add their load-balancing loss, and under ``cfg.remat !=
"none"`` each layer runs under activation checkpointing (recomputed in the
backward, kernels included).  torch has no counterpart of the reference's
``"dots"`` policy (keep the matmul outputs, recompute the rest), so
``"dots"`` recomputes the whole layer as ``"full"`` does: the gradients are
the same, the memory lower and the work higher.  The parameters are built
frozen (``requires_grad=False``) for serving; the train step's
``init_state`` unfreezes them.

Cache: ``{"layers": [one dict per layer], "len": (B,) int32}``.  An
attention layer's entry is ``{"k", "v"}``, each (B, KV, Smax, hd)
(:mod:`repro_torch.models.attention`), written in place by decode; an
rwkv6 layer's is ``{"att_shift" (B, D), "ffn_shift" (B, D), "wkv" (B, H,
n, n) f32}`` (:mod:`repro_torch.models.rwkv6`), a mamba layer's ``{"conv"
(B, d_conv - 1, d_in), "ssm" (B, d_in, d_state) f32}``
(:mod:`repro_torch.models.mamba`), both replaced by decode.  A mamba
layer's prefill entry takes ``ssm`` from the scan's own final state (the
reference runs a second scan for it, ``_mamba_final_state``).  As in the
reference, decode runs the rwkv channel-mix with no shift state (its token
shift pads with zeros): ``ffn_shift`` is written, never read.

Under a mesh (:func:`repro_torch.sharding.specs.use_mesh`, the parameters
split into the rank's blocks by :mod:`repro_torch.sharding.layout`) the
functions take and return the rank's rows of the batch; the layers call
the collectives (:mod:`repro_torch.sharding.comm`); the MoE FFN takes
``moe_forward``'s paths (expert-parallel in training and prefill where
the ``model`` axis splits the experts); rwkv6 and mamba mixers run on the
rank's heads or channels (:mod:`.rwkv6`, :mod:`.mamba`); logits come back
whole over the vocabulary; the cache is the rank's block under
``CACHE_RULES`` (rows over ``batch``, positions over ``kvseq`` or kv
heads over ``kvheads``, rwkv6 states over ``heads``, mamba states over
``ffn``), its tensors carrying their spec.  Where ``seqcarry`` resolves,
the residual stream between training layers is split over its sequence
dim.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh

from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv6 as rwkv
from .layers import (chunked_xent, dtype_of, embed, init_embed, init_mlp,
                     mlp, rmsnorm, unembed_logits, zeros)

def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Layer(nn.Module):
    """One pre-norm residual layer of ``spec``: its norms, its parts (the
    reference's names: ``attn``, ``mamba`` or ``rwkv`` for the mixer,
    ``mlp``, ``moe`` or ``rwkvffn`` for the FFN, each a dict of tensors),
    its window (0 = full) and rope theta."""

    def __init__(self, spec: LayerSpec, norm1, norm2, parts: dict,
                 window: int, theta: float):
        super().__init__()
        self.mixer, self.ffn = spec.mixer, spec.ffn
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        for name, tensors in parts.items():
            setattr(self, name, _frozen(tensors))
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
def layer_spec(cfg: ModelConfig, l: int) -> LayerSpec:
    return cfg.pattern[l % cfg.layers_per_period]


def build(cfg: ModelConfig, embed_params, final_norm, layer_params):
    """The module from parameter tensors; ``layer_params`` holds one
    ``(norm1, norm2, parts)`` per layer (:class:`Layer`)."""
    win, theta = layer_schedules(cfg)
    return Transformer(embed_params, final_norm,
                       [Layer(layer_spec(cfg, l), *p, w, th) for l, (p, w, th)
                        in enumerate(zip(layer_params, win, theta))])


def _init_parts(cfg: ModelConfig, spec: LayerSpec, gen, dtype, device):
    D = cfg.d_model
    parts = {}
    if spec.mixer == "attention":
        parts["attn"] = attn.init_attention(gen, cfg.attention, D, dtype,
                                            device)
    elif spec.mixer == "mamba":
        parts["mamba"] = mam.init_mamba(gen, cfg.mamba, D, dtype, device)
    else:
        parts["rwkv"] = rwkv.init_rwkv6(gen, cfg.rwkv6, D, dtype, device)
    if spec.ffn == "dense":
        parts["mlp"] = init_mlp(gen, D, cfg.d_ff, dtype, device)
    elif spec.ffn == "moe":
        parts["moe"] = moe_mod.init_moe(gen, cfg.moe, D, dtype, device)
    else:
        parts["rwkvffn"] = rwkv.init_rwkv_ffn(gen, D, cfg.d_ff, dtype,
                                              device)
    return parts


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device) -> Transformer:
    """Random parameters, drawn in order from ``gen`` (embeddings, then
    layer by layer), on ``device``; ``gen=None`` allocates uninitialised
    tensors (``device="meta"`` for shapes alone)."""
    dtype = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    embed_params = init_embed(gen, cfg.vocab_size, D, dtype, device,
                              cfg.tie_embeddings)
    layers = [(zeros((D,), dtype, device), zeros((D,), dtype, device),
               _init_parts(cfg, layer_spec(cfg, l), gen, dtype, device))
              for l in range(cfg.num_layers)]
    return build(cfg, embed_params, zeros((D,), dtype, device), layers)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from shapes alone (no allocation)."""
    model = init_params(cfg, None, "meta")
    return sum(p.numel() for p in model.parameters())


# --------------------------------------------------------------------------
# Forward (train / prefill)
# --------------------------------------------------------------------------
def _kv_entry(cfg: ModelConfig, layer: Layer, k, v):
    """A prefill's k / v (B, S, KV, hd) as a cache entry (B, KV, S, hd);
    under a mesh the rank's block as the cache's rules split it at the
    prompt's length (:func:`repro_torch.sharding.layout.prefill_kv`)."""
    k, v = (t.transpose(1, 2).contiguous() for t in (k, v))
    if not comm.active():
        return {"k": k, "v": v}
    from repro_torch.sharding import layout
    return layout.prefill_kv(cfg, comm.split_axes(layer.attn["wk"], 1), k,
                             v)


def _tag_states(layer: Layer, cache: dict, like: dict | None = None) -> dict:
    """Under a mesh, an rwkv6 or mamba layer's states carrying the spec of
    the blocks they hold (those of ``like``, the entry a decode step
    read)."""
    if not comm.active() or layer.mixer == "attention":
        return cache
    from repro_torch.sharding import layout
    return layout.tag_states(layer, cache, like)


def _layer(cfg: ModelConfig, layer: Layer, h, positions, collect_cache: bool,
           train: bool):
    """One layer over the whole sequence; returns (h, the MoE aux loss (0.0
    outside training or a MoE FFN), cache entry | None)."""
    x_in = rmsnorm(h, layer.norm1, cfg.norm_eps)
    if layer.mixer == "attention":
        y, (k, v) = attn.self_attention(cfg.attention, layer.attn, x_in,
                                        positions, layer.window,
                                        layer.theta, cfg.norm_eps)
        cache = _kv_entry(cfg, layer, k, v) if collect_cache else {}
    elif layer.mixer == "mamba":
        y, cache = mam.mamba_forward(cfg.mamba, layer.mamba, x_in)
    else:
        y, (shift, S) = rwkv.rwkv6_forward(cfg.rwkv6, layer.rwkv, x_in,
                                           return_state=True)
        cache = {"att_shift": shift, "wkv": S}
    h = h + y
    hn = rmsnorm(h, layer.norm2, cfg.norm_eps)
    aux = 0.0
    if layer.ffn == "dense":
        h = h + mlp(layer.mlp, hn, cfg.act)
    elif layer.ffn == "moe":
        y, a = moe_mod.moe_forward(cfg.moe, layer.moe, hn, cfg.act,
                                   mode="train" if train else "prefill",
                                   with_aux=train)
        aux = a if train else aux
        h = h + y
    else:
        y, cache["ffn_shift"] = rwkv.rwkv_ffn_forward(layer.rwkvffn, hn,
                                                      return_state=True)
        h = h + y
    return h, aux, (_tag_states(layer, cache) if collect_cache else None)


def _apply_layer(cfg: ModelConfig, layer: Layer, h, positions,
                 collect_cache: bool):
    """One layer over the whole prompt; returns (h, cache entry | None)."""
    h, _, cache = _layer(cfg, layer, h, positions, collect_cache, False)
    return h, cache


def _train_layer(cfg: ModelConfig, layer: Layer, h, positions,
                 carry: tuple = ()):
    """One layer in training; returns (h, its MoE aux loss).  ``carry``:
    the axes that split the carried residual stream's sequence dim."""
    h = comm.gather(h, 1, carry)
    h, aux, _ = _layer(cfg, layer, h, positions, False, True)
    return comm.split(h, 1, carry), aux


def _carry_axes(x) -> tuple:
    """The axes of ``seqcarry`` that split the residual stream's
    sequence dim between training layers (none without a mesh)."""
    if not comm.active():
        return ()
    B, S, D = x.shape
    spec = sh.logical_to_spec((B * comm.axes_size(comm.batch_split()), S, D),
                              ("batch", "seqcarry", "dmodel"),
                              sh.current_mesh(), sh.current_rules())
    return comm.entry_axes(spec[1])


def forward_hidden(cfg: ModelConfig, model: Transformer, x, positions,
                   collect_cache: bool = False, mode: str = "prefill"):
    """x: (B, S, D) embeddings -> (h, caches | None), or in ``mode="train"``
    (h, the MoE aux losses summed over layers), each layer under activation
    checkpointing where ``cfg.remat`` is not ``"none"``."""
    h = x
    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        carry = _carry_axes(x)
        h = comm.split(h, 1, carry)
        for layer in model.layers:
            if cfg.remat != "none":
                h, a = checkpoint(_train_layer, cfg, layer, h, positions,
                                  carry, use_reentrant=False)
            else:
                h, a = _train_layer(cfg, layer, h, positions, carry)
            aux = aux + a
        h = comm.gather(h, 1, carry)
        return rmsnorm(h, model.final_norm, cfg.norm_eps), aux
    caches = []
    for layer in model.layers:
        h, c = _apply_layer(cfg, layer, h, positions, collect_cache)
        caches.append(c)
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    return h, (caches if collect_cache else None)


def embed_inputs(cfg: ModelConfig, model: Transformer, batch):
    """The input embeddings of ``batch``: the frames (cast to the compute
    dtype) for a frames model, else the tokens' embeddings."""
    if cfg.input_kind == "frames":
        return batch["frames"].to(dtype_of(cfg.dtype))
    return embed(model.embed, batch["tokens"], cfg.embed_scale, cfg.d_model)


def moe_layer_count(cfg: ModelConfig) -> int:
    return sum(1 for l in range(cfg.num_layers)
               if layer_spec(cfg, l).ffn == "moe")


def loss_fn(cfg: ModelConfig, model: Transformer, batch):
    """Next-token CE (+ the MoE aux loss).  batch: tokens (B, S), labels
    (B, S), optional mask (B, S).  Returns (total, {"ce", "aux"}): aux is
    the mean over the MoE layers, weighted into the total by
    ``router_aux_coef``."""
    x = embed_inputs(cfg, model, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    h, aux = forward_hidden(cfg, model, x, positions, mode="train")
    loss = chunked_xent(cfg, model.embed, h, batch["labels"],
                        batch.get("mask"))
    aux = aux / max(1, moe_layer_count(cfg))
    coef = cfg.moe.router_aux_coef if cfg.moe else 0.0
    return loss + coef * aux, {"ce": loss, "aux": aux}


def prefill(cfg: ModelConfig, model: Transformer, tokens):
    """tokens (B, S) -> (last-token logits (B, V), cache at length S)."""
    x = embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    h, caches = forward_hidden(cfg, model, x, positions, collect_cache=True)
    logits = unembed_logits(model.embed, h[:, -1], cfg.tie_embeddings)
    return logits, {"layers": caches, "len": prefill_len(B, S, x.device)}


def prefill_len(B: int, S: int, device):
    """``len`` after a prefill of S tokens of B rows (under a mesh the
    rank's rows: ``len`` is the global batch's, split as CACHE_RULES split
    it)."""
    if not comm.active():
        return torch.full((B,), S, dtype=torch.int32, device=device)
    from repro_torch.sharding import layout
    B *= comm.axes_size(comm.batch_split())
    spec = layout.len_spec(B)
    return layout.tagged(sh.shard_leaf(torch.full(
        (B,), S, dtype=torch.int32, device=device), spec,
        sh.current_mesh()), spec)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------
def cache_entry(cfg: ModelConfig, spec: LayerSpec, batch: int,
                max_seq: int, device):
    """The empty (global) cache entry of a layer of ``spec``."""
    dtype = dtype_of(cfg.dtype)
    if spec.mixer == "attention":
        a = cfg.attention
        shape = (batch, a.num_kv_heads, max_seq, a.head_dim)
        return {"k": zeros(shape, dtype, device),
                "v": zeros(shape, dtype, device)}
    if spec.mixer == "mamba":
        return mam.mamba_decode_init(cfg.mamba, cfg.d_model, batch, dtype,
                                     device)
    e = rwkv.rwkv6_decode_init(cfg.rwkv6, cfg.d_model, batch, dtype, device)
    if spec.ffn != "rwkv_ffn":
        del e["ffn_shift"]
    return e


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Empty decode cache sized for ``max_seq`` total positions; under a
    mesh the rank's blocks of it (``batch`` the global batch)."""
    if comm.active():
        from repro_torch.sharding import layout
        return layout.init_cache(cfg, batch, max_seq, device)
    return {"layers": [cache_entry(cfg, layer_spec(cfg, l), batch, max_seq,
                                   device)
                       for l in range(cfg.num_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_layer(cfg: ModelConfig, layer: Layer, c, h, new_len):
    read = c
    hn = rmsnorm(h, layer.norm1, cfg.norm_eps)
    if layer.mixer == "attention":
        k, v = attn.decode_project_kv(cfg.attention, layer.attn, hn, new_len,
                                      layer.theta, cfg.norm_eps)
        y, ck, cv = attn.decode_attention_cp(
            cfg.attention, layer.attn, hn, c["k"], c["v"], k, v, new_len,
            layer.window, layer.theta, cfg.norm_eps)
        c = dict(c, k=ck, v=cv)
    elif layer.mixer == "mamba":
        y, c = mam.mamba_decode_step(cfg.mamba, layer.mamba, hn, c)
    else:
        y, (shift, S) = rwkv.rwkv6_forward(
            cfg.rwkv6, layer.rwkv, hn, shift_state=c["att_shift"],
            wkv_state=c["wkv"], return_state=True)
        c = dict(c, att_shift=shift, wkv=S)
    h = h + y
    hn = rmsnorm(h, layer.norm2, cfg.norm_eps)
    if layer.ffn == "dense":
        h = h + mlp(layer.mlp, hn, cfg.act)
    elif layer.ffn == "moe":
        h = h + moe_mod.moe_decode(cfg.moe, layer.moe, hn, cfg.act)
    else:
        # no shift state, as the reference (transformer.py, _decode_layer)
        y, c["ffn_shift"] = rwkv.rwkv_ffn_forward(layer.rwkvffn, hn,
                                                  return_state=True)
        h = h + y
    return h, _tag_states(layer, c, read)


def len_rows(cache, new_len):
    """The lengths of the rows this rank's k / v hold: under a mesh
    ``len`` may be whole (CACHE_RULES leave the root ``len`` replicated)
    while the k / v split their rows over ``batch``."""
    if not comm.active():
        return new_len
    rows = comm.spec_of(next(iter(cache["layers"][0].values())))[0]
    have = (comm.spec_of(cache["len"]) or (None,))[0]
    if have == rows:
        return new_len
    if have is not None:
        raise NotImplementedError(f"len split over {have!r}, k / v rows "
                                  f"over {rows!r}")
    return comm.local_rows(new_len, comm.entry_axes(rows))


def decode_step(cfg: ModelConfig, model: Transformer, cache, tokens):
    """tokens (B, 1) -> (logits (B, V), cache').  The cache's tensors are
    updated in place."""
    x = embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)
    new_len = cache["len"] + 1
    if hasattr(cache["len"], comm.SPEC):
        setattr(new_len, comm.SPEC, getattr(cache["len"], comm.SPEC))
    rows_len = len_rows(cache, new_len)
    layers = []
    h = x
    for layer, c in zip(model.layers, cache["layers"]):
        h, c = _decode_layer(cfg, layer, c, h, rows_len)
        layers.append(c)
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    logits = unembed_logits(model.embed, h[:, 0], cfg.tie_embeddings)
    return logits, {"layers": layers, "len": new_len}


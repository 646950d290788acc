"""Encoder-decoder backbone (whisper-large-v3).

The port of ``repro/models/encdec.py``.  As in the reference, the conv / mel
front end is not modelled: ``frames`` are precomputed frame embeddings (B,
S_enc, D) (``configs/inputs.py``), and both stacks take sinusoidal
positions.  The reference stacks each layer's parameters over the layers
and runs a ``lax.scan``; here :class:`EncDec` holds one module a layer,
looped in Python, each with the reference's parts (``ln1``, ``attn``,
``ln2``, ``mlp`` in the encoder; ``ln1``, ``self_attn``, ``ln_x``,
``cross_attn``, ``ln2``, ``mlp`` in the decoder), each a dict of tensors.

On the card the encoder's self-attention (non-causal, rope-free) and the
decoder's prefill self-attention (causal) launch K5 through
:func:`repro_torch.models.attention.self_attention`; LayerNorm, the GELU
MLPs, cross-attention and decode are plain tensor code, as in the
reference.

Cache: ``{"layers": [one dict per decoder layer], "len": (B,) int32}``,
each entry ``{"k", "v"}`` (B, KV, Smax, hd), written in place by decode,
and ``{"enc_k", "enc_v"}`` (B, KV, S_enc, hd), the cross-attention's
projection of the encoder's output, read only.
:mod:`repro_torch.models.convert` maps it to the reference's stacked
``{"k", "v", "enc_kv", "len"}``.

Under a mesh (:func:`repro_torch.sharding.specs.use_mesh`, the parameters
cut by :func:`repro_torch.sharding.layout.shard_model`) the functions take
and return the rank's rows of the batch.  Self- and cross-attention split
their heads over ``heads`` / ``kvheads`` where the axis divides them and
otherwise keep them whole on every rank (whisper's 20 heads on a 16-way
axis); the MLPs are column-parallel in (``b_in`` split) and row-parallel
out, ``b_out`` added after the sum; the LayerNorms are replicated and the
logits come back whole over the vocabulary.  The cache is the rank's
block: ``k`` / ``v`` as a decoder-only stack's (decode through the mesh
branch of ``decode_attention_cp``), ``enc_k`` / ``enc_v`` over the kv heads
the cross-attention's ``wk`` holds.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import comm

from . import attention as attn
from .layers import (chunked_xent, dtype_of, embed, init_embed,
                     init_mlp_nogate, layernorm, mlp_nogate, ones,
                     unembed_logits, zeros)
from .transformer import len_rows, prefill_len


def _frozen(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer: each of ``parts`` (name -> dict of tensors) as a
    ``ParameterDict`` attribute of that name."""

    def __init__(self, parts: dict):
        super().__init__()
        self.part_names = tuple(parts)
        for name, tensors in parts.items():
            setattr(self, name, _frozen(tensors))


class EncDec(nn.Module):
    """``embed`` (``tok``; ``head`` when untied), the ``encoder`` and
    ``decoder`` stacks of :class:`Block`, ``enc_norm`` and ``dec_norm``
    (``w``, ``b``)."""

    def __init__(self, embed_params, encoder, enc_norm, decoder, dec_norm):
        super().__init__()
        self.embed = _frozen(embed_params)
        self.encoder = nn.ModuleList(Block(p) for p in encoder)
        self.enc_norm = _frozen(enc_norm)
        self.decoder = nn.ModuleList(Block(p) for p in decoder)
        self.dec_norm = _frozen(dec_norm)


def _ln(p, x, eps: float = 1e-5):
    return layernorm(x, p["w"], p["b"], eps)


def sinusoidal(positions, d_model: int):
    """positions (S,) or (B, S) -> (..., d_model) f32."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def _ln_init(d, dtype, device):
    return {"w": ones((d,), dtype, device), "b": zeros((d,), dtype, device)}


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device) -> EncDec:
    """Random parameters drawn in order from ``gen`` (embeddings, the
    encoder layer by layer, then the decoder), on ``device``; ``gen=None``
    allocates uninitialised tensors (``device="meta"`` for shapes
    alone)."""
    dtype = dtype_of(cfg.param_dtype)
    D, a = cfg.d_model, cfg.attention
    embed_params = init_embed(gen, cfg.vocab_size, D, dtype, device,
                              cfg.tie_embeddings)
    att = lambda: attn.init_attention(gen, a, D, dtype, device)
    mlp = lambda: init_mlp_nogate(gen, D, cfg.d_ff, dtype, device)
    ln = lambda: _ln_init(D, dtype, device)
    encoder = [{"ln1": ln(), "attn": att(), "ln2": ln(), "mlp": mlp()}
               for _ in range(cfg.encoder_layers)]
    decoder = [{"ln1": ln(), "self_attn": att(), "ln_x": ln(),
                "cross_attn": att(), "ln2": ln(), "mlp": mlp()}
               for _ in range(cfg.num_layers)]
    return EncDec(embed_params, encoder, ln(), decoder, ln())


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from shapes alone (no allocation)."""
    return sum(p.numel() for p in init_params(cfg, None, "meta").parameters())


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------
def _enc_layer(cfg: ModelConfig, p: Block, h, pos):
    enc_acfg = dataclasses.replace(cfg.attention, causal=False,
                                   use_rope=False)
    y, _ = attn.self_attention(enc_acfg, p.attn, _ln(p.ln1, h), pos, 0, 1.0,
                               cfg.norm_eps)
    h = h + y
    return h + mlp_nogate(p.mlp, _ln(p.ln2, h), "gelu")


def _remat(cfg: ModelConfig, train: bool) -> bool:
    return train and cfg.remat != "none"


def encode(cfg: ModelConfig, model: EncDec, frames, train: bool = False):
    """frames (B, S_enc, D) -> (B, S_enc, D).  In training (``train``) each
    layer runs under activation checkpointing where ``cfg.remat`` is not
    ``"none"``."""
    S, D = frames.shape[1], frames.shape[2]
    pos = torch.arange(S, device=frames.device)
    h = frames + sinusoidal(pos, D).to(frames.dtype)
    for p in model.encoder:
        if _remat(cfg, train):
            h = checkpoint(_enc_layer, cfg, p, h, pos, use_reentrant=False)
        else:
            h = _enc_layer(cfg, p, h, pos)
    return _ln(model.enc_norm, h)


def project_enc_kv_stack(cfg: ModelConfig, model: EncDec, enc_out):
    """Per decoder layer, the cross-attention's (k, v) of ``enc_out``;
    under a mesh each carrying the spec of its block (the rank's rows and
    kv heads)."""
    kvs = [attn.project_enc_kv(cfg.attention, p.cross_attn, enc_out)
           for p in model.decoder]
    if comm.active():
        from repro_torch.sharding import layout
        for p, kv in zip(model.decoder, kvs):
            spec = (layout.entry(comm.batch_split()), layout.entry(
                comm.split_axes(p.cross_attn["wk"], 1)), None, None)
            for t in kv:
                layout.tagged(t, spec)
    return kvs


# --------------------------------------------------------------------------
# Decoder (teacher-forced: training and prefill)
# --------------------------------------------------------------------------
def _embed_tokens(cfg: ModelConfig, model: EncDec, tokens, pos):
    x = embed(model.embed, tokens, cfg.embed_scale, cfg.d_model)
    return x + sinusoidal(pos, cfg.d_model).to(x.dtype)


def _dec_layer(cfg: ModelConfig, p: Block, h, pos, ekv):
    """One decoder layer over the whole sequence: (h, (k, v) of its
    self-attention, each (B, S, KV, hd))."""
    y, kv = attn.self_attention(cfg.attention, p.self_attn, _ln(p.ln1, h),
                                pos, 0, 1.0, cfg.norm_eps)
    h = h + y
    h = h + attn.cross_attention(cfg.attention, p.cross_attn,
                                 _ln(p.ln_x, h), ekv, cfg.norm_eps)
    return h + mlp_nogate(p.mlp, _ln(p.ln2, h), "gelu"), kv


def decode_train(cfg: ModelConfig, model: EncDec, tokens, enc_out,
                 train: bool = False):
    """Teacher-forced decoder: tokens (B, S) over ``enc_out`` -> the final
    hidden states (B, S, D)."""
    pos = torch.arange(tokens.shape[1], device=enc_out.device)
    h = _embed_tokens(cfg, model, tokens, pos)
    for p, ekv in zip(model.decoder,
                      project_enc_kv_stack(cfg, model, enc_out)):
        if _remat(cfg, train):
            h, _ = checkpoint(_dec_layer, cfg, p, h, pos, ekv,
                              use_reentrant=False)
        else:
            h, _ = _dec_layer(cfg, p, h, pos, ekv)
    return _ln(model.dec_norm, h)


def loss_fn(cfg: ModelConfig, model: EncDec, batch):
    """Next-token CE of the decoder over the encoded frames.  batch: frames
    (B, S_enc, D), tokens (B, S), labels (B, S), optional mask (B, S).
    Returns (loss, {"ce", "aux" = 0})."""
    enc_out = encode(cfg, model, batch["frames"].to(dtype_of(cfg.dtype)),
                     train=True)
    h = decode_train(cfg, model, batch["tokens"], enc_out, train=True)
    loss = chunked_xent(cfg, model.embed, h, batch["labels"],
                        batch.get("mask"))
    return loss, {"ce": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=loss.device)}


# --------------------------------------------------------------------------
# Prefill / decode
# --------------------------------------------------------------------------
def prefill(cfg: ModelConfig, model: EncDec, tokens, frames):
    """tokens (B, S), frames (B, S_enc, D) -> (last-token logits (B, V),
    cache at length S)."""
    enc_out = encode(cfg, model, frames.to(dtype_of(cfg.dtype)))
    enc_kv = project_enc_kv_stack(cfg, model, enc_out)
    B, S = tokens.shape
    pos = torch.arange(S, device=enc_out.device)
    h = _embed_tokens(cfg, model, tokens, pos)
    layers = []
    for p, (ek, ev) in zip(model.decoder, enc_kv):
        h, (k, v) = _dec_layer(cfg, p, h, pos, (ek, ev))
        k, v = (t.transpose(1, 2).contiguous() for t in (k, v))
        if comm.active():
            from repro_torch.sharding import layout
            kv = layout.prefill_kv(cfg, comm.split_axes(
                p.self_attn["wk"], 1), k, v)
        else:
            kv = {"k": k, "v": v}
        layers.append({**kv, "enc_k": ek, "enc_v": ev})
    h = _ln(model.dec_norm, h)
    logits = unembed_logits(model.embed, h[:, -1], cfg.tie_embeddings)
    return logits, {"layers": layers, "len": prefill_len(B, S, h.device)}


def cache_entry(cfg: ModelConfig, batch: int, max_seq: int, device):
    """One decoder layer's empty (global) cache entry: ``max_seq``
    self-attention slots and the cross-attention's ``encoder_seq``
    positions."""
    dtype = dtype_of(cfg.dtype)
    a = cfg.attention
    kv = (batch, a.num_kv_heads, max_seq, a.head_dim)
    enc = (batch, a.num_kv_heads, cfg.encoder_seq, a.head_dim)
    return {"k": zeros(kv, dtype, device), "v": zeros(kv, dtype, device),
            "enc_k": zeros(enc, dtype, device),
            "enc_v": zeros(enc, dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Empty decode cache (:func:`cache_entry` per decoder layer); under a
    mesh the rank's blocks of it (``batch`` the global batch)."""
    if comm.active():
        from repro_torch.sharding import layout
        return layout.init_cache(cfg, batch, max_seq, device)
    return {"layers": [cache_entry(cfg, batch, max_seq, device)
                       for _ in range(cfg.num_layers)],
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ModelConfig, model: EncDec, cache, tokens):
    """tokens (B, 1) -> (logits (B, V), cache').  The self-attention cache
    is updated in place."""
    new_len = cache["len"] + 1
    if hasattr(cache["len"], comm.SPEC):
        setattr(new_len, comm.SPEC, getattr(cache["len"], comm.SPEC))
    rows_len = len_rows(cache, new_len)
    h = _embed_tokens(cfg, model, tokens, (rows_len - 1)[:, None])
    acfg = cfg.attention
    layers = []
    for p, c in zip(model.decoder, cache["layers"]):
        hn = _ln(p.ln1, h)
        k, v = attn.decode_project_kv(acfg, p.self_attn, hn, rows_len, 1.0,
                                      cfg.norm_eps)
        y, ck, cv = attn.decode_attention_cp(acfg, p.self_attn, hn, c["k"],
                                             c["v"], k, v, rows_len, 0, 1.0,
                                             cfg.norm_eps)
        h = h + y
        h = h + attn.cross_attention(acfg, p.cross_attn, _ln(p.ln_x, h),
                                     (c["enc_k"], c["enc_v"]), cfg.norm_eps)
        h = h + mlp_nogate(p.mlp, _ln(p.ln2, h), "gelu")
        layers.append(dict(c, k=ck, v=cv))
    h = _ln(model.dec_norm, h)
    logits = unembed_logits(model.embed, h[:, 0], cfg.tie_embeddings)
    return logits, {"layers": layers, "len": new_len}

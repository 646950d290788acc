"""Shared building blocks: inits, norms, rotary embeddings, embeddings,
the chunked cross-entropy and the gated FFN.

The port of ``repro/models/layers.py``: the same functions over dicts of
tensors, in the reference's layouts and dtypes.
Inits draw from an explicit ``torch.Generator`` (not JAX's keys: the two
give different numbers from one seed; the tests carry JAX's parameters over
with :func:`repro_torch.models.convert.params_from_numpy`).

Under a mesh (:func:`repro_torch.sharding.specs.use_mesh`) each rank holds
its blocks of the weights and calls the collectives that the reference's
sharding annotations make GSPMD insert (:mod:`repro_torch.sharding.comm`):
the embedding and the tied unembedding split over ``vocab`` (a masked
lookup and a sum; the loss's log-softmax by a max and a sum over the
shards), the FFN column-parallel in and row-parallel out over ``ffn``,
FSDP weights gathered before use, and the loss's sums combined over the
batch's axes.  Without a mesh every collective is the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rmsnorm import rmsnorm as kernel_rmsnorm
from repro_torch.sharding import comm


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
    # scaled in place: one f32 tensor alive beside the cast, not two (an
    # expert stack of jamba is 12.9 GB in f32)
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(std)
    return x.to(device=device, dtype=dtype)


def fan_in_init(gen, shape, dtype, device, fan_axis: int = -2):
    """Scaled init: std = 1/sqrt(fan_in)."""
    fan_in = shape[fan_axis] if len(shape) > 1 else shape[0]
    return normal(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype, device)


def zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm in f32 (returned in x's dtype), through K8 on the card."""
    return kernel_rmsnorm(x.contiguous(), w, eps)


def layernorm(x, w, b, eps: float = 1e-5):
    """LayerNorm in f32 (returned in x's dtype): plain tensor code, as the
    reference computes it outside any kernel."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


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


def _vocab_block(tok):
    """(the axes that split the vocabulary of ``tok``, the first id of
    this rank's block)."""
    axes = comm.split_axes(tok, 0)
    if not axes:
        return (), 0
    return axes, comm.axes_index(axes) * tok.shape[0]


def embed(params, tokens, scale: bool, d_model: int):
    tok = params["tok"]
    vocab, lo = _vocab_block(tok)
    w = comm.weight(tok)
    if vocab:
        # vocab-parallel: this rank's rows, zeros elsewhere, summed
        local = tokens - lo
        mine = ((local >= 0) & (local < w.shape[0]))[..., None]
        x = torch.where(mine, w[local.clamp(0, w.shape[0] - 1)], 0.0)
        x = comm.reduce(x.to(w.dtype), vocab)
    else:
        x = w[tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _local_logits(params, x, tie: bool):
    """(this rank's block of the logits, the axes that split the
    vocabulary, the block's first id)."""
    if not tie:
        return x @ comm.weight(params["head"]), (), 0
    vocab, lo = _vocab_block(params["tok"])
    return comm.copy(x, vocab) @ comm.weight(params["tok"]).t(), vocab, lo


def unembed_logits(params, x, tie: bool):
    logits, vocab, _ = _local_logits(params, x, tie)
    return comm.gather(logits, logits.ndim - 1, vocab)


# --------------------------------------------------------------------------
# Chunked softmax cross-entropy.  The full (B, S, V) logits of e.g.
# llama3.2-1b (V = 128 256) at 4 x 2048 tokens are 4.2 GB in f32; a loop
# over sequence chunks under activation checkpointing keeps one chunk's
# logits alive at a time, in the forward and in the backward.
# --------------------------------------------------------------------------
def _nll(logits, labels, vocab=(), lo=0):
    """Per-position negative log-likelihood in f32; logits (..., V),
    labels (...) integer.  With ``vocab`` axes the logits are this rank's
    block of the vocabulary, from id ``lo``: the log-softmax combines the
    blocks by a max and a sum over the axes."""
    lf = logits.float()
    if not vocab:
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return torch.logsumexp(lf, dim=-1) - gold
    m = comm.all_reduce_max(lf.max(dim=-1, keepdim=True).values, vocab)
    lse = torch.log(comm.reduce(torch.exp(lf - m).sum(-1), vocab)) \
        + m[..., 0]
    local = labels.long() - lo
    mine = (local >= 0) & (local < lf.shape[-1])
    gold = torch.gather(lf, -1, local.clamp(0, lf.shape[-1] - 1)[..., None])
    gold = comm.reduce(torch.where(mine, gold[..., 0], 0.0), vocab)
    return lse - gold


def _batch_mean(tot, cnt):
    """The loss over the global batch: ``tot / max(cnt, 1)`` with both
    sums combined over the batch's axes under a mesh."""
    axes = comm.batch_reduce()
    if axes:
        tot = comm.reduce(tot, axes)
        cnt = comm.all_reduce_raw(cnt, axes)
    return tot / torch.clamp_min(cnt, 1.0)


def softmax_xent(logits, labels, mask=None, vocab=(), lo=0):
    """Stable CE in f32; logits (..., V), labels (...) integer, mask (...)
    or None: the mean over the positions (the masked mean with a mask)."""
    nll = _nll(logits, labels, vocab, lo)
    if mask is not None:
        nll = nll * mask
        return _batch_mean(torch.sum(nll), torch.sum(mask))
    if comm.batch_reduce():
        return _batch_mean(torch.sum(nll), torch.tensor(
            float(nll.numel()), device=nll.device))
    return torch.mean(nll)


def _chunk_nll(embed_params, tie, x, labels, mask):
    """(sum of the chunk's masked nll, sum of its mask)."""
    logits, vocab, lo = _local_logits(embed_params, x, tie)
    nll = _nll(logits, labels, vocab, lo) * mask
    return torch.sum(nll), torch.sum(mask)


def chunked_xent(cfg, embed_params, x, labels, mask=None):
    """embed -> logits -> CE without materializing (B, S, V): x (B, S, D)
    final hidden states, labels (B, S), mask (B, S) or None.  Each sequence
    chunk of ``cfg.logit_chunk`` positions runs under activation
    checkpointing, as the reference runs its chunk under
    ``jax.checkpoint``: its logits are recomputed in the backward, never
    kept.  Unchunked where ``logit_chunk`` is 0 or does not divide S.
    Under a mesh the logits stay split over the vocabulary."""
    B, S, D = x.shape
    chunk = cfg.logit_chunk
    if chunk <= 0 or S <= chunk or S % chunk != 0:
        logits, vocab, lo = _local_logits(embed_params, x,
                                          cfg.tie_embeddings)
        return softmax_xent(logits, labels, mask, vocab, lo)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        c = slice(s0, s0 + chunk)
        t, n = checkpoint(_chunk_nll, embed_params, cfg.tie_embeddings,
                          x[:, c], labels[:, c], mask[:, c],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return _batch_mean(tot, cnt)


# --------------------------------------------------------------------------
# Dense (SwiGLU / GeGLU) FFN
# --------------------------------------------------------------------------
def init_mlp(gen, d_model, d_ff, dtype, device):
    return {"w_gate": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_in": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "w_out": fan_in_init(gen, (d_ff, d_model), dtype, device)}


def mlp(params, x, act: str):
    """Column-parallel in, row-parallel out where ``ffn`` splits the
    hidden dim."""
    ffn = comm.split_axes(params["w_gate"], 1)
    x = comm.copy(x, ffn)
    h = x @ comm.weight(params["w_gate"])
    u = x @ comm.weight(params["w_in"])
    return comm.reduce((act_fn(act)(h) * u) @ comm.weight(params["w_out"]),
                       ffn)


# --------------------------------------------------------------------------
# Whisper-style GELU MLP (no gate), for the encoder-decoder stacks
# --------------------------------------------------------------------------
def init_mlp_nogate(gen, d_model, d_ff, dtype, device):
    return {"w_in": fan_in_init(gen, (d_model, d_ff), dtype, device),
            "b_in": zeros((d_ff,), dtype, device),
            "w_out": fan_in_init(gen, (d_ff, d_model), dtype, device),
            "b_out": zeros((d_model,), dtype, device)}


def mlp_nogate(params, x, act: str = "gelu"):
    """Column-parallel in (``b_in`` split alike), row-parallel out where
    ``ffn`` splits the hidden dim; ``b_out`` added after the sum."""
    ffn = comm.split_axes(params["w_in"], 1)
    h = comm.copy(x, ffn) @ comm.weight(params["w_in"]) + params["b_in"]
    y = comm.reduce(act_fn(act)(h) @ comm.weight(params["w_out"]), ffn)
    return y + params["b_out"]

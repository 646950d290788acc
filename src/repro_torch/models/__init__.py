"""Model zoo of the PyTorch port: the API of ``repro.models`` over
decoder-only stacks (dense, MoE, hybrid attention + mamba, rwkv6) and the
encoder-decoder stack (whisper).

    init_params(cfg, generator=None, device=None) -> Transformer | EncDec
    loss_fn(cfg, params, batch)       -> (loss, {"ce", "aux"})  [train_step]
    prefill(cfg, params, batch)       -> (logits, cache)     [prefill_step]
                                         (batch: tokens, and frames for
                                          an encoder-decoder)
    decode_step(cfg, params, cache, tokens) -> (logits, cache')  [serve_step]
    init_cache(cfg, batch, max_seq, device=None) -> empty decode cache
    param_count(cfg)                  -> exact N (no allocation)
    active_param_count(cfg)           -> per-token N (MoE: top_k experts)

``device=None`` is the card (``RuntimeError`` without one); pass
``device="cpu"`` for the plain versions, as the tests do.  ``prefill`` and
``decode_step`` run where the parameters are.  On the card, prefill
attention launches K5, every rwkv6 time-mix K6 (prefill and decode), every
mamba mixer K7 in prefill and training, and every RMSNorm K8 (a mamba
mixer's own included); MoE experts are plain batched matmuls.  Under
autograd (``loss_fn`` on unfrozen parameters, as the train step has them)
each kernel's backward is tensor code beside it.  An encoder-decoder's
encoder self-attention and its decoder's prefill self-attention launch K5
(:mod:`repro_torch.models.encdec`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import encdec, transformer


def family(cfg: ModelConfig):
    """The module that builds and runs ``cfg``: :mod:`.encdec` for an
    encoder-decoder, else :mod:`.transformer`."""
    return encdec if cfg.is_encoder_decoder else transformer


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None):
    """Random parameters on ``device``, drawn from ``generator`` (default:
    a generator on ``device`` seeded with 0; none on the meta device, which
    holds shapes only)."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    return family(cfg).init_params(cfg, generator, device)


def device_of(params) -> torch.device:
    """Where the model's parameters are."""
    return next(params.parameters()).device


def prefill(cfg: ModelConfig, params, batch):
    dev = device_of(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    if cfg.is_encoder_decoder:
        return encdec.prefill(cfg, params, tokens,
                              torch.as_tensor(batch["frames"], device=dev))
    return transformer.prefill(cfg, params, tokens)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    tokens = torch.as_tensor(tokens, device=device_of(params))
    return family(cfg).decode_step(cfg, params, cache, tokens)


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token CE (+ MoE aux) of ``batch`` (tokens, labels, optional
    mask; frames for an encoder-decoder) where the parameters are: (total,
    {"ce", "aux"})."""
    dev = device_of(params)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return family(cfg).loss_fn(cfg, params, batch)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return family(cfg).init_cache(cfg, batch, max_seq,
                                  resolve_device(device))


def param_count(cfg: ModelConfig) -> int:
    return family(cfg).param_count(cfg)


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active params: total minus the non-selected experts."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff
    inactive = transformer.moe_layer_count(cfg) * (m.num_experts - m.top_k) \
        * per_expert
    return total - inactive


__all__ = ["init_params", "loss_fn", "prefill", "decode_step", "init_cache",
           "param_count", "active_param_count", "device_of", "family",
           "transformer", "encdec"]

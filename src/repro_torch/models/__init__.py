"""Model zoo of the PyTorch port: the serving API of ``repro.models`` for
decoder-only stacks of attention and rwkv6 layers (dense or rwkv FFNs).

    init_params(cfg, generator=None, device=None) -> Transformer (nn.Module)
    prefill(cfg, params, batch)       -> (logits, cache)     [prefill_step]
    decode_step(cfg, params, cache, tokens) -> (logits, cache')  [serve_step]
    init_cache(cfg, batch, max_seq, device=None) -> empty decode cache
    param_count(cfg)                  -> exact N (no allocation)

``device=None`` is the card (``RuntimeError`` without one); pass
``device="cpu"`` for the plain versions, as the tests do.  ``prefill`` and
``decode_step`` run where the parameters are.  On the card, prefill
attention launches K5, every rwkv6 time-mix K6 (prefill and decode) and
every RMSNorm K8.  ``loss_fn`` waits for the training slice; configs with
mamba, MoE or encoder-decoder layers raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import transformer


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> transformer.Transformer:
    """Random parameters on ``device``, drawn from ``generator`` (default:
    a generator on ``device`` seeded with 0)."""
    device = resolve_device(device)
    transformer.check_supported(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return transformer.init_params(cfg, generator, device)


def _device_of(params) -> torch.device:
    return params.final_norm.device


def prefill(cfg: ModelConfig, params, batch):
    tokens = torch.as_tensor(batch["tokens"], device=_device_of(params))
    return transformer.prefill(cfg, params, tokens)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    tokens = torch.as_tensor(tokens, device=_device_of(params))
    return transformer.decode_step(cfg, params, cache, tokens)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return transformer.init_cache(cfg, batch, max_seq,
                                  resolve_device(device))


def param_count(cfg: ModelConfig) -> int:
    return transformer.param_count(cfg)


__all__ = ["init_params", "prefill", "decode_step", "init_cache",
           "param_count", "transformer"]

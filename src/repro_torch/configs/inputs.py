"""Shape stand-ins for every model input, and a small concrete batch.

The port of ``repro/configs/inputs.py``.  Where the reference gives
``jax.ShapeDtypeStruct`` leaves (the dry-run pattern), the port gives
``(shape, dtype)`` pairs with torch dtypes; the decode cache's come from
the port's own cache layout (:func:`repro_torch.models.init_cache` on the
meta device, which allocates nothing).
"""

from __future__ import annotations

import torch

from .base import ModelConfig, ShapeConfig


def _spec(t):
    """A tree of tensors as a tree of (shape, dtype) pairs."""
    if isinstance(t, dict):
        return {k: _spec(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_spec(v) for v in t)
    return tuple(t.shape), t.dtype


def train_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": ((B, S), torch.int32),
             "labels": ((B, S), torch.int32)}
    if cfg.input_kind == "frames":
        batch["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return batch


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": ((B, S), torch.int32)}
    if cfg.input_kind == "frames":
        batch["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    return batch


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache, tokens) for a decode step: the cache of seq_len positions,
    one new token."""
    from repro_torch.models import transformer
    B, S = shape.global_batch, shape.seq_len
    cache = _spec(transformer.init_cache(cfg, B, S, "meta"))
    return cache, ((B, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Inputs for the step function this shape exercises."""
    if shape.step == "train":
        return (train_inputs(cfg, shape),)
    if shape.step == "prefill":
        return (prefill_inputs(cfg, shape),)
    if shape.step == "decode":
        return decode_inputs(cfg, shape)
    raise ValueError(shape.step)


def concrete_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
                   generator: torch.Generator, device=None):
    """A small concrete batch drawn from ``generator`` (on its device), on
    ``device`` (default: the generator's): tokens uniform in [0, V),
    labels the tokens shifted left by one (wrapping)."""
    device = generator.device if device is None else device
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                           generator=generator, device=generator.device,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.input_kind == "frames":
        batch["frames"] = torch.randn(
            (batch_size, cfg.encoder_seq, cfg.d_model), generator=generator,
            device=generator.device).to(torch.bfloat16)
    return {k: v.to(device) for k, v in batch.items()}

"""Where the port runs: every entry point takes ``device=None`` for the
card.

The simulator's sweeps split their config axis over the **shard devices**
(:func:`shard_devices`): with ``device=None`` every visible CUDA card, one
shard each; with ``device="cuda:k"`` that card; with ``device="cpu"`` one
CPU "device".  Each CUDA shard queues its work on a stream of its own.

:data:`ENV_SHARDS` (``REPRO_TORCH_SHARDS=N``, read at call time) forces N
shards, the counterpart of XLA's ``--xla_force_host_platform_device_count``:
on the CPU, N copies of the CPU device; on CUDA, N shards placed round-robin
over the cards, each on its own stream, so that one card runs N shards.  It
is the only way to get more shards than cards.
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass

import torch

#: Environment variable forcing the shard count of a config-axis split.
ENV_SHARDS = "REPRO_TORCH_SHARDS"


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA device without CUDA raises — no
    entry point quietly continues on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


@dataclass(frozen=True)
class Shard:
    """One block of a config-axis split: its device and, on CUDA, the
    stream its work is queued on (``None``: the device's current
    stream)."""

    device: torch.device
    stream: torch.cuda.Stream | None = None

    def scope(self):
        """A context that makes this shard's device and stream current
        (nothing to switch on the CPU or without a stream of its own)."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack


def shard_count(device=None) -> int:
    """How many shards a split over ``device`` has: :data:`ENV_SHARDS` if
    set, else the visible cards for ``None`` / ``"cuda"`` (0 without
    CUDA) and 1 for one named device.  Resolves nothing and never
    raises on a host without CUDA."""
    forced = os.environ.get(ENV_SHARDS)
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(f"{ENV_SHARDS}={forced!r}: need at least 1")
        return n
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.cuda.device_count()
    return 1


def splits(shard: bool | None, device=None) -> bool:
    """Whether a run over ``device`` splits its config axis: ``shard`` if
    given, else iff there is more than one shard."""
    return bool(shard) if shard is not None else shard_count(device) > 1


@functools.lru_cache(maxsize=None)
def _streams(index: int, n: int) -> tuple:
    """``n`` streams of card ``index``, made once a process, so that the
    caching allocator reuses each shard's blocks across calls."""
    return tuple(torch.cuda.Stream(torch.device("cuda", index))
                 for _ in range(n))


def shard_devices(device=None) -> list[Shard]:
    """The shards a config-axis split over ``device`` runs on, in order
    (:func:`shard_count` of them; see the module docstring).  Raises
    where :func:`resolve_device` does."""
    device = resolve_device(device)
    n = shard_count(device)
    if device.type != "cuda":
        return [Shard(device)] * n
    cards = ([device.index] if device.index is not None
             else list(range(torch.cuda.device_count())))
    per_card = -(-n // len(cards))
    return [Shard(torch.device("cuda", cards[i % len(cards)]),
                  _streams(cards[i % len(cards)], per_card)[
                      i // len(cards)])
            for i in range(n)]

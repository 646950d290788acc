"""Slot-based decode engine: prefill → KV-resident standby → active decode.

The port of ``repro/serve/engine.py``.  Request lifecycle:

    queued (cold)   — no device state, no cost, pays prefill on promotion
    standby (hot)   — PREFILLED AHEAD: KV cache resident, zero-latency entry
    active          — occupies a decode slot, one token per engine step
    done

``standby`` is the sleep→spin transition made concrete: a standby request
has already paid its wake-up latency (prefill) *before* a slot frees, so the
handoff is immediate.  Holding standby KV is the resource cost; the
:class:`~repro_torch.core.window.SpinningWindow` in
:mod:`repro_torch.serve.scheduler` tunes how many to keep.

:class:`DecodeEngine` runs the real model on its device (the card unless
``device="cpu"``): prefill attention through the flash-attention kernel,
every rwkv6 time-mix through the WKV-scan kernel, every mamba mixer's
prefill through the selective-scan kernel, every RMSNorm through the
RMSNorm kernel.  It keeps the host-clock seconds of
each prefill and each step (``prefill_seconds``, ``step_seconds``); each
call ends in a read of the greedy token(s), so the clock brackets the
device work.  :class:`SimulatedEngine` exposes the same interface with a
cost model for large-scale scheduler benchmarks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


# --------------------------------------------------------------------------
# Requests
# --------------------------------------------------------------------------
@dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new_tokens: int
    arrived_at: float = 0.0
    generated: list = field(default_factory=list)
    # bookkeeping for metrics
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


# --------------------------------------------------------------------------
# Real engine
# --------------------------------------------------------------------------
class DecodeEngine:
    """Batched decode over ``max_slots`` sequences with insertable KV.

    prefill(tokens)           -> (next_token, cache_1)      [one sequence]
    insert(slot, cache_1, n)  -> write a prefilled sequence into the batch
    step()                    -> one greedy token for every occupied slot
    evict(slot)               -> free the slot

    ``params`` (a :class:`~repro_torch.models.transformer.Transformer`) is
    moved to ``device`` (default: the card; ``RuntimeError`` without one).
    """

    def __init__(self, cfg: ModelConfig, params, max_slots: int,
                 max_seq: int, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.cache = models.init_cache(cfg, max_slots, max_seq, self.device)
        self.occupied = np.zeros(max_slots, bool)
        self.slot_req: list[Request | None] = [None] * max_slots
        self._tokens = np.zeros((max_slots, 1), np.int64)
        self.prefill_seconds: list[float] = []
        self.step_seconds: list[float] = []

    # -- prefill one request (B=1), outside the batch -----------------------
    def prefill(self, prompt: list):
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(prompt, np.int64)[None, :],
                               device=self.device)
        logits, cache1 = models.prefill(self.cfg, self.params,
                                        {"tokens": toks})
        next_tok = int(torch.argmax(logits[0]))
        self.prefill_seconds.append(time.perf_counter() - t0)
        return next_tok, cache1

    # -- slot management ----------------------------------------------------
    def insert(self, slot: int, cache1, prompt_len: int, first_token: int,
               req: Request) -> None:
        """Write a prefilled sequence into ``slot``: every tensor of each
        layer's cache entry, as the reference's padded
        ``dynamic_update_slice`` over the cache tree; k / v at positions
        ``[0, S)`` and zeros after them, rwkv6 and mamba states whole."""
        assert not self.occupied[slot]
        for big, small in zip(self.cache["layers"], cache1["layers"]):
            for name, t in small.items():
                if name in ("k", "v"):
                    S = t.shape[2]
                    big[name][slot, :, :S] = t[0]
                    big[name][slot, :, S:] = 0
                else:
                    big[name][slot] = t[0]
        self.cache["len"][slot] = prompt_len
        self.occupied[slot] = True
        self.slot_req[slot] = req
        self._tokens[slot, 0] = first_token
        req.generated.append(first_token)

    def evict(self, slot: int) -> None:
        self.occupied[slot] = False
        self.slot_req[slot] = None
        self.cache["len"][slot] = 0

    def free_slots(self) -> list[int]:
        return [i for i in range(self.max_slots) if not self.occupied[i]]

    # -- one decode step over the whole batch -------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Decode one token for every occupied slot.  Returns
        [(slot, token)] for occupied slots."""
        if not self.occupied.any():
            return []
        t0 = time.perf_counter()
        toks = torch.as_tensor(self._tokens, device=self.device)
        logits, self.cache = models.decode_step(self.cfg, self.params,
                                                self.cache, toks)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        # un-occupied slots decoded garbage; mask them out and rewind lens
        occ = torch.as_tensor(self.occupied, device=self.device)
        self.cache["len"] = torch.where(occ, self.cache["len"], 0)
        out = []
        for i in range(self.max_slots):
            if self.occupied[i]:
                tok = int(nxt[i])
                self._tokens[i, 0] = tok
                self.slot_req[i].generated.append(tok)
                out.append((i, tok))
        self.step_seconds.append(time.perf_counter() - t0)
        return out


# --------------------------------------------------------------------------
# Simulated engine: same interface, synthetic timing (for sched benchmarks)
# --------------------------------------------------------------------------
class SimulatedEngine:
    """Cost model: prefill takes ``prefill_cost`` seconds of engine time,
    a decode step takes ``step_cost(n_active)`` seconds.  Tokens are fake."""

    def __init__(self, max_slots: int, prefill_cost: float = 5e-3,
                 step_base: float = 1e-3, step_per_slot: float = 1e-4):
        self.max_slots = max_slots
        self.prefill_cost = prefill_cost
        self.step_base = step_base
        self.step_per_slot = step_per_slot
        self.occupied = np.zeros(max_slots, bool)
        self.slot_req: list[Request | None] = [None] * max_slots
        self.now = 0.0

    def prefill(self, prompt: list):
        self.now += self.prefill_cost
        return 0, {"sim": True}

    def insert(self, slot, cache1, prompt_len, first_token, req: Request):
        assert not self.occupied[slot]
        self.occupied[slot] = True
        self.slot_req[slot] = req
        req.generated.append(first_token)

    def evict(self, slot):
        self.occupied[slot] = False
        self.slot_req[slot] = None

    def free_slots(self):
        return [i for i in range(self.max_slots) if not self.occupied[i]]

    def step(self):
        n = int(self.occupied.sum())
        self.now += self.step_base + self.step_per_slot * n
        out = []
        for i in range(self.max_slots):
            if self.occupied[i]:
                self.slot_req[i].generated.append(0)
                out.append((i, 0))
        return out

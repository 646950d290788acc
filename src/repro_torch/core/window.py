"""Generic spinning-window controller (the paper's state machine, factored
out of the OS lock).

The PyTorch port's own copy of ``repro/core/window.py`` (framework-free;
the port imports nothing of ``repro``), over the port's copies of the
oracles and the policy rows.

The mutable lock's essence is a bounded *active set*: at most ``sws`` agents
are kept "hot" (consuming resources, zero admission latency) while the rest
are "cold" (free, but pay a wake-up latency when promoted).  ``sws`` is
self-tuned by the EvalSWS rule.  This module exposes that state machine for
any resource with the same trade-off; in this framework it governs the
serving engine's decode-batch occupancy (DESIGN.md §3.2) and the
data-pipeline's prefetch depth.

Mapping (lock -> generic):

    spinner            -> active slot (hot)
    sleeper            -> queued item (cold)
    critical section   -> one service round (e.g. a decode step)
    wake-up latency    -> promotion latency (e.g. prefill/KV rehydration)
    slept and not spun -> a promoted item found the service idle-starved
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .oracle import EvalSWS, Oracle
from .policy import clamp_delta, wake_correction


@dataclass
class WindowStats:
    late_wakes: int = 0
    grows: int = 0
    shrinks: int = 0
    observations: int = 0
    history: list = field(default_factory=list)


class SpinningWindow:
    """Self-tuning bounded active set.

    Single-controller variant: unlike :class:`~repro.core.mutlock.MutableLock`
    there is one scheduler thread driving it, so the C1/C2 wake-up-count
    corrections reduce to immediately reporting how many cold items to
    promote (C1) or how many hot items to let drain (C2) after a resize.
    """

    def __init__(
        self,
        max_size: int,
        initial: int = 1,
        oracle: Oracle | None = None,
        min_size: int = 1,
    ):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max = max_size
        self.min = min_size          # the lock clamps to 1 (A16); a zero
        self.sws = max(min_size, min(initial, max_size))  # standby pool is a
        # valid serving ablation
        self.oracle: Oracle = oracle if oracle is not None else EvalSWS(k=10)
        self.stats = WindowStats()

    def observe(self, late_wake: bool, occupancy: int) -> int:
        """Feed one service-round observation; returns the *correction*
        (positive: promote that many cold items now — C1; negative: allow
        that many hot items to drain — C2; zero: nothing to do).

        ``late_wake``  — the round was served by a freshly-promoted item that
                         found no hot item ready ("slept and not spun").
        ``occupancy``  — hot + queued items (the lock's ``thc``).
        """
        self.stats.observations += 1
        self.stats.late_wakes += late_wake
        delta = self.oracle.eval_sws(spun=not late_wake, slept=late_wake,
                                     sws=self.sws)
        # Clamp exactly as Algorithm 1 lines A16-A17 (low bound = min_size).
        delta = clamp_delta(self.sws, delta, self.min, self.max)
        if delta == 0:
            self.stats.history.append(self.sws)
            return 0
        sws_pre, self.sws = self.sws, self.sws + delta
        self.stats.grows += delta > 0
        self.stats.shrinks += delta < 0
        self.stats.history.append(self.sws)
        # C1/C2 corrections (A23-A33): same arithmetic as the lock's wuc,
        # applied immediately since one controller drives the window.
        return wake_correction(delta, occupancy, sws_pre)

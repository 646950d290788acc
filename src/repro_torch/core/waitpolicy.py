"""MutableWait — hybrid spin/sleep predicate waiting (DESIGN.md §3.3).

Cross-host waits in the runtime (barrier on checkpoint shards, heartbeat of
peer hosts, straggler watch) are classically written as either a busy poll
(lowest latency, burns a core) or a fixed ``time.sleep`` loop (free, adds up
to one period of latency).  MutableWait applies the paper's insight: spin
for a *self-tuned* budget first, then back off to sleeping polls.  The spin
budget plays the role of the spinning window; "the predicate became true
while we were sleeping" is the late-wake-up signal that grows it; K clean
waits shrink it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class WaitStats:
    waits: int = 0
    spin_hits: int = 0      # satisfied during the spin phase
    sleep_hits: int = 0     # satisfied during the sleep phase (late)
    timeouts: int = 0
    spin_budget_history: list = None

    def __post_init__(self):
        if self.spin_budget_history is None:
            self.spin_budget_history = []


class MutableWait:
    """wait(predicate) with a self-tuned spin budget.

    Parameters mirror the lock: ``k`` clean spins-hits shrink the budget,
    a sleep-hit doubles it (the wait was under-provisioned), clamped to
    [min_spin_s, max_spin_s].
    """

    def __init__(
        self,
        min_spin_s: float = 1e-5,
        max_spin_s: float = 5e-3,
        sleep_s: float = 1e-3,
        k: int = 10,
    ):
        self.min_spin_s = min_spin_s
        self.max_spin_s = max_spin_s
        self.sleep_s = sleep_s
        self.k = k
        self._budget = min_spin_s
        self._clean = 0
        self.stats = WaitStats()

    @property
    def spin_budget_s(self) -> float:
        return self._budget

    def wait(self, predicate, timeout_s: float | None = None) -> bool:
        """Block until ``predicate()`` is truthy.  Returns False on timeout."""
        self.stats.waits += 1
        start = time.monotonic()
        spin_deadline = start + self._budget

        # --- spin phase (hot: lowest reaction latency) --------------------
        while time.monotonic() < spin_deadline:
            if predicate():
                self._observe(late=False)
                self.stats.spin_hits += 1
                return True
            time.sleep(0)  # GIL-friendly busy wait

        # --- sleep phase (cold: poll with period sleep_s) ------------------
        while True:
            if predicate():
                self._observe(late=True)
                self.stats.sleep_hits += 1
                return True
            if timeout_s is not None and time.monotonic() - start > timeout_s:
                self.stats.timeouts += 1
                return False
            time.sleep(self.sleep_s)

    def _observe(self, late: bool) -> None:
        """EvalSWS on the spin budget: double on a late hit, decay after K
        clean hits."""
        if late:
            self._budget = min(self.max_spin_s, self._budget * 2)
            self._clean = 0
        else:
            self._clean += 1
            if self._clean >= self.k:
                self._budget = max(self.min_spin_s, self._budget / 2)
                self._clean = 0
        self.stats.spin_budget_history.append(self._budget)

"""Heartbeat / straggler detection built on MutableWait (DESIGN.md §3.3).

At 1000+ nodes the controller's job is: notice quickly when a host stops
making progress (failure) or slows down (straggler), without burning a core
on polling.  Heartbeats arrive at step granularity; the monitor's wait for
"all peers reported step k" is a textbook spin-vs-sleep trade-off — exactly
the paper's problem, so the wait uses the self-tuned hybrid policy.

This module is hardware-independent: hosts push timestamps into a
HeartbeatBoard (in production backed by a KV store / coordination service;
here an in-process object, exercised by threads in tests).

The port of ``repro/runtime/heartbeat.py``, on the port's own
``MutableLock`` and ``MutableWait``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.core import MutableLock, MutableWait


@dataclass
class PeerState:
    host_id: int
    last_step: int = -1
    last_seen_s: float = 0.0
    failed: bool = False


class HeartbeatBoard:
    """Shared board of per-host progress, MutableLock-guarded."""

    def __init__(self, n_hosts: int):
        self.lock = MutableLock(max_sws=4)
        self.peers = {i: PeerState(i) for i in range(n_hosts)}

    def beat(self, host_id: int, step: int) -> None:
        with self.lock:
            p = self.peers[host_id]
            p.last_step = max(p.last_step, step)
            p.last_seen_s = time.monotonic()
            p.failed = False

    def mark_failed(self, host_id: int) -> None:
        with self.lock:
            self.peers[host_id].failed = True

    def snapshot(self) -> dict[int, PeerState]:
        with self.lock:
            return {i: PeerState(p.host_id, p.last_step, p.last_seen_s,
                                 p.failed)
                    for i, p in self.peers.items()}


@dataclass
class MonitorReport:
    step: int
    ready: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)
    failed: list = field(default_factory=list)


class StragglerMonitor:
    """Watches a HeartbeatBoard: detects failures (silence > dead_after_s)
    and stragglers (behind the median by > lag_steps)."""

    def __init__(self, board: HeartbeatBoard, dead_after_s: float = 5.0,
                 lag_steps: int = 2):
        self.board = board
        self.dead_after_s = dead_after_s
        self.lag_steps = lag_steps
        self.wait = MutableWait(max_spin_s=2e-3, sleep_s=2e-3)

    def wait_for_step(self, step: int, timeout_s: float = 30.0
                      ) -> MonitorReport:
        """Block until every live host reported ``step`` (or timeout);
        returns who is ready / straggling / presumed dead."""

        def everyone_there() -> bool:
            snap = self.board.snapshot()
            now = time.monotonic()
            return all(p.last_step >= step or p.failed
                       or p.last_seen_s == 0.0
                       or now - p.last_seen_s > self.dead_after_s
                       for p in snap.values())

        self.wait.wait(everyone_there, timeout_s=timeout_s)
        snap = self.board.snapshot()
        now = time.monotonic()
        rep = MonitorReport(step=step)
        steps = sorted(p.last_step for p in snap.values() if not p.failed)
        median = steps[len(steps) // 2] if steps else 0
        for p in snap.values():
            if (p.failed or p.last_seen_s == 0.0
                    or now - p.last_seen_s > self.dead_after_s):
                rep.failed.append(p.host_id)
            elif p.last_step < median - self.lag_steps:
                rep.stragglers.append(p.host_id)
            elif p.last_step >= step:
                rep.ready.append(p.host_id)
        return rep

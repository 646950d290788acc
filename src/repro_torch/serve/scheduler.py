"""Continuous-batching scheduler driven by the paper's spinning window.

The PyTorch port's copy of ``repro/serve/scheduler.py`` (``SchedStats``,
``ContinuousBatcher``); the scheduler-policy sweep through the batched
simulator (``SchedScenario``, ``sample_sched_scenarios``,
``xdes_policy_sweep``) waits for the sweep layer of the port (ROADMAP.md
M6).

Mapping (paper → serving), per DESIGN.md §3.2:

    spinner                  → standby request (prefilled ahead, KV resident)
    sleeper                  → queued request (cold, costless)
    critical section         → a decode slot becoming free
    OS wake-up latency       → prefill latency on promotion
    "slept and not spun"     → a slot freed with NO standby ready → the next
                               request pays its prefill in the open (late wake)
    sws                      → standby-pool target size
    EvalSWS                  → grow pool ×2 on a late wake; shrink by 1 after
                               K clean handoffs

The scheduler is engine-agnostic (real :class:`DecodeEngine` or
:class:`SimulatedEngine`) and exposes the spin/sleep trade-off as metrics:
*handoff latency* (responsiveness) vs *standby KV residency* (resource
waste) — the serving twins of the paper's CS-access latency vs spin CPU.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.oracle import EvalSWS, FixedOracle, Oracle
from repro_torch.core.window import SpinningWindow

from .engine import Request


@dataclass
class SchedStats:
    steps: int = 0
    handoffs: int = 0
    late_handoffs: int = 0            # slot freed, no standby ready
    completed: int = 0
    standby_residency: float = 0.0    # sum over steps of standby pool size
    queue_wait_steps: float = 0.0     # sum over steps of queue length
    slot_idle_steps: float = 0.0      # occupied-capacity shortfall
    submitted: int = 0                # offered requests (admitted + shed)
    shed: int = 0                     # rejected at the full queue
    window_trace: list = field(default_factory=list)

    def summary(self) -> dict:
        s = max(1, self.steps)
        return {
            "steps": self.steps,
            "completed": self.completed,
            "handoffs": self.handoffs,
            "late_handoff_rate": self.late_handoffs / max(1, self.handoffs),
            "avg_standby": self.standby_residency / s,
            "avg_queue": self.queue_wait_steps / s,
            "avg_slot_idle": self.slot_idle_steps / s,
            "submitted": self.submitted,
            "shed": self.shed,
            "shed_rate": self.shed / max(1, self.submitted),
        }


class ContinuousBatcher:
    """Admission + standby control for a slot-based decode engine.

    ``window.sws`` is the *standby-pool target*: how many queued requests to
    keep prefilled-ahead (hot).  ``oracle=None`` uses the paper's EvalSWS;
    pass :class:`FixedOracle` with ``initial`` for the static ablations
    (0 = pure sleep-lock behaviour, ``max`` = pure spin-lock behaviour).
    """

    def __init__(self, engine, max_standby: int | None = None,
                 initial: int = 1, oracle: Oracle | None = None,
                 k: int = 10, min_standby: int | None = None,
                 queue_cap: int | None = None):
        self.engine = engine
        #: open-loop admission bound: submissions past a full queue are
        #: shed (None = unbounded, the closed-loop legacy behaviour)
        self.queue_cap = queue_cap
        max_standby = max_standby or max(1, engine.max_slots)
        if min_standby is None:
            # static-zero ablation: a FixedOracle with initial=0 means
            # "never keep standby" (the pure sleep-lock analogue).  The
            # adaptive oracle keeps the paper's sws >= 1 clamp (doubling
            # from 0 could never grow).
            min_standby = 0 if (initial == 0
                                and isinstance(oracle, FixedOracle)) else 1
        self.window = SpinningWindow(
            max_size=max_standby, initial=initial, min_size=min_standby,
            oracle=oracle if oracle is not None else EvalSWS(k=k))
        self.queue: deque[Request] = deque()
        self.standby: deque[tuple[Request, object, int]] = deque()
        self.stats = SchedStats()

    @classmethod
    def from_policy(cls, engine, policy: str, max_standby: int | None = None,
                    k: int = 10) -> "ContinuousBatcher":
        """Build a batcher from a named admission policy.

        ``mutable`` — the paper's EvalSWS window (self-tuned standby pool);
        ``sleep``/``zero`` — never keep standby (pure sleep-lock analogue);
        ``spin``/``max`` — standby pool pinned at the maximum (pure
        spin-lock analogue).  Mirrors the lock registry in
        :mod:`repro_torch.core.policy` so benchmarks and serving configs name
        disciplines consistently.
        """
        cap = max(1, engine.max_slots) if max_standby is None else max_standby
        if policy == "mutable":
            return cls(engine, max_standby=cap, initial=1, oracle=EvalSWS(k=k))
        if policy in ("sleep", "zero"):
            return cls(engine, max_standby=cap, initial=0,
                       oracle=FixedOracle())
        if policy in ("spin", "max"):
            return cls(engine, max_standby=cap, initial=cap,
                       oracle=FixedOracle())
        raise ValueError(f"unknown admission policy {policy!r}; "
                         "options: mutable|sleep|zero|spin|max")

    # -- client API ---------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit ``req`` (True) or shed it at a full queue (False).

        Admission reads the queue depth against ``queue_cap`` — the
        scheduler twin of the engine's bounded request ring: under an
        open-loop arrival process, offered load past saturation is shed
        here instead of growing the queue without bound."""
        self.stats.submitted += 1
        if (self.queue_cap is not None
                and len(self.queue) + len(self.standby) >= self.queue_cap):
            self.stats.shed += 1
            return False
        self.queue.append(req)
        return True

    def pending(self) -> int:
        return len(self.queue) + len(self.standby)

    def active(self) -> int:
        return int(self.engine.occupied.sum())

    def idle(self) -> bool:
        return not self.queue and not self.standby and self.active() == 0

    # -- internals ------------------------------------------------------------
    def _prefill_one(self) -> None:
        req = self.queue.popleft()
        first_tok, cache1 = self.engine.prefill(req.prompt)
        self.standby.append((req, cache1, first_tok))

    def _fill_standby(self) -> None:
        """Keep the hot pool at the window target (spinners)."""
        while self.queue and len(self.standby) < self.window.sws:
            self._prefill_one()

    def _handoff(self, slot: int) -> bool:
        """Slot freed → promote.  Returns True if the handoff was late."""
        late = False
        if self.standby:
            req, cache1, tok = self.standby.popleft()
        elif self.queue:
            late = True                     # pays prefill in the open
            self._prefill_one()
            req, cache1, tok = self.standby.popleft()
        else:
            return False
        self.engine.insert(slot, cache1, len(req.prompt), tok, req)
        self.stats.handoffs += 1
        self.stats.late_handoffs += late
        # the paper's oracle step: one observation per handoff ("release")
        occupancy = len(self.standby) + len(self.queue)
        corr = self.window.observe(late_wake=late, occupancy=occupancy)
        if corr > 0:                        # C1: promote extra sleepers now
            for _ in range(min(corr, len(self.queue))):
                self._prefill_one()
        # C2 (corr < 0) drains naturally: _fill_standby stops refilling.
        return late

    # -- one engine step ------------------------------------------------------
    def run_step(self) -> list[Request]:
        """Fill slots, decode one token, retire completions."""
        for slot in self.engine.free_slots():
            if not self.queue and not self.standby:
                break
            self._handoff(slot)
        self._fill_standby()

        finished: list[Request] = []
        for slot, _tok in self.engine.step():
            req = self.engine.slot_req[slot]
            if req is not None and req.done:
                self.engine.evict(slot)
                finished.append(req)
                self.stats.completed += 1

        self.stats.steps += 1
        self.stats.standby_residency += len(self.standby)
        self.stats.queue_wait_steps += len(self.queue)
        shortfall = self.engine.max_slots - self.active()
        if self.pending() > 0 and shortfall > 0:
            self.stats.slot_idle_steps += shortfall
        self.stats.window_trace.append(self.window.sws)
        return finished

    def run_until_drained(self, max_steps: int = 100_000) -> SchedStats:
        steps = 0
        while not self.idle() and steps < max_steps:
            self.run_step()
            steps += 1
        return self.stats

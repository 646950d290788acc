"""Discrete-event simulation of lock algorithms under processor sharing.

The PyTorch port's own copy of the reference's event-driven DES
(``repro/core/des.py``): framework-free Python over the port's
:mod:`repro_torch.core.policy` and :mod:`repro_torch.core.oracle`, drawing
from :class:`random.Random` exactly as the reference does, so one
``(config, seed)`` gives the same :class:`SimResult` field for field in
both packages (pinned by ``tests/test_torch_des.py``).  It is the exact
yardstick the port's batched engine (:mod:`repro_torch.core.xdes`, on the
card through the ``lock_sim_block`` kernels) is held against by
seed-averaged throughput bands, and the engine behind Fig. 1's timelines
and the exact Fig. 3 grid (:mod:`repro_torch.bench.lockbench`).

Real threads on a host cannot show the paper's *multi-core* regimes (a
20-core machine, spinners genuinely parallel with the critical-section
holder).  This module simulates the lock disciplines on a machine with a
configurable number of cores, CS/NCS length distributions, and OS wake-up
latency, reproducing Fig. 1's timelines and Fig. 3's throughput / CPU-time
trends deterministically.

Model
-----
* ``cores`` CPUs, generalized processor sharing: every *runnable* task
  (executing CS, executing NCS, or spinning) advances at rate
  ``min(1, cores / n_runnable)``.
* Sleeping / waking threads are not runnable (consume no CPU).
* Waking takes ``wake_latency`` wall seconds (OS scheduling delay).
* Hardware contention: the CS holder's rate is additionally multiplied by
  ``1 / (1 + alpha * n_spinners)`` — the cache-coherency pressure the paper
  attributes to concurrent RMW/spin traffic (§2).  ``alpha`` is per-lock
  (MCS spins on local lines -> 0; TAS is worst) and overridable per run.
* Wake permits are conserved exactly like a semaphore: a wake-up granted when
  no thread is parked is banked and absorbed by the next would-be sleeper.
* Metric "CPU time in synchronization" = integral of CPU consumed by
  spinning, the paper's wasted-cycles metric.

The mutable-lock model runs the real :class:`~repro_torch.core.oracle.EvalSWS`
oracle and the C1/C2 wake-up-count corrections of Algorithm 1 — the DES and
the threaded implementation share the oracle code, so validating one
validates the policy of the other.

Workloads: CS/NCS duration draws route through the workload rows of
:data:`repro_torch.core.policy.WORKLOAD_ROWS` (constant, bursty ON/OFF,
heterogeneous per-thread scales, Poisson-like jittered arrivals) — this
module is the event-driven twin the batched engine's workload rows are
pinned against by seed-averaged band tests (tests/test_torch_paper_claims.py
and the ``paper_figures`` phase of ``chip_smoke.py``).  The
per-thread phase/scale state is drawn from a dedicated seeded stream, so
the constant row consumes exactly the pre-workload RNG sequence.

Faults: environment interference routes through the fault rows of
:data:`repro_torch.core.policy.FAULT_ROWS` (lock-holder preemption, CPU
oversubscription, lost wake-ups with timeout recovery, timer jitter).  The
DES realizes them as (a) a per-(thread, window) progress multiplier on
CS/NCS execution, gated by the same ``FLT_GATE_SALT`` counter stream as the
batched engine, with event intervals capped at fault-window boundaries so
multipliers stay piecewise-constant, and (b) a perturbation of the wake-up
latency at wake-scheduling time (``FLT_WAKE_SALT`` / ``FLT_MAG_SALT``
streams, indexed by a per-thread wake counter — the batched engine keys the
same draws by step index, so the two agree in distribution, not bit-for-bit;
parity is pinned by seed-averaged band tests, as for the workload rows).
Spin burn is deliberately NOT modulated: a preempted spinner stops making
progress anyway, while the sleeper's parked time costs nothing — the
asymmetry that lets sleep-leaning disciplines overtake spin under
preemption.  The ``none`` row takes none of these code paths, so benign
runs are bit-identical to the pre-fault DES.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field

from . import policy
from .oracle import EvalSWS, Oracle

# thread states (shared integer encoding: see repro_torch.core.policy)
from .policy import CS, DONE, NCS, SPIN, STATE_NAMES, WAKING
from .policy import SLEEP_ST as SLEEP  # noqa: N811 (DES-local alias)


@dataclass
class _Task:
    tid: int
    state: int = NCS
    remaining: float = 0.0      # CPU-seconds of work left (CS/NCS/spin budget)
    wake_at: float = -1.0       # wall time the wake completes (WAKING)
    slept: bool = False         # paper's per-acquire `slept` flag
    spun: bool = False          # paper's per-acquire `spun` flag
    cs_done: int = 0
    spin_cpu: float = 0.0


@dataclass
class SimResult:
    lock: str
    threads: int
    cores: int
    completed_cs: int = 0
    t_end: float = 0.0
    spin_cpu: float = 0.0       # CPU-seconds burnt spinning (sync waste)
    wake_count: int = 0
    sws_trace: list = field(default_factory=list)
    timeline: list = field(default_factory=list)  # (t, tid, event) triples
    # -- open-loop accounting (zero / empty on closed runs) -----------------
    arrived: int = 0            # offered arrivals (admitted + shed)
    shed: int = 0               # dropped at the full queue
    slo_viol: int = 0           # departures with latency > slo
    latencies: list = field(default_factory=list)   # per-request sojourns

    @property
    def throughput(self) -> float:
        return self.completed_cs / self.t_end if self.t_end > 0 else 0.0

    @property
    def sync_cpu_per_cs(self) -> float:
        return self.spin_cpu / max(1, self.completed_cs)

    @property
    def mean_latency(self) -> float:
        return (sum(self.latencies) / len(self.latencies)
                if self.latencies else float("nan"))

    def latency_percentile(self, q: float) -> float:
        """Exact per-request latency quantile (nearest-rank)."""
        if not self.latencies:
            return float("nan")
        lat = sorted(self.latencies)
        return lat[min(len(lat) - 1,
                       max(0, math.ceil(q * len(lat)) - 1))]


# ---------------------------------------------------------------------------
# Lock discipline models
# ---------------------------------------------------------------------------
class _LockModel:
    """Reacts to arrive/release/wake events; decides spin vs sleep vs enter."""

    default_alpha = 0.0  # hardware-contention coefficient

    def __init__(self, sim: "LockSim", alpha: float | None = None):
        self.sim = sim
        self.alpha = self.default_alpha if alpha is None else alpha
        self.holder: int | None = None
        self.permits = 0  # banked semaphore permits (conserved wake-ups)

    # -- hooks --------------------------------------------------------------
    def on_arrive(self, t: _Task) -> None:
        raise NotImplementedError

    def on_release(self, t: _Task) -> None:
        raise NotImplementedError

    def on_wake_complete(self, t: _Task) -> None:
        raise NotImplementedError

    def on_spin_budget_exhausted(self, t: _Task) -> None:
        raise AssertionError("no spin budget in this discipline")

    # -- helpers --------------------------------------------------------------
    def _enter_cs(self, t: _Task) -> None:
        assert self.holder is None, "mutual exclusion violated in model"
        self.holder = t.tid
        self.sim.start_cs(t)

    def _sleep(self, t: _Task) -> None:
        """Park t, absorbing a banked permit if one exists (semaphore law)."""
        if self.permits > 0:
            self.permits -= 1
            self.sim.schedule_wake_direct(t)  # instant re-dispatch path
        else:
            t.state = SLEEP

    def _wake_some(self, k: int) -> None:
        """Grant k wake permits; park-free permits are banked."""
        for _ in range(k):
            sl = self.sleepers()
            if sl:
                self.sim.schedule_wake(self.sim.rng.choice(sl))
            else:
                self.permits += 1

    def spinners(self) -> list[_Task]:
        return [t for t in self.sim.tasks if t.state == SPIN]

    def sleepers(self) -> list[_Task]:
        return [t for t in self.sim.tasks if t.state == SLEEP]

    # -- model-internal wall-clock events (backoff polls etc.) --------------
    def next_event(self) -> float:
        """Earliest model-internal wall-clock event, or +inf.  The DES main
        loop caps its interval here so discipline-private timers (e.g. the
        ttas_backoff poll schedule) fire exactly on time."""
        return float("inf")

    def on_time_advanced(self) -> None:
        """Fire model-internal events due at ``sim.now`` (default: none)."""


class SpinModel(_LockModel):
    """TTAS-style: every waiter spins; release hands to a random spinner."""

    name = "ttas"
    default_alpha = policy.DEFAULT_ALPHA["ttas"]

    def on_arrive(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:
            t.state = SPIN
            t.spun = True

    def on_release(self, t):
        self.holder = None
        sp = self.spinners()
        if sp:
            self._enter_cs(self.sim.rng.choice(sp))

    def on_wake_complete(self, t):
        raise AssertionError("spin lock never sleeps")


class TASModel(SpinModel):
    name = "tas"
    default_alpha = policy.DEFAULT_ALPHA["tas"]


class MCSModel(_LockModel):
    """FIFO queue lock; waiters spin on private lines (alpha = 0)."""

    name = "mcs"
    default_alpha = policy.DEFAULT_ALPHA["mcs"]

    def __init__(self, sim, alpha=None):
        super().__init__(sim, alpha)
        self.queue: list[int] = []

    def on_arrive(self, t):
        if self.holder is None and not self.queue:
            self._enter_cs(t)
        else:
            t.state = SPIN
            t.spun = True
            self.queue.append(t.tid)

    def on_release(self, t):
        self.holder = None
        if self.queue:
            self._enter_cs(self.sim.tasks[self.queue.pop(0)])

    def on_wake_complete(self, t):
        raise AssertionError("mcs never sleeps")


class FIFOModel(MCSModel):
    """True-MCS ticket handoff: waiters join a numbered queue and the lock
    is granted strictly in arrival order — no barging.  The event-driven
    twin of the batched engine's ``fifo`` discipline row (which implements
    the same order with per-thread tickets); parity between the two is
    pinned by tests/test_disciplines.py."""

    name = "fifo"
    default_alpha = policy.DEFAULT_ALPHA["fifo"]


class SleepModel(_LockModel):
    """Benaphore / pthread-mutex default: always sleep when contended."""

    name = "sleep"
    default_alpha = policy.DEFAULT_ALPHA["sleep"]

    def on_arrive(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:
            t.slept = True
            self._sleep(t)

    def on_release(self, t):
        self.holder = None
        if self.sleepers() or self.sim.any_waking():
            self._wake_some(1)

    def on_wake_complete(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:  # barged by a new arrival; park again
            self._sleep(t)


class AdaptiveModel(_LockModel):
    """glibc adaptive: spin for a fixed budget, then sleep.  No sleep->spin."""

    name = "adaptive"
    default_alpha = policy.DEFAULT_ALPHA["adaptive"]

    def __init__(self, sim, spin_budget: float = 2e-6, alpha=None):
        super().__init__(sim, alpha)
        self.spin_budget = spin_budget  # CPU-seconds before giving up

    def on_arrive(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:
            t.state = SPIN
            t.spun = True
            t.remaining = self.spin_budget  # consumed at CPU rate

    def on_spin_budget_exhausted(self, t):
        t.slept = True
        self._sleep(t)

    def on_release(self, t):
        self.holder = None
        sp = self.spinners()
        if sp:
            self._enter_cs(self.sim.rng.choice(sp))
        elif self.sleepers() or self.sim.any_waking():
            self._wake_some(1)

    def on_wake_complete(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:
            self._sleep(t)


class MutableModel(_LockModel):
    """Paper Algorithm 1 on top of the DES: spinning window + sleep->spin
    transitions + EvalSWS oracle + C1/C2 wake-up-count corrections."""

    name = "mutable"
    default_alpha = policy.DEFAULT_ALPHA["mutable"]

    def __init__(self, sim, initial_sws: int = 1, max_sws: int | None = None,
                 oracle: Oracle | None = None, alpha=None):
        super().__init__(sim, alpha)
        self.sws = initial_sws
        self.max = max_sws if max_sws is not None else sim.cores
        self.thc = 0
        self.wuc = 0
        self.oracle = oracle if oracle is not None else EvalSWS(k=10)

    def on_arrive(self, t):
        thc_pre, self.thc = self.thc, self.thc + 1       # A4: FAD(+1)
        t.slept = t.spun = False
        if policy.should_sleep_on_arrival(thc_pre, self.sws):  # A7
            t.slept = True                               # A8
            self._sleep(t)                               # A9
        elif self.holder is None:                        # A11: spn_obj free
            self._acquired(t)
        else:
            t.state = SPIN                               # A11: spin phase
            t.spun = True

    def _acquired(self, t):
        """spn_obj acquired: run EvalSWS + C1/C2 bookkeeping (A12-A33)."""
        self._enter_cs(t)
        self.sim.res.sws_trace.append((self.sim.now, self.sws))
        delta = self.oracle.eval_sws(t.spun, t.slept, self.sws)  # A12
        delta = policy.clamp_delta(self.sws, delta, 1, self.max)  # A16-A17
        if delta:                                        # A18
            sws_pre, self.sws = self.sws, self.sws + delta       # A20
            # A21-A33: C1/C2 correction from the shared policy core.
            self.wuc += policy.wake_correction(delta, self.thc, sws_pre)

    def on_release(self, t):
        r_wuc, self.wuc = policy.latch_wuc(self.wuc)     # R2-R7
        thc_pre, self.thc = self.thc, self.thc - 1       # R9: FAD(-1)
        self.holder = None                               # R10: spn unlock
        sp = self.spinners()
        if sp:                                           # spn handoff
            self._acquired(self.sim.rng.choice(sp))
        # R11-R17: the handoff's _acquired may have resized the window, so
        # the R16 check reads the post-handoff sws (same order as before).
        self._wake_some(policy.release_quota(r_wuc, thc_pre, self.sws))

    def on_wake_complete(self, t):
        # The sleep->spin transition: the woken thread joins the window.
        if self.holder is None:
            # spn_obj free: acquired with no spinning -> t.spun stays False,
            # so EvalSWS sees the late wake-up and doubles the window.
            self._acquired(t)
        else:
            t.state = SPIN
            t.spun = True  # spn_obj.lock() will observe contention


class FissileModel(AdaptiveModel):
    """Fissile-style spin-then-park composition (Dice & Kogan): waiters spin
    for a *bounded* budget then park, and the budget self-tunes through the
    same oracle state as the mutable lock — ``sws`` scales the budget
    (``spin_budget * sws * park_cost``, the spin-for-about-a-park-round-trip
    rule) instead of gating arrivals.  A park doubles the window (bigger
    budget next time); clean spin-only acquisitions shrink it.  The
    event-driven twin of the engine's ``fissile`` row, which masks ``spun``
    so the oracle's *late* signal is exactly *did this acquisition park?*."""

    name = "fissile"
    default_alpha = policy.DEFAULT_ALPHA["fissile"]

    def __init__(self, sim, spin_budget: float = 2e-6, initial_sws: int = 1,
                 max_sws: int | None = None, oracle: Oracle | None = None,
                 alpha=None):
        super().__init__(sim, spin_budget, alpha)
        self.sws = max(1, min(initial_sws,
                              max_sws if max_sws is not None else sim.cores))
        self.max = max_sws if max_sws is not None else sim.cores
        self.oracle = oracle if oracle is not None else EvalSWS(k=10)

    def _budget(self) -> float:
        return self.spin_budget * self.sws * self.sim.park_cost

    def _acquired(self, t):
        """Lock acquired: resize the budget window.  ``spun`` is forced
        False so the oracle's late signal is purely *slept* (as in the
        engine's ``budget_scaled`` masking)."""
        self._enter_cs(t)
        self.sim.res.sws_trace.append((self.sim.now, self.sws))
        delta = self.oracle.eval_sws(False, t.slept, self.sws)
        delta = policy.clamp_delta(self.sws, delta, 1, self.max)
        self.sws += delta

    def on_arrive(self, t):
        t.slept = t.spun = False
        if self.holder is None:
            self._acquired(t)
        else:
            t.state = SPIN
            t.spun = True
            t.remaining = self._budget()

    def on_release(self, t):
        self.holder = None
        sp = self.spinners()
        if sp:
            self._acquired(self.sim.rng.choice(sp))
        elif self.sleepers() or self.sim.any_waking():
            self._wake_some(1)

    def on_wake_complete(self, t):
        if self.holder is None:
            self._acquired(t)
        else:  # sleep->spin: rejoin the spin phase with a re-armed budget
            t.state = SPIN
            t.remaining = self._budget()


class HapaxModel(_LockModel):
    """Hapax value-based FIFO admission (Dice & Kogan): constant-time
    arrival (tail enqueue) and unlock (head wake).  Every contended arrival
    parks with its queue position; releases wake strictly in arrival order,
    and an arrival may barge only when the lock is free AND nobody waits —
    structurally no barging.  Twin of the engine's ``hapax`` row (min-ticket
    grant among parked waiters)."""

    name = "hapax"
    default_alpha = policy.DEFAULT_ALPHA["hapax"]

    def __init__(self, sim, alpha=None):
        super().__init__(sim, alpha)
        self.queue: list[int] = []  # tids of parked/waking waiters, FIFO

    def _wake_head(self, k: int = 1) -> None:
        """Grant k wake permits to the earliest still-sleeping waiters;
        park-free permits are banked (semaphore law), exactly like
        :meth:`_LockModel._wake_some` but in queue order, never random."""
        for _ in range(k):
            sl = [tid for tid in self.queue
                  if self.sim.tasks[tid].state == SLEEP]
            if sl:
                self.sim.schedule_wake(self.sim.tasks[sl[0]])
            else:
                self.permits += 1

    def on_arrive(self, t):
        if self.holder is None and not self.queue:
            self._enter_cs(t)
        else:
            t.slept = True
            self.queue.append(t.tid)
            self._sleep(t)

    def on_release(self, t):
        self.holder = None
        if self.queue:
            self._wake_head(1)

    def on_wake_complete(self, t):
        if self.holder is None and self.queue and self.queue[0] == t.tid:
            self.queue.pop(0)
            self._enter_cs(t)
        else:
            # Not yet this waiter's turn (another head is mid-wake) or the
            # lock is held: re-park WITHOUT losing the queue position.
            self._sleep(t)


class TTASBackoffModel(_LockModel):
    """TTAS with seeded bounded-exponential backoff: contended waiters stay
    runnable (burning spin CPU) but only *poll* the lock on a schedule —
    after each failed poll the next attempt is delayed by
    ``spin_budget * 2^min(attempt, BO_CAP) * u`` with ``u`` from the
    dedicated ``BO_SALT`` counter stream.  No handoff: a release leaves the
    lock free until some spinner's next poll.  Twin of the engine's
    ``ttas_backoff`` row (lowest-tid due poller wins each instant)."""

    name = "ttas_backoff"
    default_alpha = policy.DEFAULT_ALPHA["ttas_backoff"]

    def __init__(self, sim, spin_budget: float = 2e-6, alpha=None):
        super().__init__(sim, alpha)
        self.spin_budget = spin_budget
        self.next_poll: dict[int, float] = {}
        self.attempt: dict[int, int] = {}
        self._draws: dict[int, int] = {}  # per-tid BO-stream counters

    def _bo_u(self, tid: int) -> float:
        k = self._draws.get(tid, 0)
        self._draws[tid] = k + 1
        return policy.counter_uniform_scalar(
            self.sim._flt_seed ^ policy.BO_SALT, tid, k)

    def on_arrive(self, t):
        if self.holder is None:
            self._enter_cs(t)
        else:
            t.state = SPIN
            t.spun = True
            self.attempt[t.tid] = 0
            self.next_poll[t.tid] = (self.sim.now
                                     + self.spin_budget * self._bo_u(t.tid))

    def on_release(self, t):
        self.holder = None  # no handoff: spinners acquire at their polls

    def on_wake_complete(self, t):
        raise AssertionError("ttas_backoff never sleeps")

    def next_event(self) -> float:
        due = [self.next_poll[t.tid] for t in self.spinners()]
        return min(due) if due else float("inf")

    def on_time_advanced(self) -> None:
        eps = 1e-15
        for t in self.spinners():  # tid order: lowest due poller wins
            if self.next_poll[t.tid] > self.sim.now + eps:
                continue
            if self.holder is None:
                self.next_poll.pop(t.tid)
                self.attempt.pop(t.tid)
                self._enter_cs(t)
            else:
                a = self.attempt[t.tid] = self.attempt[t.tid] + 1
                delay = (self.spin_budget
                         * 2.0 ** min(a, policy.BO_CAP) * self._bo_u(t.tid))
                self.next_poll[t.tid] = self.sim.now + delay


_MODELS = {
    "tas": TASModel,
    "ttas": SpinModel,
    "mcs": MCSModel,
    "fifo": FIFOModel,
    "sleep": SleepModel,
    "adaptive": AdaptiveModel,
    "mutable": MutableModel,
    "fissile": FissileModel,
    "hapax": HapaxModel,
    "ttas_backoff": TTASBackoffModel,
}


# ---------------------------------------------------------------------------
# The simulator core
# ---------------------------------------------------------------------------
class LockSim:
    """Generalized-processor-sharing DES of N threads hammering one lock."""

    def __init__(
        self,
        lock: str,
        threads: int,
        cores: int,
        cs: tuple[float, float],
        ncs: tuple[float, float],
        wake_latency: float,
        seed: int = 0,
        record_timeline: bool = False,
        max_cs_per_thread: int | None = None,
        lock_kwargs: dict | None = None,
        workload: str = "constant",
        wl_period: float = 1e-4,
        wl_duty: float = 0.25,
        wl_burst: float = 8.0,
        wl_spread: float = 4.0,
        arrival_phase: float = 0.0,
        arrival: str = "closed",
        arrival_rate: float = 0.0,
        queue_cap: int = policy.QUEUE_MAX,
        slo: float = 1e-3,
        fault: str = "none",
        fault_rate: float = 0.0,
        fault_scale: float = 5e-5,
        park_cost: float = 1.0,
    ):
        self.rng = random.Random(seed)
        self.cores = cores
        self.cs_lo, self.cs_hi = cs
        self.ncs_lo, self.ncs_hi = ncs
        # M:N parking axis: park_cost scales the park/unpark round trip
        # BEFORE the fault rows perturb it, same order as the engine
        # (wake_base = wake * park_cost, then fault wake_delay).
        self.park_cost = park_cost
        self.wake_latency = wake_latency * park_cost
        self.now = 0.0
        self.tasks = [_Task(tid=i) for i in range(threads)]
        self.model: _LockModel = _MODELS[lock](self, **(lock_kwargs or {}))
        self.res = SimResult(lock=lock, threads=threads, cores=cores)
        self.record_timeline = record_timeline
        self.max_cs_per_thread = max_cs_per_thread
        # -- workload rows (the event-driven twin of WORKLOAD_ROWS) --------
        self.workload = policy.WORKLOAD_IDS[workload]
        self.wl_period, self.wl_duty = wl_period, wl_duty
        self.wl_burst, self.wl_spread = wl_burst, wl_spread
        self.arrival_phase = arrival_phase
        # persistent per-thread phase/scale from the SAME salted counter
        # streams as the batched engine (identical realizations per
        # (seed, tid)), leaving the main RNG sequence untouched so the
        # constant row matches the pre-workload engine draw for draw
        u32 = seed & 0xFFFFFFFF
        self._wl_phase = [
            policy.counter_uniform_scalar(u32 ^ policy.WL_PHASE_SALT, i)
            for i in range(threads)]
        self._wl_tscale = [
            policy.workload_thread_scale(
                policy.counter_uniform_scalar(u32 ^ policy.WL_SPREAD_SALT,
                                              i), wl_spread)
            for i in range(threads)]
        # -- open-loop arrival rows (the event-driven twin of ARRIVAL_ROWS) --
        self.arrival = policy.ARRIVAL_IDS[arrival]
        self.arrival_rate = arrival_rate
        self.queue_cap = queue_cap
        self.slo = slo
        self.open_loop = self.arrival != policy.AR_CLOSED
        # burst-gate phase from the same salted counter stream as the engine
        self._ar_phase = policy.counter_uniform_scalar(
            (seed ^ policy.AR_PHASE_SALT) & 0xFFFFFFFF, 0)
        # dedicated arrival stream: the main draw sequence stays untouched,
        # so closed-loop realizations are unchanged by the open-loop fields
        self.arr_rng = random.Random((seed ^ policy.AR_SALT) & 0xFFFFFFFF)
        self.queue: list[float] = []   # FIFO of admitted arrival wall-times
        self._req_t: dict[int, float] = {}  # tid -> bound request's arrival
        self._next_arr = float("inf")
        # -- fault rows (the event-driven twin of FAULT_ROWS) ---------------
        self.fault = policy.FAULT_IDS[fault]
        self.fault_rate = fault_rate
        self.fault_scale = fault_scale
        self._fault_row = policy.FAULT_ROWS[fault]
        self._faulted = self.fault != policy.FAULT_NONE
        self._flt_seed = u32
        # per-thread wake-draw counters for the lostwake/jitter streams
        self._flt_wake_ctr = [0] * threads

    # -- fault-row machinery ------------------------------------------------
    def _wake_delay(self, tid: int) -> float:
        """Effective wake latency under the config's fault row.  The none
        row returns ``wake_latency`` without touching any counter stream."""
        if not self._faulted:
            return self.wake_latency
        k = self._flt_wake_ctr[tid]
        self._flt_wake_ctr[tid] = k + 1
        w1 = policy.counter_uniform_scalar(
            self._flt_seed ^ policy.FLT_WAKE_SALT, tid, k)
        w2 = policy.counter_uniform_scalar(
            self._flt_seed ^ policy.FLT_MAG_SALT, tid, k)
        return self._fault_row.wake_delay(self.wake_latency, w1, w2,
                                          self.fault_rate, self.fault_scale)

    def _fault_window(self) -> int:
        """Current fault-window index, nudged past a boundary the clock has
        effectively reached (guards against float-epsilon stalls)."""
        win = int(self.now / self.fault_scale)
        if (win + 1) * self.fault_scale - self.now <= self.fault_scale * 1e-9:
            win += 1
        return win

    def _fault_mult(self, t: _Task, win: int) -> float:
        """Per-(thread, window) CS/NCS progress multiplier."""
        gu = policy.counter_uniform_scalar(
            self._flt_seed ^ policy.FLT_GATE_SALT, t.tid, win)
        return self._fault_row.progress(1.0 if t.state == CS else 0.0,
                                        gu, self.fault_rate)

    # -- open-loop arrival machinery ----------------------------------------
    def arrival_rate_at(self, t: float) -> float:
        """Instantaneous offered rate: scalar twin of ARRIVAL_ROWS."""
        if self.arrival == policy.AR_BURSTY:
            gate_off = policy.workload_off_gate(t, self._ar_phase,
                                                self.wl_period, self.wl_duty)
            gate_on = 1.0 - gate_off
            return self.arrival_rate * (1.0 + gate_on * (self.wl_burst - 1.0))
        return self.arrival_rate

    def _draw_next_arrival(self, t0: float) -> float:
        """Next arrival after ``t0`` by thinning an Exp(max-rate) stream,
        exact for the time-varying bursty row."""
        rmax = self.arrival_rate * (self.wl_burst
                                    if self.arrival == policy.AR_BURSTY
                                    else 1.0)
        if rmax <= 0.0:
            return float("inf")
        t = t0
        while True:
            t += self.arr_rng.expovariate(rmax)
            if self.arr_rng.random() * rmax <= self.arrival_rate_at(t):
                return t

    def _admit_due_arrivals(self) -> None:
        while self._next_arr <= self.now + 1e-15:
            self.res.arrived += 1
            if len(self.queue) < self.queue_cap:
                self.queue.append(self._next_arr)
            else:
                self.res.shed += 1
            self._next_arr = self._draw_next_arrival(self._next_arr)

    def _bind_queued(self) -> None:
        """Bind queued requests to free (DONE) threads, lowest tid first."""
        if not self.queue:
            return
        for t in self.tasks:
            if not self.queue:
                return
            if t.state == DONE:
                self._req_t[t.tid] = self.queue.pop(0)
                t.state = NCS
                t.remaining = self.draw_ncs(t.tid)
                self._log(t.tid, "bind")

    # -- workload-row hold-time draws ---------------------------------------
    def draw_cs(self, tid: int) -> float:
        """One CS duration under the config's workload row (the scalar
        mirror of :func:`repro_torch.kernels.ref.workload_draw`)."""
        base = self.rng.uniform(self.cs_lo, self.cs_hi)
        if self.workload == policy.WL_HETERO:
            return base * self._wl_tscale[tid]
        return base

    def draw_ncs(self, tid: int) -> float:
        """One NCS (arrival-gap) duration under the workload row."""
        u = self.rng.random()
        base = self.ncs_lo + u * (self.ncs_hi - self.ncs_lo)
        if self.workload == policy.WL_BURSTY:
            gate = policy.workload_off_gate(self.now, self._wl_phase[tid],
                                            self.wl_period, self.wl_duty)
            return base * (1.0 + gate * (self.wl_burst - 1.0))
        if self.workload == policy.WL_HETERO:
            return base * self._wl_tscale[tid]
        if self.workload == policy.WL_JITTER:
            mean = 0.5 * (self.ncs_lo + self.ncs_hi)
            return -mean * math.log1p(-u)
        return base

    # -- helpers for models -------------------------------------------------
    def any_waking(self) -> bool:
        return any(t.state == WAKING for t in self.tasks)

    def _log(self, tid: int, event: str) -> None:
        if self.record_timeline:
            self.res.timeline.append((round(self.now, 12), tid, event))

    def start_cs(self, t: _Task) -> None:
        t.state = CS
        t.remaining = self.draw_cs(t.tid)
        self._log(t.tid, "cs_start")

    def schedule_wake(self, t: _Task) -> None:
        assert t.state == SLEEP
        t.state = WAKING
        t.wake_at = self.now + self._wake_delay(t.tid)
        self.res.wake_count += 1
        self._log(t.tid, "wake_scheduled")

    def schedule_wake_direct(self, t: _Task) -> None:
        """A banked permit absorbed the sleep: still pays the park/unpark
        round-trip latency (the thread had committed to sleeping)."""
        t.state = WAKING
        t.wake_at = self.now + self._wake_delay(t.tid)
        self.res.wake_count += 1
        self._log(t.tid, "wake_banked")

    # -- main loop ------------------------------------------------------------
    def run(self, target_cs: int = 1000, horizon: float = 1e9) -> SimResult:
        ncs_mean = 0.5 * (self.ncs_lo + self.ncs_hi)
        if self.open_loop:
            # threads start free; logical requests arrive and bind to them
            for t in self.tasks:
                t.state = DONE
            self._next_arr = self._draw_next_arrival(0.0)
            self._admit_due_arrivals()
            self._bind_queued()
        else:
            for t in self.tasks:
                t.state = NCS
                # seeded per-thread arrival-order randomization: stagger
                # first arrivals by up to arrival_phase mean-NCS lengths
                t.remaining = (self.draw_ncs(t.tid)
                               + self._wl_phase[t.tid] * self.arrival_phase
                               * ncs_mean)

        while self.res.completed_cs < target_cs and self.now < horizon:
            runnable = [t for t in self.tasks if t.state in (CS, NCS, SPIN)]
            if not runnable:
                wakes = [t for t in self.tasks if t.state == WAKING]
                if not wakes:
                    if self.open_loop and self._next_arr < horizon:
                        self.now = self._next_arr
                        self._admit_due_arrivals()
                        self._bind_queued()
                        continue
                    break  # all DONE (or a model bug; tests assert progress)
                nxt = min(wakes, key=lambda t: t.wake_at)
                self.now = min(nxt.wake_at, self._next_arr)
                if self.now >= nxt.wake_at:
                    self._wake(nxt)
                if self.open_loop:
                    self._admit_due_arrivals()
                    self._bind_queued()
                continue

            rate = min(1.0, self.cores / len(runnable))
            n_spin = sum(1 for t in runnable if t.state == SPIN)
            holder_rate = rate / (1.0 + self.model.alpha * n_spin)
            has_budget = isinstance(self.model, AdaptiveModel)

            # per-(thread, window) fault multipliers; piecewise-constant
            # within a window, so intervals are capped at the boundary
            mult: dict[int, float] | None = None
            if self._faulted:
                win = self._fault_window()
                mult = {t.tid: self._fault_mult(t, win)
                        for t in runnable if t.state in (CS, NCS)}

            dt = float("inf")
            for t in runnable:
                if t.state == CS:
                    r = holder_rate * (mult[t.tid] if mult is not None
                                       else 1.0)
                    if r > 0.0:
                        dt = min(dt, t.remaining / r)
                elif t.state == NCS:
                    r = rate * (mult[t.tid] if mult is not None else 1.0)
                    if r > 0.0:
                        dt = min(dt, t.remaining / r)
                elif has_budget:  # SPIN with budget
                    dt = min(dt, t.remaining / rate)
            for t in self.tasks:
                if t.state == WAKING:
                    dt = min(dt, t.wake_at - self.now)
            ne = self.model.next_event()
            if ne < float("inf"):
                dt = min(dt, ne - self.now)
            if self.open_loop and self._next_arr < float("inf"):
                dt = min(dt, self._next_arr - self.now)
            if mult is not None:
                dt = min(dt, (win + 1) * self.fault_scale - self.now)
            dt = max(dt, 0.0)
            assert dt != float("inf")

            self.now += dt
            finished: list[_Task] = []
            for t in runnable:
                if t.state == CS:
                    m = mult[t.tid] if mult is not None else 1.0
                    t.remaining -= dt * holder_rate * m
                    if t.remaining <= 1e-15:
                        finished.append(t)
                elif t.state == NCS:
                    m = mult[t.tid] if mult is not None else 1.0
                    t.remaining -= dt * rate * m
                    if t.remaining <= 1e-15:
                        finished.append(t)
                else:  # SPIN
                    burn = dt * rate
                    t.spin_cpu += burn
                    self.res.spin_cpu += burn
                    if has_budget:
                        t.remaining -= burn
                        if t.remaining <= 1e-15:
                            self.model.on_spin_budget_exhausted(t)
            for t in self.tasks:
                if t.state == WAKING and t.wake_at <= self.now + 1e-15:
                    self._wake(t)

            for t in sorted(finished, key=lambda x: x.tid):
                if t.state == CS:
                    t.cs_done += 1
                    self.res.completed_cs += 1
                    self._log(t.tid, "cs_end")
                    self.model.on_release(t)
                    if self.open_loop:
                        # departure: record the request's sojourn, free tid
                        lat = self.now - self._req_t.pop(t.tid)
                        self.res.latencies.append(lat)
                        if lat > self.slo:
                            self.res.slo_viol += 1
                        t.state = DONE
                    elif (self.max_cs_per_thread is not None
                            and t.cs_done >= self.max_cs_per_thread):
                        t.state = DONE
                    else:
                        t.state = NCS
                        t.remaining = self.draw_ncs(t.tid)
                elif t.state == NCS:
                    self._log(t.tid, "arrive")
                    self.model.on_arrive(t)

            # model-internal timers (e.g. backoff polls) fire AFTER releases
            # at the same instant, matching the engine's stage order
            # (release/wake, then poll pickup, then arrivals).
            self.model.on_time_advanced()

            if self.open_loop:
                self._admit_due_arrivals()
                self._bind_queued()

        self.res.t_end = self.now
        return self.res

    def _wake(self, t: _Task) -> None:
        self._log(t.tid, "wake_complete")
        self.model.on_wake_complete(t)


def simulate(lock: str, threads: int, cores: int = 20,
             cs: tuple[float, float] = (0.0, 3.7e-6),
             ncs: tuple[float, float] = (0.0, 3.7e-6),
             wake_latency: float = 5e-6, target_cs: int = 2000,
             seed: int = 0, **kw) -> SimResult:
    """One lockbench cell (paper Fig. 3) under the DES."""
    return LockSim(lock, threads, cores, cs, ncs, wake_latency,
                   seed=seed, **kw).run(target_cs=target_cs)

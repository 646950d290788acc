"""Continuous-batching scheduler driven by the paper's spinning window.

The PyTorch port's copy of ``repro/serve/scheduler.py``: ``SchedStats``,
``ContinuousBatcher``, and the scheduler-policy sweep through the batched
simulator (``SCHED_POLICY_LOCKS``, ``SchedScenario``,
``sample_sched_scenarios``, ``xdes_policy_sweep``), which runs on the card
through the ``lock_sim_block`` kernels (``device="cpu"`` for the plain
versions).

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
from dataclasses import replace as dataclass_replace

from repro_torch.core.oracle import EvalSWS, FixedOracle, Oracle
from repro_torch.core.policy import QUEUE_MAX, SimConfig
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


# --------------------------------------------------------------------------
# Scheduler-policy ablations through xdes — slot/standby dynamics encoded
# on the shared SimConfig row schema, so admission policies sweep on-device
# in the same batched call as the lock disciplines.
# --------------------------------------------------------------------------

#: Admission policy -> the discipline row that models it (DESIGN.md §3.2
#: mapping).  ``zero`` = no standby, every handoff pays prefill in the
#: open (the sleep lock: every waiter parked, wake latency exposed);
#: ``max`` = every waiting request held hot (the spin lock: every waiter
#: spinning, prefill always masked, residency maximal); ``mutable`` = the
#: paper's EvalSWS-tuned standby window.
SCHED_POLICY_LOCKS = {
    "zero": "sleep",
    "sleep": "sleep",
    "max": "ttas",
    "spin": "ttas",
    "mutable": "mutable",
}


@dataclass(frozen=True)
class SchedScenario:
    """One serving workload on the shared row schema.

    ``slots`` decode slots serve ``requests`` circulating requests; a slot
    is held for up to ``decode_s`` seconds per handoff (the CS), a retired
    request regenerates after up to ``think_s`` (the NCS), and promoting a
    cold request costs ``prefill_s`` (the OS wake-up latency).  Standby
    residency maps to spin CPU; cold promotions map to wake-ups.

    ``workload`` selects a hold-time row from
    :data:`repro_torch.core.policy.WORKLOAD_ROWS` on the same schema:
    ``bursty`` models diurnal/batchy admission (each request's think time
    stretches ``wl_burst`` x outside its ON window — traffic arrives in
    waves),
    ``hetero`` models mixed decode lengths (chat next to long-form
    generation), ``jitter`` models Poisson request arrivals.

    ``arrival`` turns the scenario OPEN-LOOP on the same schema
    (:data:`repro_torch.core.policy.ARRIVAL_ROWS`): instead of ``requests``
    circulating forever, logical requests arrive at ``arrival_rate_rps``
    (the ``bursty`` row gates the rate through the ``wl_period_s`` /
    ``wl_duty`` burst phase), queue up to ``queue_cap`` deep (admission
    reads queue depth; offered load past saturation is shed), bind to one
    of the ``requests`` workers, and depart with a recorded sojourn —
    per-request p50/p95/p99 and the fraction violating ``slo_s`` come
    from the engine's on-device latency histograms.

    ``fault`` selects an interference row from
    :data:`repro_torch.core.policy.FAULT_ROWS` on the same schema, in serving
    terms: ``preempt`` models a decode slot losing its device for whole
    windows (host preemption, GC pauses), ``oversub`` a fractional
    steady-state slowdown (noisy neighbours), ``lostwake`` a missed
    promotion callback recovered only after a ``fault_scale_s`` timeout,
    and ``jitter`` variable cold-start latency.  ``fault_scale_s = 0``
    auto-scales the fault window to 4 mean decode+think rounds (see
    docs/robustness.md).
    """

    slots: int
    requests: int
    decode_s: float = 50e-3
    think_s: float = 100e-3
    prefill_s: float = 8e-3
    seed: int = 0
    workload: str = "constant"
    wl_period_s: float = 0.0      # bursty cycle length; 0 -> auto-scaled
    wl_duty: float = 0.25
    wl_burst: float = 8.0
    wl_spread: float = 4.0
    arrival: str = "closed"       # open-loop arrival row (ARRIVAL_ROWS)
    arrival_rate_rps: float = 0.0
    queue_cap: int = QUEUE_MAX
    slo_s: float = 0.5            # per-request sojourn SLO (seconds)
    fault: str = "none"           # interference row (FAULT_ROWS)
    fault_rate: float = 0.0
    fault_scale_s: float = 0.0    # fault window; 0 -> auto-scaled

    @property
    def capacity_rps(self) -> float:
        """Closed-form service-capacity estimate (requests/s): the slot
        pool serializes at one handoff per mean decode hold, and below
        that each effective worker turns over a request per mean
        decode+think round."""
        mean_decode = 0.5 * self.decode_s
        mean_round = 0.5 * (self.decode_s + self.think_s)
        eff = min(self.requests, self.slots)
        return min(1.0 / max(mean_decode, 1e-12),
                   eff / max(mean_round, 1e-12))

    def to_sim_config(self, policy: str) -> SimConfig:
        """Encode this scenario under an admission policy as a SimConfig
        row — directly batchable with lock-sweep rows."""
        if policy not in SCHED_POLICY_LOCKS:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"options: {sorted(SCHED_POLICY_LOCKS)}")
        period = self.wl_period_s or 8.0 * (self.decode_s + self.think_s)
        return SimConfig(SCHED_POLICY_LOCKS[policy],
                         threads=self.requests, cores=self.slots,
                         cs=(0.0, self.decode_s), ncs=(0.0, self.think_s),
                         wake_latency=self.prefill_s, alpha=0.0,
                         seed=self.seed, workload=self.workload,
                         wl_period=period, wl_duty=self.wl_duty,
                         wl_burst=self.wl_burst, wl_spread=self.wl_spread,
                         arrival=self.arrival,
                         arrival_rate=self.arrival_rate_rps,
                         queue_cap=self.queue_cap, slo=self.slo_s,
                         fault=self.fault, fault_rate=self.fault_rate,
                         fault_scale=self.fault_scale_s
                         or 4.0 * (self.decode_s + self.think_s))


def sample_sched_scenarios(n_scenarios: int, seed: int = 0,
                           slots=(4, 8, 16),
                           workload: str = "constant",
                           arrival: str = "closed"
                           ) -> list[SchedScenario]:
    """Random serving workloads: under- to over-subscribed slot pools,
    decode/think/prefill times log-uniform across serving-realistic
    scales.  Stable draw order (the sweep-seed contract of
    :func:`repro_torch.configs.catalog.sample_scenarios`): the base stream is
    untouched by ``workload`` and ``arrival``, so e.g. the bursty-
    admission sweep sees the SAME machines scenario-by-scenario as the
    constant one — the workload and arrival knobs come from separate
    salted streams.  ``arrival != "closed"`` makes the scenarios
    open-loop, with the offered load drawn from under-load to past
    saturation (0.3-1.2 x :attr:`SchedScenario.capacity_rps`) and the SLO
    at 8 mean decode+think rounds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    wl_rng = np.random.default_rng(seed ^ 0x9E3779B9)
    ar_rng = np.random.default_rng(seed ^ 0x3C6EF372)
    out = []
    for i in range(n_scenarios):
        s = int(rng.choice(slots))
        kw = {}
        if workload == "bursty":
            kw = dict(wl_duty=float(wl_rng.uniform(0.15, 0.5)),
                      wl_burst=float(wl_rng.uniform(4.0, 16.0)))
        elif workload == "hetero":
            kw = dict(wl_spread=float(wl_rng.uniform(2.0, 8.0)))
        sc = SchedScenario(
            slots=s,
            requests=int(rng.integers(s, 4 * s + 1)),
            decode_s=float(np.exp(rng.uniform(np.log(5e-3), np.log(2e-1)))),
            think_s=float(np.exp(rng.uniform(np.log(1e-2), np.log(5e-1)))),
            prefill_s=float(np.exp(rng.uniform(np.log(2e-3), np.log(5e-2)))),
            seed=i, workload=workload, **kw)
        if arrival != "closed":
            rho = float(ar_rng.uniform(0.3, 1.2))
            sc = dataclass_replace(
                sc, arrival=arrival,
                arrival_rate_rps=rho * sc.capacity_rps,
                slo_s=4.0 * (sc.decode_s + sc.think_s))
        out.append(sc)
    return out


def xdes_policy_sweep(scenarios, policies=("zero", "max", "mutable"), *,
                      target_cs: int = 150, backend: str = "kernel",
                      shard: bool | None = None, verbose: bool = False,
                      device=None) -> dict:
    """Sweep every admission policy over every serving scenario in ONE
    batched :func:`repro_torch.core.xdes.simulate_batch` call
    (scenario-major, policy-minor row order), on the card through the
    ``lock_sim_block`` kernels (``backend="ref"``: their plain versions;
    ``device="cpu"``: on the host; ``shard`` splits the batch over the
    shard devices as :func:`repro_torch.core.xdes.simulate_batch` does).

    Returns per-policy aggregates in the scheduler's vocabulary:
    ``handoffs_per_s`` (throughput), ``cold_promotions_per_handoff``
    (wake-ups per CS — the late-handoff analogue) and
    ``standby_s_per_handoff`` (spin CPU per CS — hot-pool residency).
    Open-loop scenarios (``SchedScenario.arrival != "closed"``) add
    per-request tail latency (``p50/p95/p99_s`` from the on-device
    histograms), ``slo_violation_frac`` and ``shed_frac``.
    """
    import numpy as np

    from repro_torch.core import xdes

    scenarios = list(scenarios)
    configs = [sc.to_sim_config(p) for sc in scenarios for p in policies]
    res = xdes.simulate_batch(configs, target_cs=target_cs,
                              backend=backend, shard=shard, device=device)
    S, Pn = len(scenarios), len(policies)
    thr = res.throughput.reshape(S, Pn)
    wake = (res.wake_count / np.maximum(res.completed, 1)).reshape(S, Pn)
    standby = res.sync_cpu_per_cs.reshape(S, Pn)
    best = np.maximum(thr.max(axis=1), 1e-30)
    open_loop = any(c.open_loop for c in configs)

    out = {"meta": {"n_scenarios": S, "n_configs": len(configs),
                    "n_steps": res.n_steps, "backend": res.backend,
                    "open_loop": open_loop},
           "policies": {}}
    for j, p in enumerate(policies):
        out["policies"][p] = {
            "handoffs_per_s": float(thr[:, j].mean()),
            "mean_ratio_to_best": float((thr[:, j] / best).mean()),
            "cold_promotions_per_handoff": float(wake[:, j].mean()),
            "standby_s_per_handoff": float(standby[:, j].mean()),
        }
        if open_loop:
            sl = (slice(None), j)
            shed_frac = (res.shed.reshape(S, Pn)[sl]
                         / np.maximum(res.arrived.reshape(S, Pn)[sl], 1))
            out["policies"][p].update(
                p50_s=float(np.nanmean(res.p50.reshape(S, Pn)[sl])),
                p95_s=float(np.nanmean(res.p95.reshape(S, Pn)[sl])),
                p99_s=float(np.nanmean(res.p99.reshape(S, Pn)[sl])),
                slo_violation_frac=float(
                    np.nanmean(res.slo_frac.reshape(S, Pn)[sl])),
                shed_frac=float(shed_frac.mean()))
        if verbose:
            r = out["policies"][p]
            line = (f"{p:>8} handoffs/s {r['handoffs_per_s']:9.1f} "
                    f"ratio {r['mean_ratio_to_best']:5.3f} "
                    f"cold/handoff {r['cold_promotions_per_handoff']:5.3f} "
                    f"standby s/handoff {r['standby_s_per_handoff']:.4f}")
            if open_loop:
                line += (f" p95 {r['p95_s']:.4f}s "
                         f"slo-viol {r['slo_violation_frac']:.3f} "
                         f"shed {r['shed_frac']:.3f}")
            print(line)
    return out

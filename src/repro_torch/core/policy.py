"""Shared lock-policy core of the PyTorch port — registries and encoders.

The port's own copy of the policy registries: thread-state and discipline
ids, seed salts, the oracle / discipline / workload / arrival / fault rows,
:class:`SimConfig` and the struct-of-arrays encoders.  It mirrors
``repro/core/policy.py`` id for id and salt for salt (pinned by
``tests/test_torch_policy.py``) but shares no code with it: this package
imports ``torch`` and ``numpy`` only.

Every row function is branch-free arithmetic on its arguments, so the same
body runs on Python scalars, numpy arrays and torch tensors.  On torch
tensors ``(x == pid) * 1`` yields int64; the callers in
:mod:`repro_torch.kernels.ref` cast back to int32 at the boundary so the
simulator state stays int32 / float32.  The CUDA kernel
(``kernels/csrc/lock_sim_block.cu``) cannot call these Python rows; it
implements every registered id by hand, and
``tests/test_torch_kernel_contract.py`` fails when a registry gains an id
the kernel does not admit.

Line-number comments (A*, R*, E*) refer to Algorithm 1 in the paper.
"""

from __future__ import annotations

from dataclasses import dataclass

# --------------------------------------------------------------------------
# Thread states — shared by the event-driven DES, the batched simulator and
# the CUDA block kernel (one integer encoding everywhere).
# --------------------------------------------------------------------------
NCS, CS, SPIN, SLEEP_ST, WAKING, DONE = range(6)
STATE_NAMES = ("NCS", "CS", "SPIN", "SLEEP", "WAKING", "DONE")

# --------------------------------------------------------------------------
# Discipline ids — shared by the DES model registry, the batched simulator's
# integer encoding, and the CUDA kernel.  ``fifo`` is the true-MCS
# handoff discipline: waiters take numbered tickets and the lock is granted
# strictly in ticket (arrival) order — no barging.
# --------------------------------------------------------------------------
TAS, TTAS, MCS, SLEEP, ADAPTIVE, MUTABLE, FIFO = range(7)
# Related-work rows (PAPERS.md): Fissile-style spin-then-park with an
# oracle-tuned budget, Hapax value-based strict-FIFO admission, and
# TTAS with seeded bounded-exponential backoff.
FISSILE, HAPAX, TTAS_BACKOFF = 7, 8, 9

POLICY_IDS = {
    "tas": TAS,
    "ttas": TTAS,
    "mcs": MCS,
    "sleep": SLEEP,
    "adaptive": ADAPTIVE,
    "mutable": MUTABLE,
    "fifo": FIFO,
    "fissile": FISSILE,
    "hapax": HAPAX,
    "ttas_backoff": TTAS_BACKOFF,
}
POLICY_NAMES = {v: k for k, v in POLICY_IDS.items()}

#: Hardware-contention coefficient per discipline (paper §2): the CS
#: holder's progress rate is divided by ``1 + alpha * n_spinners``.  MCS
#: spins on private cache lines (no coherency pressure); TAS hammers the
#: lock word with RMWs (worst); TTAS/adaptive/mutable read-spin (mild);
#: FIFO inherits MCS's private-line spinning.
DEFAULT_ALPHA = {
    "tas": 0.05,
    "ttas": 0.02,
    "mcs": 0.0,
    "sleep": 0.0,
    "adaptive": 0.02,
    "mutable": 0.02,
    "fifo": 0.0,
    "fissile": 0.02,        # read-spins during its bounded window
    "hapax": 0.0,           # never spins: every waiter parks in FIFO order
    "ttas_backoff": 0.01,   # backoff thins the coherency traffic vs ttas
}

#: glibc-style default spin budget (CPU-seconds) for the adaptive mutex.
DEFAULT_SPIN_BUDGET = 2e-6

#: Seed salt for the ttas_backoff per-(thread, step) backoff-delay
#: uniforms — disjoint from every WL/AR/TB/FLT salt so backoff never
#: perturbs workload, arrival, tie-break or fault draws.
BO_SALT = 0x165667B1

#: Bounded-exponential cap: a backoff delay never exceeds
#: ``spin_budget * 2**BO_CAP`` seconds (the classic truncated-binary
#: exponential backoff rule).
BO_CAP = 6


# --------------------------------------------------------------------------
# Oracle family ids — shared by
# the batched simulator's integer encoding, and the standalone oracle
# plain version (repro_torch.kernels.ref).  See docs/oracles.md
# for the update rules and provenance of each family.
# --------------------------------------------------------------------------
ORACLE_EVALSWS, ORACLE_AIMD, ORACLE_FIXED, ORACLE_HISTORY = range(4)

ORACLE_IDS = {
    "paper": ORACLE_EVALSWS,       # EvalSWS E1-E12: double / -1
    "aimd": ORACLE_AIMD,           # +1 on late wake, halve after K clean
    "fixed": ORACLE_FIXED,         # glibc/Oracle-RDBMS fixed retrial budget
    "history": ORACLE_HISTORY,     # EWMA of the late-wake rate
}
ORACLE_NAMES = {v: k for k, v in ORACLE_IDS.items()}

#: Q8.8-style fixed point for the history oracle's EWMA state: ``ewma`` is
#: the late-wake rate scaled by EWMA_ONE, smoothed with weight 1/2**EWMA_SHIFT
#: per acquisition (glibc's adaptive mutex smooths its spin count the same
#: way: ``__spins += (cnt - __spins) / 8``).
EWMA_ONE = 256
EWMA_SHIFT = 3


# --------------------------------------------------------------------------
# EvalSWS — the paper's oracle (E1-E12) as a pure function
# --------------------------------------------------------------------------
def eval_sws_delta(spun: bool, slept: bool, sws: int, cnt: int,
                   k: int) -> tuple[int, int]:
    """One EvalSWS observation.  Returns ``(delta, cnt')``.

    ``cnt`` counts consecutive acquisitions without a late wake-up; a late
    wake-up (``slept and not spun``) doubles the window (E4-E6), ``k`` clean
    acquisitions shrink it by one (E7-E9).
    """
    cnt = cnt + 1                      # E2
    if slept and not spun:             # E4: late wake-up detected
        return sws, 0                  # E5-E6: double, reset counter
    if cnt >= k:                       # E7 (>= guards lost updates)
        return -1, 0                   # E8-E9
    return 0, cnt                      # E3/E11


def clamp_delta(sws: int, delta: int, lo: int, hi: int) -> int:
    """A16-A17: clamp so that ``lo <= sws + delta <= hi``."""
    if sws + delta < lo:
        delta = lo - sws
    if sws + delta > hi:
        delta = hi - sws
    return delta


# --------------------------------------------------------------------------
# Oracle family rows — branch-free, integer-state pure functions.
#
# Every row has the same shape: ``(spun, slept, sws, cnt, ewma, k)`` in,
# ``(delta, cnt', ewma')`` out, where ``delta`` is the *unclamped* window
# variation (the caller applies A16-A17 via :func:`clamp_delta` /
# ``jnp.clip``), ``cnt`` is the clean-acquisition counter and ``ewma`` the
# history oracle's fixed-point late-wake rate (unused state passes through
# unchanged).  Selection is arithmetic (``flag * a + (1-flag) * b``), never
# ``if``, so the SAME code runs on plain Python ints (threaded oracles in
# the reference package), numpy arrays and torch tensors inside the
# batched simulator's step — one implementation, bit-identical
# everywhere.  ``spun``/``slept`` must arrive as 0/1 integers (or boolean
# arrays); :func:`oracle_update` normalizes them.
# --------------------------------------------------------------------------
def oracle_evalsws_row(spun, slept, sws, cnt, ewma, k):
    """Paper EvalSWS (E1-E12): double on a late wake-up, -1 after ``k``
    clean acquisitions.  Branch-free form of :func:`eval_sws_delta`."""
    cnt1 = cnt + 1                                    # E2
    late = slept * (1 - spun)                         # E4
    hitk = (cnt1 >= k) * (1 - late)                   # E7 (late wins)
    delta = late * sws + hitk * (-1)                  # E5 / E8
    cnt1 = (1 - late) * (1 - hitk) * cnt1             # E6 / E9 / E11
    return delta, cnt1, ewma


def oracle_aimd_row(spun, slept, sws, cnt, ewma, k):
    """Additive-increase / multiplicative-decrease (Fissile-style backoff
    splitting): +1 on a late wake-up, halve after ``k`` clean rounds — the
    opposite bias to the paper (favors small windows / CPU savings)."""
    cnt1 = cnt + 1
    late = slept * (1 - spun)
    hitk = (cnt1 >= k) * (1 - late)
    delta = late * 1 + hitk * (-(sws // 2))
    cnt1 = (1 - late) * (1 - hitk) * cnt1
    return delta, cnt1, ewma


def oracle_fixed_row(spun, slept, sws, cnt, ewma, k):
    """Fixed-budget retrial (glibc ``spin_count`` cap / Oracle RDBMS
    ``_spin_count``, Nikolaev 2012): the window is pinned at the budget
    ``k`` — no adaptation, spin slots are a constant retrial allowance.
    ``delta`` drives ``sws`` to ``k`` (the A16-A17 clamp caps it at
    ``sws_max``)."""
    return k - sws, cnt * 0, ewma


def oracle_history_row(spun, slept, sws, cnt, ewma, k):
    """History-based: an EWMA of the late-wake indicator (fixed point,
    :data:`EWMA_ONE` = rate 1.0, smoothing 1/2**:data:`EWMA_SHIFT` — the
    glibc adaptive-mutex smoothing rule applied to the paper's late-wake
    signal).  Grow (double) when the smoothed rate exceeds twice the
    paper's target rate 1/(k+1); shrink by one when it falls below half
    the target.  Reacts slower than EvalSWS but is robust to one-off
    wake-latency spikes."""
    late = slept * (1 - spun)
    ewma1 = ewma + ((late * EWMA_ONE - ewma) >> EWMA_SHIFT)
    target = EWMA_ONE // (k + 1)
    grow = (ewma1 > 2 * target) * 1
    shrink = (2 * ewma1 < target) * (1 - grow)
    delta = grow * sws + shrink * (-1)
    return delta, cnt * 0, ewma1


#: Row functions indexed by oracle id (the dispatch order of oracle_update).
ORACLE_ROWS = (oracle_evalsws_row, oracle_aimd_row, oracle_fixed_row,
               oracle_history_row)


def oracle_update(oracle_id, spun, slept, sws, cnt, ewma, k):
    """Dispatch one oracle observation by ``oracle_id``.

    Arithmetic select over :data:`ORACLE_ROWS`, so it is valid on scalars
    and arrays alike; inside the batched simulator ``oracle_id`` is a
    per-config int32 column and every row is evaluated elementwise with the
    winner chosen by mask — branch-free, one fused program.  Returns
    ``(delta, cnt', ewma')`` with ``delta`` unclamped (apply A16-A17).
    """
    spun = spun * 1
    slept = slept * 1
    delta = cnt1 = ewma1 = 0
    for oid, row in enumerate(ORACLE_ROWS):
        sel = (oracle_id == oid) * 1
        d, c, e = row(spun, slept, sws, cnt, ewma, k)
        delta = delta + sel * d
        cnt1 = cnt1 + sel * c
        ewma1 = ewma1 + sel * e
    return delta, cnt1, ewma1


# --------------------------------------------------------------------------
# Arrival / release decisions (A7, R2-R21)
# --------------------------------------------------------------------------
def should_sleep_on_arrival(thc_pre: int, sws: int) -> bool:
    """A7: a thread arriving at index ``thc_pre`` (holder at 0) sleeps iff
    it lands outside the spinning window."""
    return thc_pre >= sws


def wake_correction(delta: int, thc: int, sws_pre: int) -> int:
    """C1/C2 wake-up-count correction (A23-A33), the signed increment to
    ``wuc`` after a resize ``sws_pre -> sws_pre + delta``.

    C1 (grow with sleepers, A27-A28): threads that went to sleep because
    the window was full would now fit — wake up to ``delta`` of them.
    C2 (shrink with excess spinners, A25-A26): more threads are inside the
    window than it now holds — suppress up to ``-delta`` future wake-ups.
    """
    sws_post = sws_pre + delta
    if delta < 0 and thc > sws_post:             # A25: C2
        tmp = thc - sws_post                     # A26
    elif delta > 0 and thc > sws_pre:            # A27: C1
        tmp = thc - sws_pre                      # A28
    else:
        tmp = 0                                  # A30
    sign = 1 if delta > 0 else -1                # A24
    return sign * min(abs(delta), tmp)           # A32


def latch_wuc(wuc: int) -> tuple[int, int]:
    """RELEASE lines R2-R7: latch the wake-up count at release time.

    Returns ``(r_wuc, wuc')``.  ``r_wuc < 0`` means this release is
    suppressed by a pending C2 correction (R6-R7, R11-R12) and must issue
    no wake-up at all.  Latching happens *before* the lock is handed off /
    unlocked, so corrections appended by the next acquirer belong to the
    next release.
    """
    if wuc >= 0:                                 # R2
        return wuc, 0                            # R3-R4
    return -1, wuc + 1                           # R6-R7: C2 suppression


def release_quota(r_wuc: int, thc_pre: int, sws: int) -> int:
    """RELEASE lines R11-R17: permits actually issued by this release.

    ``r_wuc`` is the latched value from :func:`latch_wuc`; ``thc_pre`` the
    thread count before the releaser's decrement (R9/R14); ``sws`` the
    window at R16 (post-handoff).  Adds the +1 sleep->spin promotion when
    sleepers exist (R16-R17); a suppressed release issues nothing.
    """
    if r_wuc < 0:                                # R11-R12
        return 0
    if thc_pre > sws:                            # R16: sleepers exist
        r_wuc += 1                               # R17: sleep->spin
    return r_wuc                                 # R19


# --------------------------------------------------------------------------
# Discipline rows — the waiting discipline as data, mirroring ORACLE_ROWS.
#
# A row describes ONE waiting discipline as (a) four 0/1 capability flags
# and (b) two elementwise decision functions.  Flags and functions are
# branch-free integer arithmetic, valid on plain Python ints, numpy arrays
# and torch tensors alike — exactly the contract of the oracle rows —
# so the SAME row drives the event-driven DES models, the batched
# transition engine (repro_torch.kernels.ref.lock_transitions_ref) and its
# CUDA twin (which implements each row by hand).  Adding a discipline is ~20 lines: one row here, one DES
# model for parity testing, one POLICY_IDS entry.
#
#   handoff       release grants the lock to a waiting spinner
#   fifo_grant    grant order is the arrival ticket, not the thread id
#   budget_spin   spinners consume a finite CPU budget, then park (glibc)
#   wake_to_spin  a woken thread that finds the lock taken joins the
#                 spinners (the mutable lock's sleep->spin transition)
#   repark        a woken thread that finds the lock taken parks again
#                 (the sleep/adaptive barging rule); disciplines that
#                 never park set both wake_to_spin and repark to 0
#   windowed      the discipline runs the SWS oracle + C1/C2 corrections
#   budget_scaled the spin budget is priced competitively: effective
#                 budget = spin_budget * sws * park_cost (Fissile's
#                 spin-roughly-the-park-cost rule, with the oracle's
#                 window as the adaptive multiplier)
#   backoff       spinners poll under seeded bounded-exponential backoff
#                 (BO_SALT stream) instead of being handed the lock
#
#   arrival_sleeps(rank, thc_pre, sws, holder_free) -> 0/1
#       whether the rank-th simultaneous arrival parks (A7 for the
#       mutable window; the sleep lock barges only when rank==0 finds
#       the lock free; spin disciplines never park on arrival).
#   quota(r_wuc, thc_pre, sws, n_parked, handoff_taken) -> int >= 0
#       wake permits granted by a release (R11-R17 for the mutable lock;
#       wake-one for sleep/adaptive; none for pure spin/FIFO).
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DisciplineRow:
    name: str
    policy_ids: tuple
    handoff: int
    fifo_grant: int
    budget_spin: int
    wake_to_spin: int
    repark: int
    windowed: int
    arrival_sleeps: object     # callable, elementwise (see module comment)
    quota: object              # callable, elementwise
    budget_scaled: int = 0
    backoff: int = 0


def _arrive_never(rank, thc_pre, sws, holder_free):
    return rank * 0


def _arrive_sleep_lock(rank, thc_pre, sws, holder_free):
    # Barge iff this is the first arrival of the step and the lock is free.
    return 1 - (rank == 0) * holder_free


def _arrive_window(rank, thc_pre, sws, holder_free):
    # A7: arriving at index thc_pre (holder at 0) outside the window parks.
    return (thc_pre >= sws) * 1


def _arrive_fifo_park(rank, thc_pre, sws, holder_free):
    # Hapax admission: acquire only when the lock is free AND nobody is
    # ahead (thc_pre counts holder + waiters); otherwise join the FIFO
    # parking queue — structurally no barging.
    return 1 - (thc_pre == 0) * holder_free


def _quota_zero(r_wuc, thc_pre, sws, n_parked, handoff_taken):
    return r_wuc * 0


def _quota_wake_one(r_wuc, thc_pre, sws, n_parked, handoff_taken):
    return (n_parked > 0) * 1


def _quota_wake_one_no_handoff(r_wuc, thc_pre, sws, n_parked, handoff_taken):
    return (n_parked > 0) * (1 - handoff_taken)


def _quota_mutable(r_wuc, thc_pre, sws, n_parked, handoff_taken):
    # R11-R17: a suppressed release (r_wuc < 0) grants nothing; otherwise
    # the latched count plus the sleep->spin promotion when sleepers exist.
    return (r_wuc >= 0) * (r_wuc + (thc_pre > sws))


DISCIPLINE_ROWS = {
    "spin": DisciplineRow(
        name="spin", policy_ids=(TAS, TTAS, MCS),
        handoff=1, fifo_grant=0, budget_spin=0, wake_to_spin=0, repark=0,
        windowed=0, arrival_sleeps=_arrive_never, quota=_quota_zero),
    "sleep": DisciplineRow(
        name="sleep", policy_ids=(SLEEP,),
        handoff=0, fifo_grant=0, budget_spin=0, wake_to_spin=0, repark=1,
        windowed=0, arrival_sleeps=_arrive_sleep_lock, quota=_quota_wake_one),
    "adaptive": DisciplineRow(
        name="adaptive", policy_ids=(ADAPTIVE,),
        handoff=1, fifo_grant=0, budget_spin=1, wake_to_spin=0, repark=1,
        windowed=0, arrival_sleeps=_arrive_never,
        quota=_quota_wake_one_no_handoff),
    "mutable": DisciplineRow(
        name="mutable", policy_ids=(MUTABLE,),
        handoff=1, fifo_grant=0, budget_spin=0, wake_to_spin=1, repark=0,
        windowed=1, arrival_sleeps=_arrive_window, quota=_quota_mutable),
    "fifo": DisciplineRow(
        name="fifo", policy_ids=(FIFO,),
        handoff=1, fifo_grant=1, budget_spin=0, wake_to_spin=0, repark=0,
        windowed=0, arrival_sleeps=_arrive_never, quota=_quota_zero),
    # Fissile-style spin-then-park: every arrival spins for a bounded
    # budget priced at the park round-trip (budget_scaled), parks when it
    # runs out, and a woken thread re-joins the spinners with a fresh
    # budget.  The SWS oracle tunes the budget multiplier: an acquisition
    # that had to park reads as a late wake (windowed=1 + the
    # budget_scaled spun-mask in oracle_acquire), doubling the window.
    "fissile": DisciplineRow(
        name="fissile", policy_ids=(FISSILE,),
        handoff=1, fifo_grant=0, budget_spin=1, wake_to_spin=1, repark=0,
        windowed=1, arrival_sleeps=_arrive_never,
        quota=_quota_wake_one_no_handoff, budget_scaled=1),
    # Hapax value-based FIFO admission: constant-time arrival (tail
    # enqueue) and unlock (head wake); every contended arrival parks with
    # a ticket and releases wake strictly in ticket order — no barging.
    "hapax": DisciplineRow(
        name="hapax", policy_ids=(HAPAX,),
        handoff=0, fifo_grant=1, budget_spin=0, wake_to_spin=0, repark=0,
        windowed=0, arrival_sleeps=_arrive_fifo_park,
        quota=_quota_wake_one),
    # TTAS with truncated-binary exponential backoff: spinners poll on a
    # seeded schedule (BO_SALT) and pick up a free lock when a poll lands;
    # releases grant nothing (handoff=0) — the poll IS the acquire path.
    "ttas_backoff": DisciplineRow(
        name="ttas_backoff", policy_ids=(TTAS_BACKOFF,),
        handoff=0, fifo_grant=0, budget_spin=0, wake_to_spin=0, repark=0,
        windowed=0, arrival_sleeps=_arrive_never, quota=_quota_zero,
        backoff=1),
}

#: policy id -> row (every POLICY_IDS entry must be claimed by one row).
POLICY_ROW = {pid: row for row in DISCIPLINE_ROWS.values()
              for pid in row.policy_ids}
assert sorted(POLICY_ROW) == sorted(POLICY_IDS.values()), \
    "every policy id must map to exactly one discipline row"

#: Derived views over the rows: which disciplines hand the lock to a
#: spinner on release, and which ever park a thread.  A new row updates
#: these automatically.
HANDOFF_POLICIES = frozenset(pid for pid, row in POLICY_ROW.items()
                             if row.handoff)
SLEEPING_POLICIES = frozenset(
    pid for pid, row in POLICY_ROW.items()
    if row.repark or row.windowed or row.budget_spin
    or row.arrival_sleeps is not _arrive_never)


def _dispatch_rows(policy_id, fn):
    """Masked arithmetic select of ``fn(row)`` over DISCIPLINE_ROWS —
    the discipline twin of :func:`oracle_update`'s dispatch loop."""
    out = 0
    for row in DISCIPLINE_ROWS.values():
        sel = 0
        for pid in row.policy_ids:
            sel = sel + (policy_id == pid) * 1
        out = out + sel * fn(row)
    return out


#: Attribute order of :func:`discipline_flags` — unpack sites must match.
DISCIPLINE_FLAG_ATTRS = ("handoff", "fifo_grant", "budget_spin",
                         "wake_to_spin", "repark", "windowed",
                         "budget_scaled", "backoff")


def discipline_flags(policy_id):
    """Per-config capability flags ``(handoff, fifo_grant, budget_spin,
    wake_to_spin, repark, windowed, budget_scaled, backoff)`` as 0/1
    values, dispatched by policy id.  Valid on scalars and integer arrays
    (arithmetic select, no ``if``)."""
    return tuple(_dispatch_rows(policy_id, lambda r, a=attr: getattr(r, a))
                 for attr in DISCIPLINE_FLAG_ATTRS)


def discipline_arrival_sleeps(policy_id, rank, thc_pre, sws, holder_free):
    """0/1: does the ``rank``-th simultaneous arrival park?  Elementwise
    over threads; ``holder_free`` is 0/1."""
    return _dispatch_rows(
        policy_id, lambda r: r.arrival_sleeps(rank, thc_pre, sws,
                                              holder_free))


def discipline_release_quota(policy_id, r_wuc, thc_pre, sws, n_parked,
                             handoff_taken):
    """Wake permits granted by a release under each discipline's rule
    (the array form of :func:`release_quota` plus the sleep/adaptive
    wake-one rules).  ``handoff_taken`` is 0/1."""
    return _dispatch_rows(
        policy_id, lambda r: r.quota(r_wuc, thc_pre, sws, n_parked,
                                     handoff_taken))


# --------------------------------------------------------------------------
# Workload rows — the hold-time model as data, mirroring ORACLE_ROWS and
# DISCIPLINE_ROWS.
#
# The paper evaluates fixed CS/NCS draws; its robustness pitch ("scarce or
# none knowledge about the actual workload") only shows up under
# non-stationary workloads.  Every workload is therefore a row: a named,
# branch-free transformation of the base uniform CS/NCS draw, dispatched
# per config by an integer id exactly like the oracle and discipline rows.
#
# A row's ``hold`` function is pure arithmetic on caller-precomputed
# inputs, so ONE implementation runs on plain Python floats (the DES twin
# checks against it), numpy arrays, and torch tensors inside the
# kernels:
#
#   hold(is_ncs, base, expd, gate_off, tscale, burst) -> duration
#     is_ncs    0/1 static flag: is this an NCS (arrival-gap) draw?
#     base      the uniform draw  lo + u * (hi - lo)
#     expd      the exponential deviate  mean_ncs * -log1p(-u)  (same u)
#     gate_off  0/1: thread is in the OFF phase of its duty cycle
#     tscale    persistent per-thread scale from the seeded spread
#     burst     the OFF-phase NCS stretch factor
#
# ``gate_off`` and ``tscale`` derive from two persistent per-(config,
# thread) uniforms drawn from the counter RNG under dedicated salts
# (WL_PHASE_SALT / WL_SPREAD_SALT), so they are deterministic, replayable,
# and independent of the event-draw stream.  The dispatch is an arithmetic
# select; the constant row returns ``base`` untouched, so constant-workload
# configs are bit-identical to the pre-registry engine.
# --------------------------------------------------------------------------
WL_CONSTANT, WL_BURSTY, WL_HETERO, WL_JITTER = range(4)

WORKLOAD_IDS = {
    "constant": WL_CONSTANT,   # the paper's fixed uniform draws
    "bursty": WL_BURSTY,       # ON/OFF duty cycle: time-varying NCS
    "hetero": WL_HETERO,       # per-thread CS/NCS scale from a seeded spread
    "jitter": WL_JITTER,       # Poisson-like arrivals: exponential NCS
}
WORKLOAD_NAMES = {v: k for k, v in WORKLOAD_IDS.items()}

#: Seed salts for the persistent per-thread workload uniforms (XOR-ed into
#: the config seed so the streams never collide with event draws).
WL_PHASE_SALT = 0x7F4A7C15     # duty-cycle phase + arrival-order offset
WL_SPREAD_SALT = 0x6C62272E    # heterogeneous per-thread scale


def counter_uniform_scalar(seed: int, tid: int, ctr: int = 0) -> float:
    """Pure-Python mirror of :func:`repro_torch.kernels.ref.counter_uniform`
    (same splitmix-style avalanche, mod-2**32 arithmetic), so the DES twin
    realizes the SAME persistent per-thread workload state — duty-cycle
    phases, heterogeneity scales, arrival offsets — as the batched engine
    for a given (seed, tid)."""
    m = 0xFFFFFFFF
    x = (seed ^ (tid * 0x9E3779B9) ^ ((ctr + 1) * 0x85EBCA6B)) & m
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    x ^= x >> 16
    return x * 2.0 ** -32


@dataclass(frozen=True)
class WorkloadRow:
    name: str
    wid: int
    time_varying: int          # 1 iff the row reads the current time
    hold: object               # callable, elementwise (see module comment)


def _hold_constant(is_ncs, base, expd, gate_off, tscale, burst):
    return base


def _hold_bursty(is_ncs, base, expd, gate_off, tscale, burst):
    # ON/OFF duty cycle as time-varying NCS (Fissile-style contention
    # burstiness): an OFF-phase thread's arrival gap stretches by `burst`;
    # CS lengths are untouched.
    return base * (1 + is_ncs * gate_off * (burst - 1))


def _hold_hetero(is_ncs, base, expd, gate_off, tscale, burst):
    # Heterogeneous threads (mixed decode lengths): every draw scaled by
    # the thread's persistent log-uniform factor in [1/spread, spread].
    return base * tscale


def _hold_jitter(is_ncs, base, expd, gate_off, tscale, burst):
    # Poisson-like arrivals: NCS becomes an exponential deviate with the
    # uniform row's mean, so arrival gaps are memoryless; CS stays uniform.
    return is_ncs * expd + (1 - is_ncs) * base


WORKLOAD_ROWS = {
    "constant": WorkloadRow("constant", WL_CONSTANT, 0, _hold_constant),
    "bursty": WorkloadRow("bursty", WL_BURSTY, 1, _hold_bursty),
    "hetero": WorkloadRow("hetero", WL_HETERO, 0, _hold_hetero),
    "jitter": WorkloadRow("jitter", WL_JITTER, 0, _hold_jitter),
}
assert sorted(r.wid for r in WORKLOAD_ROWS.values()) \
    == sorted(WORKLOAD_IDS.values())


def workload_hold(workload_id, is_ncs, base, expd, gate_off, tscale, burst):
    """Dispatch one hold-time draw by ``workload_id`` — the workload twin
    of :func:`oracle_update`'s masked select.  All candidate rows are
    finite and non-negative, so the arithmetic select is exact: a constant
    row's output is bit-identical to ``base``."""
    out = 0.0
    for row in WORKLOAD_ROWS.values():
        sel = (workload_id == row.wid) * 1.0
        out = out + sel * row.hold(is_ncs, base, expd, gate_off, tscale,
                                   burst)
    return out


def workload_thread_scale(spread_u, spread):
    """Persistent per-thread multiplier, log-uniform in
    ``[1/spread, spread]`` from the thread's spread uniform."""
    return spread ** (2.0 * spread_u - 1.0)


def workload_off_gate(now, phase_u, period, duty):
    """0/1: is a thread with duty-cycle phase ``phase_u`` in the OFF part
    of its ON/OFF cycle at time ``now``?  The cycle has length ``period``
    seconds with the first ``duty`` fraction ON; ``phase_u`` staggers the
    threads so a config's bursts overlap only partially."""
    pos = (now / period + phase_u) % 1.0
    return (pos >= duty) * 1.0


def workload_mean_scale(cfg) -> tuple[float, float]:
    """Expected ``(cs, ncs)`` mean-duration multipliers of a config's
    workload row — the horizon planner's correction
    (:func:`repro_torch.core.xdes.plan_schedule`): a bursty row stretches the
    mean arrival gap to ``duty + (1-duty)·burst`` of the base, a hetero
    row stretches both draws by ``E[s^(2u-1)] = (s - 1/s)/(2 ln s)``;
    constant and jitter leave the means unchanged.  Exactly 1.0 for the
    constant row, so constant-workload plans are bit-identical."""
    import math

    wid = WORKLOAD_IDS[cfg.workload]
    if wid == WL_BURSTY:
        return 1.0, cfg.wl_duty + (1.0 - cfg.wl_duty) * cfg.wl_burst
    if wid == WL_HETERO:
        s = cfg.wl_spread
        m = 1.0 if s <= 1.0 else (s - 1.0 / s) / (2.0 * math.log(s))
        return m, m
    return 1.0, 1.0


# --------------------------------------------------------------------------
# Arrival rows — the OPEN-LOOP arrival process as data, mirroring
# WORKLOAD_ROWS.
#
# Everything before these rows is closed-loop: a fixed thread population
# circulates forever.  An arrival row turns a config open-loop: logical
# requests arrive at a (possibly time-varying) rate, wait in a bounded
# request queue, bind to a free simulated thread, contend under the
# config's DISCIPLINE_ROWS row, complete one critical section and depart
# — per-request latency is accumulated into on-device histogram columns
# (see docs/open_loop.md).
#
# A row's ``rate`` function maps the config's base rate to the
# instantaneous arrival rate; it is pure arithmetic on caller-precomputed
# inputs (the burst gate derives from the counter RNG under
# AR_PHASE_SALT, exactly like the workload rows' duty-cycle gate), so ONE
# implementation runs on Python floats (the DES twin), numpy arrays and
# torch tensors inside the plain version:
#
#   rate(base, gate_on, burst) -> requests/second
#     base     the config's ``arrival_rate``
#     gate_on  0/1: the config is inside the ON part of its burst cycle
#     burst    the ON-phase rate multiplier (reuses ``wl_burst``)
#
# Per step the engine admits ``floor(rate*dt)`` requests plus a Bernoulli
# trial on the fractional part (uniform from the counter RNG under
# AR_SALT), so the expected count is EXACTLY ``rate*dt`` at any dt.  The
# closed row has rate 0 and is bit-identical to the pre-open-loop engine
# (the masked select is exact and the open-loop state is only
# materialized when a batch contains an open config).
# --------------------------------------------------------------------------
AR_CLOSED, AR_POISSON, AR_BURSTY = range(3)

ARRIVAL_IDS = {
    "closed": AR_CLOSED,      # no external arrivals: the closed-loop engine
    "poisson": AR_POISSON,    # constant-rate memoryless arrivals
    "bursty": AR_BURSTY,      # ON/OFF rate modulation (wl_period/duty/burst)
}
ARRIVAL_NAMES = {v: k for k, v in ARRIVAL_IDS.items()}

#: Seed salts for the open-loop arrival streams (XOR-ed into the config
#: seed; disjoint from WL_PHASE_SALT/WL_SPREAD_SALT so the arrival
#: process never perturbs the workload draws).
AR_SALT = 0x94D049BB          # per-step Bernoulli-rounding uniforms
AR_PHASE_SALT = 0xBF58476D    # per-config burst-phase offset

#: Seed salt for the randomized same-step tie-break stream
#: (``SimConfig.tie_break="random"``).
TB_SALT = 0xD6E8FEB8

#: Same-step tie-break among equally-eligible spinners at handoff:
#: ``id`` keeps the historical deterministic thread-id order; ``random``
#: draws a fresh seeded key per (thread, step) — the DES resolves such
#: ties by RNG, so ``random`` closes that fidelity gap.
TIE_BREAK_IDS = {"id": 0, "random": 1}
TIE_BREAK_NAMES = {v: k for k, v in TIE_BREAK_IDS.items()}

#: Capacity of the on-device request ring buffer — ``queue_cap`` may not
#: exceed it (the ring buffer of the open-loop engine is this wide).
QUEUE_MAX = 128


# --------------------------------------------------------------------------
# Fault rows — environment interference as data, mirroring WORKLOAD_ROWS
# and ARRIVAL_ROWS.
#
# The paper's whole case for hybrid waiting is adverse, *unknown*
# environments, yet the benign simulator never preempts a lock holder,
# never oversubscribes a core and never loses a wake-up.  A fault row is a
# named, seeded interference model dispatched per config by an integer id
# exactly like the other registries, so a single batched call can sweep a
# fault × discipline grid.
#
# Two elementwise hooks cover every row; both are pure arithmetic on
# caller-precomputed uniforms, so ONE implementation runs on Python floats
# (the DES twin), numpy arrays and torch tensors inside the plain version:
#
#   progress(is_holder, gate_u, rate) -> multiplier in [0, 1]
#     scales a running (CS/NCS) thread's progress inside the current
#     fault window.  ``is_holder`` is 0/1; ``gate_u`` is the persistent
#     per-(thread, window) uniform drawn under FLT_GATE_SALT.
#   wake_delay(wake, w1, w2, rate, scale) -> seconds
#     replaces the config's nominal wake latency for one wake-up.
#     ``w1``/``w2`` are per-(thread, step) uniforms under
#     FLT_WAKE_SALT / FLT_MAG_SALT.
#
# Rows (``fault_rate`` = intensity in [0, 1], ``fault_scale`` = the row's
# characteristic time in seconds):
#
#   none      no interference — bit-identical to the pre-fault engine
#             (the dispatch is an exact masked select and the engine
#             applies the progress hook through a ``where`` that is a
#             structural no-op when the give-back is zero).
#   preempt   lock-holder preemption: time is sliced into windows of
#             ``fault_scale`` seconds; with probability ``fault_rate``
#             per (thread, window) the thread is off-CPU for the whole
#             window — a descheduled *holder* stalls every waiter while
#             spinners keep burning CPU (the Fissile/Solaris regime).
#   oversub   CPU oversubscription: an interfering background load
#             steals a seeded fraction (up to ``fault_rate``) of every
#             running thread's cycles per window — uniform time-stealing
#             rather than whole-window blackouts.
#   lostwake  lost wake-ups: with probability ``fault_rate`` a wake-up
#             is dropped and the sleeper only recovers at its timeout,
#             ``fault_scale`` seconds (futex-miss / missed-signal model).
#   jitter    timer jitter: each wake-up is stretched by a uniform extra
#             delay in [0, ``fault_scale``) with probability
#             ``fault_rate`` (tickless-kernel / VM-scheduling noise).
#
# Spinning threads' CPU burn and the adaptive spin budget are deliberately
# NOT modulated: interference steals *progress*, while a spinner occupying
# a core keeps paying for it — which is exactly why sleep-leaning
# disciplines overtake pure spin under heavy preemption.
# --------------------------------------------------------------------------
FAULT_NONE, FAULT_PREEMPT, FAULT_OVERSUB, FAULT_LOSTWAKE, FAULT_JITTER = \
    range(5)

FAULT_IDS = {
    "none": FAULT_NONE,          # benign machine (the pre-fault engine)
    "preempt": FAULT_PREEMPT,    # lock-holder preemption windows
    "oversub": FAULT_OVERSUB,    # background load steals cycles
    "lostwake": FAULT_LOSTWAKE,  # dropped wake-ups + timeout recovery
    "jitter": FAULT_JITTER,      # wake-latency jitter
}
FAULT_NAMES = {v: k for k, v in FAULT_IDS.items()}

#: Seed salts for the fault streams (XOR-ed into the config seed;
#: disjoint from WL_PHASE_SALT/WL_SPREAD_SALT/AR_SALT/AR_PHASE_SALT/
#: TB_SALT so interference never perturbs workload, arrival or tie-break
#: draws).
FLT_GATE_SALT = 0xA3C59AC3    # per-(thread, fault-window) off-CPU gate
FLT_WAKE_SALT = 0xC2B2AE35    # per-(thread, step) wake-fault gate
FLT_MAG_SALT = 0x27220A95     # per-(thread, step) wake-jitter magnitude


@dataclass(frozen=True)
class FaultRow:
    name: str
    fid: int
    progress: object           # callable, elementwise (see module comment)
    wake_delay: object         # callable, elementwise


def _fault_progress_one(is_holder, gate_u, rate):
    return 1.0 + 0.0 * gate_u


def _fault_progress_preempt(is_holder, gate_u, rate):
    # The whole fault window is lost when the per-(thread, window) gate
    # fires — holders and waiters alike go off-CPU for the window.
    return 1.0 - (gate_u < rate) * 1.0


def _fault_progress_oversub(is_holder, gate_u, rate):
    # A background load steals a seeded fraction of the window's cycles.
    return 1.0 - rate * gate_u


def _fault_wake_nominal(wake, w1, w2, rate, scale):
    return wake + 0.0 * w1


def _fault_wake_lost(wake, w1, w2, rate, scale):
    # A dropped wake-up is recovered by the sleeper's timeout at `scale`.
    return wake + (w1 < rate) * (scale - wake)


def _fault_wake_jitter(wake, w1, w2, rate, scale):
    # With probability `rate` the wake-up lands up to `scale` late.
    return wake + (w1 < rate) * scale * w2


FAULT_ROWS = {
    "none": FaultRow("none", FAULT_NONE,
                     _fault_progress_one, _fault_wake_nominal),
    "preempt": FaultRow("preempt", FAULT_PREEMPT,
                        _fault_progress_preempt, _fault_wake_nominal),
    "oversub": FaultRow("oversub", FAULT_OVERSUB,
                        _fault_progress_oversub, _fault_wake_nominal),
    "lostwake": FaultRow("lostwake", FAULT_LOSTWAKE,
                         _fault_progress_one, _fault_wake_lost),
    "jitter": FaultRow("jitter", FAULT_JITTER,
                       _fault_progress_one, _fault_wake_jitter),
}
assert sorted(r.fid for r in FAULT_ROWS.values()) \
    == sorted(FAULT_IDS.values())


def fault_progress_scale(fault_id, is_holder, gate_u, rate):
    """Dispatch the per-window progress multiplier by ``fault_id`` — the
    fault twin of :func:`workload_hold`'s masked select.  Exactly 1.0 for
    the none row (every candidate is finite, the select is exact)."""
    out = 0.0
    for row in FAULT_ROWS.values():
        sel = (fault_id == row.fid) * 1.0
        out = out + sel * row.progress(is_holder, gate_u, rate)
    return out


def fault_wake_delay(fault_id, wake, w1, w2, rate, scale):
    """Dispatch the effective wake latency by ``fault_id``.  Bit-identical
    to ``wake`` for rows that do not perturb wake-ups."""
    out = 0.0
    for row in FAULT_ROWS.values():
        sel = (fault_id == row.fid) * 1.0
        out = out + sel * row.wake_delay(wake, w1, w2, rate, scale)
    return out

#: On-device latency histogram: ``LAT_NBINS`` log-spaced bins,
#: ``LAT_BINS_PER_OCTAVE`` per factor of two, starting at ``LAT_BIN0``
#: seconds — 64 bins at 2/octave span 1e-7 s .. ~4.6e2 s, wide enough for
#: µs spin cells and saturated 100µs-CS queues alike.
LAT_NBINS = 64
LAT_BIN0 = 1e-7
LAT_BINS_PER_OCTAVE = 2


@dataclass(frozen=True)
class ArrivalRow:
    name: str
    aid: int
    time_varying: int          # 1 iff the rate reads the current time
    rate: object               # callable, elementwise (see module comment)


def _rate_closed(base, gate_on, burst):
    return base * 0.0


def _rate_poisson(base, gate_on, burst):
    return base * 1.0


def _rate_bursty(base, gate_on, burst):
    # ON/OFF rate modulation: `burst` times the base rate inside the ON
    # window (the first `wl_duty` fraction of each `wl_period` cycle,
    # phase-staggered per config under AR_PHASE_SALT).
    return base * (1.0 + gate_on * (burst - 1.0))


ARRIVAL_ROWS = {
    "closed": ArrivalRow("closed", AR_CLOSED, 0, _rate_closed),
    "poisson": ArrivalRow("poisson", AR_POISSON, 0, _rate_poisson),
    "bursty": ArrivalRow("bursty", AR_BURSTY, 1, _rate_bursty),
}
assert sorted(r.aid for r in ARRIVAL_ROWS.values()) \
    == sorted(ARRIVAL_IDS.values())


def arrival_rate_at(arrival_id, base, gate_on, burst):
    """Dispatch the instantaneous arrival rate by ``arrival_id`` — the
    arrival twin of :func:`workload_hold`'s masked select.  Exact for the
    closed row (rate 0 regardless of base)."""
    out = 0.0
    for row in ARRIVAL_ROWS.values():
        sel = (arrival_id == row.aid) * 1.0
        out = out + sel * row.rate(base, gate_on, burst)
    return out


def arrival_mean_scale(arrival_id, duty, burst):
    """Time-averaged multiplier of the base rate for a row: 0 for closed,
    1 for poisson, ``1 + duty*(burst-1)`` for bursty.  Elementwise — the
    DES twin and saturation math (catalog) share it."""
    closed = (arrival_id == AR_CLOSED) * 1.0
    bursty = (arrival_id == AR_BURSTY) * 1.0
    return (1.0 - closed) * (1.0 + bursty * duty * (burst - 1.0))


def latency_bin_edges():
    """The ``LAT_NBINS + 1`` histogram bin edges in seconds (float64).
    Bin ``i`` covers ``[edges[i], edges[i+1])``; the first and last bins
    additionally absorb underflow/overflow (the kernel clips)."""
    import numpy as np

    return LAT_BIN0 * 2.0 ** (np.arange(LAT_NBINS + 1, dtype=np.float64)
                              / LAT_BINS_PER_OCTAVE)


def latency_percentiles(hist, qs=(0.50, 0.95, 0.99)):
    """Per-config latency percentiles from ``(..., LAT_NBINS)`` histogram
    counts: the geometric midpoint of the bin containing each quantile
    (the histogram is the exact on-device record; within-bin position is
    unknowable, so the midpoint is the canonical readout — bins are a
    factor sqrt(2) wide).  Returns one array per ``q``; NaN where no
    request departed."""
    import numpy as np

    hist = np.asarray(hist, np.int64)
    edges = latency_bin_edges()
    mids = np.sqrt(edges[:-1] * edges[1:])
    tot = hist.sum(axis=-1)
    cum = np.cumsum(hist, axis=-1)
    out = []
    for q in qs:
        target = np.ceil(q * np.maximum(tot, 1)).astype(np.int64)[..., None]
        idx = np.argmax(cum >= target, axis=-1)
        out.append(np.where(tot > 0, mids[idx], np.nan))
    return out



# --------------------------------------------------------------------------
# Scenario description — the unit of the batched sweep
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SimConfig:
    """One ``(lock, threads, cores, cs, ncs, wake_latency, alpha)`` cell.

    The event-driven DES consumes these through :func:`repro_torch.core.
    des.simulate`; the batched backend encodes a list of them into
    struct-of-arrays form (:func:`encode_configs`) and simulates all of
    them in one device program (:func:`repro_torch.core.xdes.
    simulate_batch`).
    """

    lock: str
    threads: int
    cores: int
    cs: tuple[float, float]
    ncs: tuple[float, float]
    wake_latency: float = 8e-6
    alpha: float | None = None          # None -> DEFAULT_ALPHA[lock]
    sws_init: int = 1
    sws_max: int | None = None          # None -> cores (paper default)
    k: int = 10
    spin_budget: float = DEFAULT_SPIN_BUDGET
    seed: int = 0
    oracle: str = "paper"               # SWS adaptation family (ORACLE_IDS)
    workload: str = "constant"          # hold-time model (WORKLOAD_IDS)
    wl_period: float = 1e-4             # bursty ON/OFF cycle length (s)
    wl_duty: float = 0.25               # ON fraction of the cycle
    wl_burst: float = 8.0               # OFF-phase NCS stretch factor
    wl_spread: float = 4.0              # hetero per-thread scale spread
    arrival_phase: float = 0.0          # seeded arrival-order offset
    #                                     (fraction of the mean NCS)
    arrival: str = "closed"             # open-loop arrival row (ARRIVAL_IDS)
    arrival_rate: float = 0.0           # base arrival rate (requests/s)
    queue_cap: int = QUEUE_MAX          # bounded request queue (<= QUEUE_MAX)
    slo: float = 1e-3                   # per-request latency SLO (seconds)
    tie_break: str = "id"               # same-step tie-break (TIE_BREAK_IDS)
    fault: str = "none"                 # interference row (FAULT_IDS)
    fault_rate: float = 0.0             # interference intensity in [0, 1]
    fault_scale: float = 5e-5           # fault window / timeout (seconds)
    park_cost: float = 1.0              # M:N environment axis: multiplies
    #                                     the sleep/wake round-trip (green
    #                                     threads << 1, kernel threads 1,
    #                                     oversubscribed VMs >> 1)

    def __post_init__(self):
        if self.lock not in POLICY_IDS:
            raise ValueError(f"unknown lock {self.lock!r}; "
                             f"options: {sorted(POLICY_IDS)}")
        if self.threads < 1 or self.cores < 1:
            raise ValueError("threads and cores must be >= 1")
        if self.oracle not in ORACLE_IDS:
            raise ValueError(f"unknown oracle {self.oracle!r}; "
                             f"options: {sorted(ORACLE_IDS)}")
        if self.workload not in WORKLOAD_IDS:
            raise ValueError(f"unknown workload {self.workload!r}; "
                             f"options: {sorted(WORKLOAD_IDS)}")
        if self.wl_period <= 0 or not (0.0 < self.wl_duty <= 1.0):
            raise ValueError("wl_period must be > 0 and wl_duty in (0, 1]")
        if self.wl_burst < 1.0 or self.wl_spread < 1.0:
            raise ValueError("wl_burst and wl_spread must be >= 1")
        if self.arrival_phase < 0.0:
            raise ValueError("arrival_phase must be >= 0")
        if self.arrival not in ARRIVAL_IDS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"options: {sorted(ARRIVAL_IDS)}")
        if self.arrival_rate < 0.0:
            raise ValueError("arrival_rate must be >= 0")
        if not (1 <= self.queue_cap <= QUEUE_MAX):
            raise ValueError(f"queue_cap must be in [1, {QUEUE_MAX}]")
        if self.slo <= 0.0:
            raise ValueError("slo must be > 0")
        if self.tie_break not in TIE_BREAK_IDS:
            raise ValueError(f"unknown tie_break {self.tie_break!r}; "
                             f"options: {sorted(TIE_BREAK_IDS)}")
        if self.fault not in FAULT_IDS:
            raise ValueError(f"unknown fault {self.fault!r}; "
                             f"options: {sorted(FAULT_IDS)}")
        if not (0.0 <= self.fault_rate <= 1.0):
            raise ValueError("fault_rate must be in [0, 1]")
        if self.fault_scale <= 0.0:
            raise ValueError("fault_scale must be > 0")
        if self.park_cost <= 0.0:
            raise ValueError("park_cost must be > 0")

    # -- derived quantities shared by both backends -----------------------
    @property
    def alpha_eff(self) -> float:
        return DEFAULT_ALPHA[self.lock] if self.alpha is None else self.alpha

    @property
    def sws_max_eff(self) -> int:
        return self.cores if self.sws_max is None else self.sws_max

    @property
    def sws_start(self) -> int:
        """Initial window per discipline under the unified A7 rule:
        spin/adaptive disciplines never sleep on arrival (window = threads),
        the sleep lock parks every waiter (window = 1), the mutable lock
        starts at ``sws_init``."""
        pid = POLICY_IDS[self.lock]
        if pid == SLEEP:
            return 1
        if pid in (MUTABLE, FISSILE):
            return max(1, min(self.sws_init, self.sws_max_eff))
        return self.threads             # tas/ttas/mcs/adaptive/fifo/hapax/bo

    def des_kwargs(self) -> dict:
        """Keyword form consumed by :func:`repro_torch.core.des.simulate`."""
        kw: dict = {}
        if self.alpha is not None:
            kw["alpha"] = self.alpha
        if self.lock in ("mutable", "fissile"):
            from .oracle import make_oracle

            kw.update(initial_sws=self.sws_init, max_sws=self.sws_max,
                      oracle=make_oracle(self.oracle, k=self.k))
        if self.lock in ("adaptive", "fissile", "ttas_backoff"):
            kw["spin_budget"] = self.spin_budget
        return kw

    def workload_kwargs(self) -> dict:
        """Workload keywords consumed by :class:`repro_torch.core.des.LockSim`
        (the event-driven twin of the workload rows)."""
        return dict(workload=self.workload, wl_period=self.wl_period,
                    wl_duty=self.wl_duty, wl_burst=self.wl_burst,
                    wl_spread=self.wl_spread,
                    arrival_phase=self.arrival_phase)

    @property
    def open_loop(self) -> bool:
        """True iff this config runs the open-loop arrival engine."""
        return ARRIVAL_IDS[self.arrival] != AR_CLOSED

    def arrival_kwargs(self) -> dict:
        """Open-loop keywords consumed by :class:`repro_torch.core.des.LockSim`
        (the event-driven twin of the arrival rows)."""
        return dict(arrival=self.arrival, arrival_rate=self.arrival_rate,
                    queue_cap=self.queue_cap)

    def fault_kwargs(self) -> dict:
        """Fault keywords consumed by :class:`repro_torch.core.des.LockSim`
        (the event-driven twin of the fault rows)."""
        return dict(fault=self.fault, fault_rate=self.fault_rate,
                    fault_scale=self.fault_scale)

    def env_kwargs(self) -> dict:
        """Environment keywords consumed by :class:`repro_torch.core.des.LockSim`
        (the M:N parking axis)."""
        return dict(park_cost=self.park_cost)


def workload_mean_scale_columns(workload, wl_duty, wl_burst, wl_spread):
    """Vectorized twin of :func:`workload_mean_scale` over (C,) columns.

    ``workload`` is an integer-id array; the float columns are taken in
    float64 so the arithmetic matches the scalar (Python-float) path.
    Returns ``(cs_scale, ncs_scale)`` float64 arrays.
    """
    import numpy as np

    wid = np.asarray(workload)
    duty = np.asarray(wl_duty, np.float64)
    burst = np.asarray(wl_burst, np.float64)
    s = np.asarray(wl_spread, np.float64)
    cs = np.ones(wid.shape, np.float64)
    ncs = np.ones(wid.shape, np.float64)
    ncs = np.where(wid == WL_BURSTY, duty + (1.0 - duty) * burst, ncs)
    ss = np.where(s <= 1.0, 2.0, s)          # dummy where the log is unused
    m = np.where(s <= 1.0, 1.0, (ss - 1.0 / ss) / (2.0 * np.log(ss)))
    het = wid == WL_HETERO
    return np.where(het, m, cs), np.where(het, m, ncs)


#: Column order of the struct-of-arrays encoding (see encode_configs).
CONFIG_FIELDS = (
    "policy", "threads", "cores", "cs_lo", "cs_hi", "ncs_lo", "ncs_hi",
    "wake", "alpha", "sws_init", "sws_max", "k", "spin_budget", "seed",
    "oracle", "workload", "wl_period", "wl_duty", "wl_burst", "wl_spread",
    "arrival_phase", "arrival", "arr_rate", "q_cap", "slo", "tb",
    "fault", "flt_rate", "flt_scale", "park_cost",
)

#: Column order of the RAW (pre-encoding) struct-of-arrays form — the
#: array-native interchange format emitted by the catalog's column
#: generators and consumed by :func:`encode_columns` and the streaming
#: sweep.  Values keep SimConfig semantics and full float64 precision:
#: ``lock``/``oracle``/``workload`` are integer ids (or name strings),
#: ``alpha`` uses NaN for "default for this lock", ``sws_max`` uses -1
#: for "default (= cores)".
RAW_CONFIG_FIELDS = (
    "lock", "threads", "cores", "cs_lo", "cs_hi", "ncs_lo", "ncs_hi",
    "wake_latency", "alpha", "sws_init", "sws_max", "k", "spin_budget",
    "seed", "oracle", "workload", "wl_period", "wl_duty", "wl_burst",
    "wl_spread", "arrival_phase", "arrival", "arrival_rate", "queue_cap",
    "slo", "tie_break", "fault", "fault_rate", "fault_scale", "park_cost",
)

#: Defaults for the RAW open-loop columns — column producers written
#: before the open-loop engine may omit them; :func:`encode_columns`
#: fills these in (the closed defaults, bit-identical to the
#: pre-open-loop encoding).
RAW_OPEN_DEFAULTS = {
    "arrival": AR_CLOSED, "arrival_rate": 0.0, "queue_cap": QUEUE_MAX,
    "slo": 1e-3, "tie_break": 0,
}

#: Defaults for the RAW fault columns — same contract as
#: :data:`RAW_OPEN_DEFAULTS`: column producers written before the fault
#: rows may omit them and get the benign machine, bit-identical to the
#: pre-fault encoding.
RAW_FAULT_DEFAULTS = {
    "fault": FAULT_NONE, "fault_rate": 0.0, "fault_scale": 5e-5,
}

#: Defaults for the RAW environment columns — same contract: column
#: producers written before the M:N parking axis get 1:1 kernel threads,
#: bit-identical to the pre-park_cost encoding.
RAW_ENV_DEFAULTS = {
    "park_cost": 1.0,
}


def _ids_from(values, table, what: str):
    """Map an array/sequence of names or ids onto int32 ids (without ever
    materializing a numpy unicode array — the dict lookup is the fast
    path for name sequences)."""
    import numpy as np

    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        return values.astype(np.int32)
    seq = values.tolist() if isinstance(values, np.ndarray) \
        else list(values)
    if seq and isinstance(seq[0], (int, np.integer)):
        return np.asarray(seq, np.int32)
    try:
        return np.fromiter((table[v] for v in seq), np.int32, len(seq))
    except KeyError as e:
        raise ValueError(f"unknown {what} {e.args[0]!r}; "
                         f"options: {sorted(table)}") from None


def config_columns(configs) -> dict:
    """Extract a list of :class:`SimConfig` into RAW struct-of-arrays form
    (:data:`RAW_CONFIG_FIELDS`) in ONE attribute pass — no per-field
    lambdas, no property calls.  Float columns keep float64 precision so
    downstream planning (:func:`repro_torch.core.xdes.plan_schedule`) matches
    the per-object path exactly."""
    import operator

    import numpy as np

    configs = list(configs)
    if not configs:
        raise ValueError("empty config batch")
    get = operator.attrgetter(
        "lock", "threads", "cores", "cs", "ncs", "wake_latency", "alpha",
        "sws_init", "sws_max", "k", "spin_budget", "seed", "oracle",
        "workload", "wl_period", "wl_duty", "wl_burst", "wl_spread",
        "arrival_phase", "arrival", "arrival_rate", "queue_cap", "slo",
        "tie_break", "fault", "fault_rate", "fault_scale", "park_cost")
    (lock, threads, cores, cs, ncs, wake, alpha, sws_init, sws_max, k,
     spin_budget, seed, oracle, workload, wl_period, wl_duty, wl_burst,
     wl_spread, arrival_phase, arrival, arrival_rate, queue_cap, slo,
     tie_break, fault, fault_rate, fault_scale,
     park_cost) = zip(*map(get, configs))
    n = len(configs)
    cs = np.asarray(cs, np.float64)
    ncs = np.asarray(ncs, np.float64)
    return {
        "lock": _ids_from(lock, POLICY_IDS, "lock"),
        "threads": np.asarray(threads, np.int64).astype(np.int32),
        "cores": np.asarray(cores, np.int64).astype(np.int32),
        "cs_lo": cs[:, 0], "cs_hi": cs[:, 1],
        "ncs_lo": ncs[:, 0], "ncs_hi": ncs[:, 1],
        "wake_latency": np.asarray(wake, np.float64),
        "alpha": np.fromiter((np.nan if a is None else a for a in alpha),
                             np.float64, n),
        "sws_init": np.asarray(sws_init, np.int64).astype(np.int32),
        "sws_max": np.fromiter((-1 if s is None else s for s in sws_max),
                               np.int64, n).astype(np.int32),
        "k": np.asarray(k, np.int64).astype(np.int32),
        "spin_budget": np.asarray(spin_budget, np.float64),
        "seed": np.asarray(seed, np.int64).astype(np.uint32),
        "oracle": _ids_from(oracle, ORACLE_IDS, "oracle"),
        "workload": _ids_from(workload, WORKLOAD_IDS, "workload"),
        "wl_period": np.asarray(wl_period, np.float64),
        "wl_duty": np.asarray(wl_duty, np.float64),
        "wl_burst": np.asarray(wl_burst, np.float64),
        "wl_spread": np.asarray(wl_spread, np.float64),
        "arrival_phase": np.asarray(arrival_phase, np.float64),
        "arrival": _ids_from(arrival, ARRIVAL_IDS, "arrival"),
        "arrival_rate": np.asarray(arrival_rate, np.float64),
        "queue_cap": np.asarray(queue_cap, np.int64).astype(np.int32),
        "slo": np.asarray(slo, np.float64),
        "tie_break": _ids_from(tie_break, TIE_BREAK_IDS, "tie_break"),
        "fault": _ids_from(fault, FAULT_IDS, "fault"),
        "fault_rate": np.asarray(fault_rate, np.float64),
        "fault_scale": np.asarray(fault_scale, np.float64),
        "park_cost": np.asarray(park_cost, np.float64),
    }


def _validate_columns(cols, C: int) -> None:
    """Vectorized mirror of ``SimConfig.__post_init__`` for column inputs
    that never passed through the dataclass; names the first offending
    row."""
    import numpy as np

    def bad(mask, msg):
        idx = np.nonzero(np.asarray(mask))[0]
        if idx.size:
            raise ValueError(f"config column row {int(idx[0])}: {msg}")

    bad((cols["lock"] < 0) | (cols["lock"] >= len(POLICY_IDS)),
        f"unknown lock id; options: {sorted(POLICY_IDS.values())}")
    bad((cols["oracle"] < 0) | (cols["oracle"] >= len(ORACLE_IDS)),
        f"unknown oracle id; options: {sorted(ORACLE_IDS.values())}")
    bad((cols["workload"] < 0) | (cols["workload"] >= len(WORKLOAD_IDS)),
        f"unknown workload id; options: {sorted(WORKLOAD_IDS.values())}")
    bad((cols["threads"] < 1) | (cols["cores"] < 1),
        "threads and cores must be >= 1")
    bad(cols["wl_period"] <= 0, "wl_period must be > 0")
    bad((cols["wl_duty"] <= 0) | (cols["wl_duty"] > 1),
        "wl_duty must be in (0, 1] "
        "(pass strict=False to clamp out-of-range sweep columns)")
    bad((cols["wl_burst"] < 1) | (cols["wl_spread"] < 1),
        "wl_burst and wl_spread must be >= 1")
    bad(cols["arrival_phase"] < 0, "arrival_phase must be >= 0")
    bad((cols["arrival"] < 0) | (cols["arrival"] >= len(ARRIVAL_IDS)),
        f"unknown arrival id; options: {sorted(ARRIVAL_IDS.values())}")
    bad(cols["arrival_rate"] < 0,
        "arrival_rate must be >= 0 "
        "(pass strict=False to clamp out-of-range sweep columns)")
    bad((cols["queue_cap"] < 1) | (cols["queue_cap"] > QUEUE_MAX),
        f"queue_cap must be in [1, {QUEUE_MAX}] "
        "(pass strict=False to clamp out-of-range sweep columns)")
    bad(cols["slo"] <= 0, "slo must be > 0")
    bad((cols["tie_break"] < 0)
        | (cols["tie_break"] >= len(TIE_BREAK_IDS)),
        f"unknown tie_break id; options: {sorted(TIE_BREAK_IDS.values())}")
    bad((cols["fault"] < 0) | (cols["fault"] >= len(FAULT_IDS)),
        f"unknown fault id; options: {sorted(FAULT_IDS.values())}")
    bad((cols["fault_rate"] < 0) | (cols["fault_rate"] > 1),
        "fault_rate must be in [0, 1]")
    bad(cols["fault_scale"] <= 0, "fault_scale must be > 0")
    bad(cols["park_cost"] <= 0, "park_cost must be > 0")


#: DEFAULT_ALPHA indexed by policy id (the vectorized alpha_eff lookup).
def _alpha_by_id():
    import numpy as np

    return np.asarray([DEFAULT_ALPHA[POLICY_NAMES[i]]
                       for i in range(len(POLICY_IDS))], np.float64)


def encode_columns(cols, validate: bool = True, strict: bool = True) -> dict:
    """Encode RAW struct-of-arrays columns (:data:`RAW_CONFIG_FIELDS`;
    scalars broadcast, name strings accepted for the id columns) into the
    engine's :data:`CONFIG_FIELDS` form — the fully array-native path the
    streaming sweep feeds 100k+-config catalogs through.  Output is
    bit-identical to ``encode_configs`` of the equivalent
    :class:`SimConfig` list (same float64 -> float32 rounding, same
    derived ``alpha``/``sws_init``/``sws_max`` rules).

    Out-of-range values raise an actionable :class:`ValueError` naming the
    offending row.  ``strict=False`` instead clamps the continuous sweep
    knobs (``arrival_rate`` to >= 0, ``queue_cap`` to [1, QUEUE_MAX],
    ``wl_duty`` to (0, 1]) so mechanically-generated grids survive edge
    cells; discrete ids are never clamped."""
    import numpy as np

    cols = dict(cols)
    for f, v in RAW_OPEN_DEFAULTS.items():
        cols.setdefault(f, v)
    for f, v in RAW_FAULT_DEFAULTS.items():
        cols.setdefault(f, v)
    for f, v in RAW_ENV_DEFAULTS.items():
        cols.setdefault(f, v)
    for key, table, what in (("lock", POLICY_IDS, "lock"),
                             ("oracle", ORACLE_IDS, "oracle"),
                             ("workload", WORKLOAD_IDS, "workload"),
                             ("arrival", ARRIVAL_IDS, "arrival"),
                             ("tie_break", TIE_BREAK_IDS, "tie_break"),
                             ("fault", FAULT_IDS, "fault")):
        v = cols[key]
        if isinstance(v, str):
            cols[key] = table.get(v)
            if cols[key] is None:
                raise ValueError(f"unknown {what} {v!r}; "
                                 f"options: {sorted(table)}")
        elif not np.asarray(v).dtype.kind in "iu":
            cols[key] = _ids_from(v, table, what)
    C = max(np.size(cols[f]) for f in RAW_CONFIG_FIELDS if f in cols)
    full = {f: np.broadcast_to(np.asarray(cols[f]), (C,))
            for f in RAW_CONFIG_FIELDS}
    if not strict:
        full["arrival_rate"] = np.maximum(full["arrival_rate"], 0.0)
        full["queue_cap"] = np.clip(full["queue_cap"], 1, QUEUE_MAX)
        full["wl_duty"] = np.clip(full["wl_duty"],
                                  np.finfo(np.float64).tiny, 1.0)
    if validate:
        _validate_columns(full, C)

    lock = full["lock"].astype(np.int32)
    threads = full["threads"].astype(np.int32)
    cores = full["cores"].astype(np.int64)
    alpha = full["alpha"].astype(np.float64)
    alpha = np.where(np.isnan(alpha), _alpha_by_id()[lock], alpha)
    sws_max_eff = np.where(full["sws_max"] < 0, cores,
                           full["sws_max"]).astype(np.int64)
    # sws_start per discipline (the SimConfig.sws_start rule, vectorized)
    sws_start = np.where(
        lock == SLEEP, 1,
        np.where((lock == MUTABLE) | (lock == FISSILE),
                 np.clip(full["sws_init"], 1, np.maximum(sws_max_eff, 1)),
                 threads)).astype(np.int32)
    f32 = lambda key: full[key].astype(np.float32)
    return {
        "policy": lock,
        "threads": threads,
        "cores": cores.astype(np.float32),
        "cs_lo": f32("cs_lo"), "cs_hi": f32("cs_hi"),
        "ncs_lo": f32("ncs_lo"), "ncs_hi": f32("ncs_hi"),
        "wake": f32("wake_latency"),
        "alpha": alpha.astype(np.float32),
        "sws_init": sws_start,
        "sws_max": np.maximum(sws_max_eff, sws_start).astype(np.int32),
        "k": full["k"].astype(np.int32),
        "spin_budget": f32("spin_budget"),
        "seed": full["seed"].astype(np.uint32),
        "oracle": full["oracle"].astype(np.int32),
        "workload": full["workload"].astype(np.int32),
        "wl_period": f32("wl_period"), "wl_duty": f32("wl_duty"),
        "wl_burst": f32("wl_burst"), "wl_spread": f32("wl_spread"),
        "arrival_phase": f32("arrival_phase"),
        "arrival": full["arrival"].astype(np.int32),
        "arr_rate": f32("arrival_rate"),
        "q_cap": full["queue_cap"].astype(np.int32),
        "slo": f32("slo"),
        "tb": full["tie_break"].astype(np.int32),
        "fault": full["fault"].astype(np.int32),
        "flt_rate": f32("fault_rate"),
        "flt_scale": f32("fault_scale"),
        "park_cost": f32("park_cost"),
    }


def encode_configs(configs, strict: bool = True) -> dict:
    """Encode a batch of configs as struct-of-arrays (numpy).

    Accepts either a list of :class:`SimConfig` or a RAW column mapping
    (:data:`RAW_CONFIG_FIELDS`, as emitted by the catalog's ``*_columns``
    generators).  The result is the array program's input: every column
    has length ``C``; dtypes are int32 for discrete fields and float32
    for durations/rates.  ``policy`` uses the shared ids above, so the
    batched simulator and the CUDA kernel can branch with ``where``
    masks.

    Vectorized: column inputs go straight through numpy column math
    (:func:`encode_columns`, no per-config Python at all — the 100k+
    streaming path); object lists take one attribute pass
    (:func:`config_columns`) first.  Output is bit-identical to
    :func:`encode_configs_legacy`, the per-field implementation kept as
    the equality and ``perf_bench`` baseline.
    """
    if isinstance(configs, dict):
        return encode_columns(configs, strict=strict)
    return encode_columns(config_columns(configs), validate=False)


def encode_configs_legacy(configs) -> dict:
    """The per-lambda baseline implementation of :func:`encode_configs`
    (one list comprehension per column, a Python lambda + property call
    per config per field).  Kept for the equality tests and as the
    ``perf_bench`` encode suite's baseline; new code should call
    :func:`encode_configs`."""
    import numpy as np

    configs = list(configs)
    if not configs:
        raise ValueError("empty config batch")

    def col(fn, dtype):
        return np.asarray([fn(c) for c in configs], dtype=dtype)

    return {
        "policy": col(lambda c: POLICY_IDS[c.lock], np.int32),
        "threads": col(lambda c: c.threads, np.int32),
        "cores": col(lambda c: c.cores, np.float32),
        "cs_lo": col(lambda c: c.cs[0], np.float32),
        "cs_hi": col(lambda c: c.cs[1], np.float32),
        "ncs_lo": col(lambda c: c.ncs[0], np.float32),
        "ncs_hi": col(lambda c: c.ncs[1], np.float32),
        "wake": col(lambda c: c.wake_latency, np.float32),
        "alpha": col(lambda c: c.alpha_eff, np.float32),
        "sws_init": col(lambda c: c.sws_start, np.int32),
        "sws_max": col(lambda c: max(c.sws_max_eff, c.sws_start), np.int32),
        "k": col(lambda c: c.k, np.int32),
        "spin_budget": col(lambda c: c.spin_budget, np.float32),
        "seed": col(lambda c: c.seed, np.uint32),
        "oracle": col(lambda c: ORACLE_IDS[c.oracle], np.int32),
        "workload": col(lambda c: WORKLOAD_IDS[c.workload], np.int32),
        "wl_period": col(lambda c: c.wl_period, np.float32),
        "wl_duty": col(lambda c: c.wl_duty, np.float32),
        "wl_burst": col(lambda c: c.wl_burst, np.float32),
        "wl_spread": col(lambda c: c.wl_spread, np.float32),
        "arrival_phase": col(lambda c: c.arrival_phase, np.float32),
        "arrival": col(lambda c: ARRIVAL_IDS[c.arrival], np.int32),
        "arr_rate": col(lambda c: c.arrival_rate, np.float32),
        "q_cap": col(lambda c: c.queue_cap, np.int32),
        "slo": col(lambda c: c.slo, np.float32),
        "tb": col(lambda c: TIE_BREAK_IDS[c.tie_break], np.int32),
        "fault": col(lambda c: FAULT_IDS[c.fault], np.int32),
        "flt_rate": col(lambda c: c.fault_rate, np.float32),
        "flt_scale": col(lambda c: c.fault_scale, np.float32),
        "park_cost": col(lambda c: c.park_cost, np.float32),
    }


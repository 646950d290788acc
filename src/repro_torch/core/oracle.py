"""SWS adaptation oracles — four families, one shared policy core.

The mutable-lock algorithm is independent of the oracle that resizes the
spinning window (paper §3.1: "the mutable lock algorithm is independent of
the actually selected SWS adaptation oracle").  We keep the oracle pluggable
so the same state machine drives the OS-thread lock, the event-driven DES,
the serving scheduler's active-window controller — and, elementwise, the
batched simulator (:mod:`repro_torch.core.xdes`), which sweeps every family
over thousands of configurations in one device program.

Four families are implemented, each as a branch-free integer-state pure
function ("row") in :mod:`repro_torch.core.policy` that the classes below wrap
with per-lock state (update rules, provenance and tuning guidance are in
``docs/oracles.md``; the sweep is ``benchmarks/oracle_ablation.py``):

* ``paper`` (:class:`EvalSWS`) — the paper's EvalSWS, Algorithm 1 lines
  E1-E12: a thread that **slept and then acquired the spin lock without
  spinning** (``slept and not spun``) proves the window failed to mask
  wake-up latency -> grow ``delta = +sws`` (doubling); no such event for
  ``K`` consecutive acquisitions -> shrink ``delta = -1``.  ``K = 10`` in
  the paper's evaluation: late-wake probability is kept below ~1/(K+1).
* ``aimd`` (:class:`AIMDOracle`) — additive increase (+1 on late wake),
  multiplicative decrease (halve after K clean rounds); the backoff-
  splitting bias of Fissile locks (Dice & Kogan 2020).
* ``fixed`` (:class:`FixedBudgetOracle`) — no adaptation: the window is a
  constant retrial budget, the glibc ``spin_count`` cap / Oracle RDBMS
  ``_spin_count`` design (Nikolaev 2012).
* ``history`` (:class:`HistoryOracle`) — an EWMA of the late-wake rate
  (glibc's adaptive-mutex smoothing applied to the paper's signal): grow
  when the smoothed rate exceeds 2x the 1/(K+1) target, shrink below half.

Every class delegates its update rule to the SAME row the batched backend
evaluates, so threaded and vectorized trajectories are bit-identical
(pinned by ``tests/test_oracles.py``).
"""

from __future__ import annotations

from typing import Protocol

from . import policy
from .policy import ORACLE_IDS, ORACLE_ROWS


class Oracle(Protocol):
    """Signed window variation computed at lock-acquire time."""

    def eval_sws(self, spun: bool, slept: bool, sws: int) -> int:
        """Return the signed variation ``delta`` to apply to ``sws``."""
        ...


class _RowOracle:
    """Stateful wrapper around one vectorized policy row: holds the
    ``(cnt, ewma)`` integer state and feeds it through
    :data:`repro_torch.core.policy.ORACLE_ROWS` — the exact code the batched
    simulator runs elementwise."""

    oracle_id: int

    def __init__(self, k: int = 10):
        if k < 1:
            raise ValueError("K must be >= 1")
        self.k = k
        self.cnt = 0
        self.ewma = 0

    def eval_sws(self, spun: bool, slept: bool, sws: int) -> int:
        delta, self.cnt, self.ewma = ORACLE_ROWS[self.oracle_id](
            int(spun), int(slept), sws, self.cnt, self.ewma, self.k)
        return int(delta)


class EvalSWS(_RowOracle):
    """The paper's oracle, faithful to Algorithm 1 lines E1-E12.

    State ``cnt`` counts consecutive critical-section executions without a
    late wake-up.  It is only read/written while holding ``spn_obj`` (the
    call sits between spn_obj.lock() and the end of ACQUIRE), so it needs no
    extra synchronization — mirroring the paper's placement of ``m.cnt``.
    """

    oracle_id = policy.ORACLE_EVALSWS

    def __init__(self, k: int = 10):
        super().__init__(k)
        # Observability counters (not part of the algorithm).
        self.grow_events = 0
        self.shrink_events = 0

    def eval_sws(self, spun: bool, slept: bool, sws: int) -> int:
        delta = super().eval_sws(spun, slept, sws)
        self.grow_events += delta > 0
        self.shrink_events += delta < 0
        return delta


class AIMDOracle(_RowOracle):
    """Additive-increase / multiplicative-decrease: grow by +1 on late
    wake-up, halve after K clean rounds.

    The paper doubles on a late wake and shrinks by 1; AIMD is the opposite
    bias (favors small windows / CPU savings over latency), the same split
    Fissile locks apply to their backoff budget.
    """

    oracle_id = policy.ORACLE_AIMD


class FixedBudgetOracle(_RowOracle):
    """Fixed retrial budget (glibc ``spin_count`` cap / Oracle RDBMS
    ``_spin_count``): pins the window at ``k`` slots — the classic
    spin-then-park mutex with a constant spin allowance.  Generalizes
    :class:`FixedOracle` (budget = initial window)."""

    oracle_id = policy.ORACLE_FIXED


class HistoryOracle(_RowOracle):
    """EWMA of the late-wake rate in Q8 fixed point (state ``ewma``):
    reacts slower than EvalSWS but is robust to one-off latency spikes."""

    oracle_id = policy.ORACLE_HISTORY


class FixedOracle:
    """Never resizes — degenerates the mutable lock into a static
    spin(window)/sleep hybrid.  Useful as an ablation baseline when the
    static window should stay at ``initial_sws`` (for a specific budget
    use :class:`FixedBudgetOracle`)."""

    def eval_sws(self, spun: bool, slept: bool, sws: int) -> int:
        return 0


#: Family name -> threaded class, aligned with policy.ORACLE_IDS.
ORACLE_CLASSES = {
    "paper": EvalSWS,
    "aimd": AIMDOracle,
    "fixed": FixedBudgetOracle,
    "history": HistoryOracle,
}


def make_oracle(name: str, k: int = 10) -> Oracle:
    """Instantiate the threaded oracle for a family name (the DES-side
    counterpart of a :class:`repro_torch.core.policy.SimConfig` ``oracle``
    row)."""
    if name not in ORACLE_CLASSES:
        raise ValueError(f"unknown oracle {name!r}; "
                         f"options: {sorted(ORACLE_IDS)}")
    return ORACLE_CLASSES[name](k=k)

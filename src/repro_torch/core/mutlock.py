"""The Mutable Lock (paper §3.2, Algorithm 1) — faithful implementation.

A mutable lock is a spin lock (``spn_obj``) plus five variables:

* ``sws``  — current spinning-window size            (hi 32 bits of lstate)
* ``thc``  — thread count: waiters + holder          (lo 32 bits of lstate)
* ``wuc``  — wake-up count for SWS-change correction (C1/C2 countermeasures)
* ``slp_obj`` — blocking object wrapping the OS sleep/wake API (semaphore)
* ``max``  — maximum SWS (defaults to the core count)

State machine (paper §3.1): a thread arriving at index ``i`` (holder at 0)

    i == 0            -> grabs the lock
    i in [1, SWS]     -> spins
    i in (SWS, +inf)  -> sleeps

On release, one spinner wins the lock and one sleeper is woken *into the
spinning window* (the sleep->spin transition) so that wake-up latency is
masked by the next critical section.

Line-number comments (A*, R*, E*) refer to Algorithm 1 in the paper.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from . import policy
from .atomic import AtomicBool, AtomicU64, pack_lstate, sws_delta, unpack_lstate
from .oracle import EvalSWS, Oracle


# --------------------------------------------------------------------------
# spn_obj: test-and-test-and-set spin lock (paper §4 uses "a classical
# test-and-test-and-set spin lock as spn_obj").
# --------------------------------------------------------------------------
class TTASSpin:
    """TTAS spin lock whose ``lock()`` reports whether the caller spun.

    ``lock() -> spun`` must be True iff at least one acquisition attempt
    failed — EvalSWS uses ``slept and not spun`` as the "late wake-up"
    predicate (the woken thread found the lock immediately free, i.e. no
    spinner was hot when the critical section ended).
    """

    def __init__(self, yield_while_spinning: bool = True):
        self._cell = AtomicBool(False)
        # On CPython a pure busy-loop holds the GIL for a full switch
        # interval; yielding keeps the emulation honest on few-core hosts.
        self._yield = yield_while_spinning

    def lock(self) -> bool:
        spun = False
        while True:
            # test ... (cache-local read, no RMW)
            while self._cell.load():
                spun = True
                if self._yield:
                    time.sleep(0)
            # ... and test-and-set
            if not self._cell.test_and_set():
                return spun
            spun = True

    def try_lock(self) -> bool:
        if self._cell.load():
            return False
        return not self._cell.test_and_set()

    def unlock(self) -> None:
        self._cell.clear()


# --------------------------------------------------------------------------
# slp_obj: semaphore-based sleep object (paper §4 uses "a semaphore as
# sleeping object").  Wake-ups are conserved: a wake_up() issued before the
# sleeper parks is absorbed by the semaphore permit, so no lost wake-ups.
# --------------------------------------------------------------------------
class SemSleep:
    def __init__(self):
        self._sem = threading.Semaphore(0)
        self.sleeps = 0
        self.wakes = 0

    def sleep(self) -> None:
        self.sleeps += 1
        self._sem.acquire()

    def wake_up(self, n: int) -> int:
        """Wake ``n`` sleepers; returns the number of wake permits issued."""
        if n <= 0:
            return 0
        self._sem.release(n)
        self.wakes += n
        return n


@dataclass
class MutLockStats:
    """Observability counters (not part of the algorithm)."""

    acquisitions: int = 0
    sleeps: int = 0
    spins: int = 0            # acquisitions that observed contention
    late_wakeups: int = 0     # slept and not spun
    sws_samples: list = field(default_factory=list)


class MutableLock:
    """Paper Algorithm 1.  API mirrors ``threading.Lock`` plus stats.

    ``wuc`` and the oracle state are only touched while holding ``spn_obj``
    (ACQUIRE lines A12-A33 run after A11; RELEASE lines R2-R8 run before
    R10), exactly as in the paper — so they are plain fields.
    """

    def __init__(
        self,
        max_sws: int | None = None,
        initial_sws: int = 1,
        oracle: Oracle | None = None,
        record_stats: bool = False,
    ):
        import os

        self.max = max_sws if max_sws is not None else (os.cpu_count() or 1)
        if not (1 <= initial_sws <= self.max):
            initial_sws = max(1, min(initial_sws, self.max))
        self.lstate = AtomicU64(pack_lstate(initial_sws, 0))
        self.wuc = 0
        self.spn_obj = TTASSpin()
        self.slp_obj = SemSleep()
        self.oracle: Oracle = oracle if oracle is not None else EvalSWS(k=10)
        self.stats = MutLockStats() if record_stats else None
        self._holder: int | None = None  # debug: thread ident of the holder

    # -- introspection ----------------------------------------------------
    @property
    def sws(self) -> int:
        return unpack_lstate(self.lstate.load())[0]

    @property
    def thc(self) -> int:
        return unpack_lstate(self.lstate.load())[1]

    # -- Algorithm 1: ACQUIRE ---------------------------------------------
    def acquire(self) -> None:
        slept = False                                    # A3
        lstate_pre = self.lstate.fetch_add(1)            # A4: thc += 1
        sws, thc_pre = unpack_lstate(lstate_pre)         # A5-A6
        if thc_pre >= sws:                               # A7: no room in SW
            slept = True                                 # A8
            self.slp_obj.sleep()                         # A9: park
        spun = self.spn_obj.lock()                       # A11: spin phase
        self._holder = threading.get_ident()

        if self.stats is not None:
            self.stats.acquisitions += 1
            self.stats.sleeps += slept
            self.stats.spins += spun
            self.stats.late_wakeups += slept and not spun
            self.stats.sws_samples.append(sws)

        delta = self.oracle.eval_sws(spun, slept, sws)   # A12
        if sws != unpack_lstate(self.lstate.load())[0]:  # A13: sws changed
            return                                       # A14: concurrently
        delta = policy.clamp_delta(sws, delta, 1, self.max)  # A16-A17
        if delta != 0:                                   # A18
            lstate_pre = self.lstate.fetch_add(sws_delta(delta))  # A19-A20
            sws_pre, thc = unpack_lstate(lstate_pre)     # A21-A22
            # A23-A33: C1/C2 correction from the shared policy core.
            self.wuc += policy.wake_correction(delta, thc, sws_pre)

    # -- Algorithm 1: RELEASE ---------------------------------------------
    def release(self) -> None:
        if self._holder != threading.get_ident():
            raise RuntimeError("release() by non-holder thread")
        self._holder = None
        r_wuc, self.wuc = policy.latch_wuc(self.wuc)     # R2-R7
        lstate_pre = self.lstate.fetch_add(-1)           # R9: thc -= 1
        self.spn_obj.unlock()                            # R10
        sws, thc_pre = unpack_lstate(lstate_pre)         # R14-R15
        r_wuc = policy.release_quota(r_wuc, thc_pre, sws)  # R11-R17
        while r_wuc > 0:                                 # R19
            cnt = self.slp_obj.wake_up(r_wuc)            # R20
            r_wuc -= cnt                                 # R21

    # -- context-manager / drop-in threading.Lock API ----------------------
    def __enter__(self) -> "MutableLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._holder is not None

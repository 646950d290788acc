"""Baseline lock implementations evaluated against the mutable lock.

The PyTorch port's own copy of ``repro/core/baselines.py`` (framework-free;
the port imports nothing of ``repro``), over the port's
:mod:`repro_torch.core.atomic`.  Mirrors the paper's §4 adversaries:

* ``TASLock``            — naive test-and-set spin lock.
* ``TTASLock``           — test-and-test-and-set spin lock (PT-SPINLOCK proxy).
* ``MCSLock``            — Mellor-Crummey & Scott queue lock [11]: FIFO,
                           each waiter spins on its own node's flag.
* ``SleepLock``          — benaphore (atomic counter + semaphore): the
                           pthread-mutex *default* behaviour — one
                           test-and-set attempt, then sleep.
* ``AdaptiveMutex``      — glibc PTHREAD_MUTEX_ADAPTIVE_NP behaviour: spin
                           for a budget derived from recent history, then
                           sleep.  No sleep->spin transition (the limitation
                           the paper's §2 calls out).

All expose ``acquire()/release()``, context-manager protocol, and cheap
counters so lockbench can attribute CPU time to synchronization.
"""

from __future__ import annotations

import threading
import time

from .atomic import AtomicBool, AtomicU64


class TASLock:
    """Spin on the RMW itself (maximal cache-line bouncing)."""

    def __init__(self):
        self._cell = AtomicBool(False)
        self.spin_iters = 0

    def acquire(self) -> None:
        while self._cell.test_and_set():
            self.spin_iters += 1
            time.sleep(0)

    def release(self) -> None:
        self._cell.clear()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class TTASLock:
    """Read the cell until free, then attempt the RMW (PT-SPINLOCK proxy)."""

    def __init__(self):
        self._cell = AtomicBool(False)
        self.spin_iters = 0

    def acquire(self) -> None:
        while True:
            while self._cell.load():
                self.spin_iters += 1
                time.sleep(0)
            if not self._cell.test_and_set():
                return

    def release(self) -> None:
        self._cell.clear()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _MCSNode:
    __slots__ = ("locked", "next")

    def __init__(self):
        self.locked = True
        self.next: "_MCSNode | None" = None


class MCSLock:
    """Queue lock: FIFO handoff, each waiter spins on its own node.

    The CAS-on-tail and next-pointer handoff follow the MCS paper; waiters
    spin on ``node.locked`` which only the predecessor writes.
    """

    def __init__(self):
        self._tail_mu = threading.Lock()  # linearizes swap/cas on the tail
        self._tail: _MCSNode | None = None
        self._local = threading.local()
        self.spin_iters = 0

    def _swap_tail(self, node: _MCSNode | None) -> "_MCSNode | None":
        with self._tail_mu:
            old = self._tail
            self._tail = node
            return old

    def _cas_tail(self, expected: _MCSNode, new: _MCSNode | None) -> bool:
        with self._tail_mu:
            if self._tail is expected:
                self._tail = new
                return True
            return False

    def acquire(self) -> None:
        node = _MCSNode()
        self._local.node = node
        pred = self._swap_tail(node)
        if pred is not None:
            pred.next = node
            while node.locked:          # spin on own cache line
                self.spin_iters += 1
                time.sleep(0)

    def release(self) -> None:
        node: _MCSNode = self._local.node
        if node.next is None:
            if self._cas_tail(node, None):
                return
            while node.next is None:    # successor announced but not linked
                time.sleep(0)
        node.next.locked = False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class SleepLock:
    """Benaphore: futex-style sleep lock == pthread mutex default behaviour.

    acquire: FAD(count,+1); if the lock was contended, park on the semaphore.
    release: FAD(count,-1); if waiters remain, post one permit.
    Wake-ups are conserved by the semaphore, so no lost wake-ups.
    """

    def __init__(self):
        self._count = AtomicU64(0)
        self._sem = threading.Semaphore(0)
        self.sleeps = 0

    def acquire(self) -> None:
        if self._count.fetch_add(1) > 0:
            self.sleeps += 1
            self._sem.acquire()

    def release(self) -> None:
        if self._count.fetch_add(-1) > 1:
            self._sem.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class AdaptiveMutex:
    """glibc adaptive mutex: bounded spin first, then benaphore sleep.

    The spin budget tracks recent acquisition history exactly like glibc's
    ``mutex->__data.__spins += (cnt - spins) / 8`` running average, capped at
    ``max_spin``.  Crucially there is **no sleep->spin transition**: a thread
    that sleeps is woken straight into the acquisition race, paying the full
    wake-up latency — the gap the mutable lock closes.
    """

    MAX_SPIN = 100

    def __init__(self):
        self._cell = AtomicBool(False)
        self._waiters = AtomicU64(0)
        self._sem = threading.Semaphore(0)
        self._spins = 10  # running-average spin budget
        self.sleeps = 0
        self.spin_iters = 0

    def acquire(self) -> None:
        budget = min(self.MAX_SPIN, 2 * self._spins + 10)
        cnt = 0
        while cnt < budget:
            if not self._cell.load() and not self._cell.test_and_set():
                self._spins += (cnt - self._spins) // 8
                return
            cnt += 1
            self.spin_iters += 1
            time.sleep(0)
        self._spins += (cnt - self._spins) // 8
        # Sleep path (default-mutex behaviour).
        while True:
            self._waiters.fetch_add(1)
            if not self._cell.load() and not self._cell.test_and_set():
                self._waiters.fetch_add(-1)
                return
            self.sleeps += 1
            self._sem.acquire()
            self._waiters.fetch_add(-1)
            if not self._cell.test_and_set():
                return

    def release(self) -> None:
        self._cell.clear()
        if self._waiters.load() > 0:
            self._sem.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


#: Registry used by lockbench and the framework's lock factory.
LOCKS = {
    "tas": TASLock,
    "ttas": TTASLock,
    "mcs": MCSLock,
    "sleep": SleepLock,
    "adaptive": AdaptiveMutex,
}

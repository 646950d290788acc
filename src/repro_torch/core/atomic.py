"""Atomic primitives for the mutable-lock algorithm.

The paper (§3.2) stores the lock state as a single 64-bit word
``lstate = <sws(hi 32), thc(lo 32)>`` manipulated exclusively through atomic
Fetch&Add (FAD), so that a thread updating one field atomically observes the
other.  CPython exposes no user-level FAD; :class:`AtomicU64` emulates it with
a nano-scale internal mutex.  The *semantics* (linearizable FAD on a packed
64-bit word, two's-complement wrap) are identical to the hardware
instruction; only the constant factor differs, which is documented in
DESIGN.md §3 as a changed assumption.

Packing convention (paper §3.2)::

    lstate = (sws << 32) | thc          # both unsigned 32-bit fields
    FAD(lstate, +1)        -> thc += 1
    FAD(lstate, -1)        -> thc -= 1
    FAD(lstate, delta<<32) -> sws += delta   (no carry into/out of thc by
                                              construction: thc>0 on -1, etc.)
"""

from __future__ import annotations

import threading

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def pack_lstate(sws: int, thc: int) -> int:
    """Pack ``(sws, thc)`` into the 64-bit lstate word."""
    return ((sws & _MASK32) << 32) | (thc & _MASK32)


def unpack_lstate(word: int) -> tuple[int, int]:
    """Unpack the 64-bit lstate word into ``(sws, thc)``."""
    return (word >> 32) & _MASK32, word & _MASK32


def sws_delta(delta: int) -> int:
    """Encode a signed sws variation as a FAD operand (two's complement)."""
    return (delta << 32) & _MASK64


class AtomicU64:
    """A 64-bit word supporting linearizable fetch_add / load / cas.

    Emulates the x86 ``lock xadd`` / ``lock cmpxchg`` used by the paper's C
    implementation.  All mutation goes through one internal lock, so every
    operation is a single linearization point exactly like the hardware
    instruction.
    """

    __slots__ = ("_value", "_mu")

    def __init__(self, value: int = 0):
        self._value = value & _MASK64
        self._mu = threading.Lock()

    def fetch_add(self, delta: int) -> int:
        """Atomic FAD: returns the value *before* the addition (``x^-``)."""
        with self._mu:
            old = self._value
            self._value = (old + delta) & _MASK64
            return old

    def load(self) -> int:
        # A 64-bit aligned load is atomic on the target hardware; the lock
        # here only guards against torn reads of the Python int swap.
        return self._value

    def store(self, value: int) -> None:
        with self._mu:
            self._value = value & _MASK64

    def compare_and_swap(self, expected: int, new: int) -> bool:
        with self._mu:
            if self._value == expected:
                self._value = new & _MASK64
                return True
            return False


class AtomicBool:
    """Test-and-set cell for TAS/TTAS spin locks."""

    __slots__ = ("_value", "_mu")

    def __init__(self, value: bool = False):
        self._value = value
        self._mu = threading.Lock()

    def test_and_set(self) -> bool:
        """Atomically set True; return the *previous* value."""
        with self._mu:
            old = self._value
            self._value = True
            return old

    def load(self) -> bool:
        return self._value

    def clear(self) -> None:
        with self._mu:
            self._value = False

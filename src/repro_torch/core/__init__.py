"""repro_torch.core — the paper's contribution, Mutable Locks (Marotta et
al., 2019), in the PyTorch port.  The same public API as ``repro.core``:

* :class:`MutableLock`     — Algorithm 1, drop-in for ``threading.Lock``.
* :class:`SpinningWindow`  — the window state machine, reusable for any
                             bounded-active-set resource (serving scheduler).
* :class:`MutableWait`     — self-tuned hybrid spin/sleep predicate wait.
* :mod:`baselines`         — TAS/TTAS/MCS/sleep/adaptive adversaries.
* :mod:`des`               — deterministic discrete-event validation of the
                             paper's multi-core claims.

Beside them the port's batched simulator (:mod:`.xdes`, on the card through
the ``lock_sim_block`` kernels) and its streamed sweep (:mod:`.stream`),
which are imported on their own: this package's import pulls in no
``torch``.
"""

from . import policy
from .atomic import AtomicBool, AtomicU64, pack_lstate, sws_delta, unpack_lstate
from .baselines import LOCKS, AdaptiveMutex, MCSLock, SleepLock, TASLock, TTASLock
from .mutlock import MutableLock, MutLockStats, SemSleep, TTASSpin
from .oracle import (AIMDOracle, EvalSWS, FixedBudgetOracle, FixedOracle,
                     HistoryOracle, Oracle, make_oracle)
from .policy import (DEFAULT_ALPHA, ORACLE_IDS, POLICY_IDS, SimConfig,
                     clamp_delta, encode_configs, eval_sws_delta, latch_wuc,
                     oracle_update, release_quota, should_sleep_on_arrival,
                     wake_correction)
from .waitpolicy import MutableWait
from .window import SpinningWindow

#: Factory registry: every lock the framework can be configured with.
ALL_LOCKS = dict(LOCKS, mutable=MutableLock)


def make_lock(kind: str = "mutable", **kwargs):
    """Instantiate a lock by name (``mutable|tas|ttas|mcs|sleep|adaptive``)."""
    try:
        cls = ALL_LOCKS[kind]
    except KeyError as e:
        raise ValueError(f"unknown lock kind {kind!r}; "
                         f"options: {sorted(ALL_LOCKS)}") from e
    return cls(**kwargs)


__all__ = [
    "AtomicBool", "AtomicU64", "pack_lstate", "unpack_lstate", "sws_delta",
    "MutableLock", "MutLockStats", "SemSleep", "TTASSpin",
    "EvalSWS", "FixedOracle", "AIMDOracle", "FixedBudgetOracle",
    "HistoryOracle", "Oracle", "make_oracle",
    "SpinningWindow", "MutableWait",
    "TASLock", "TTASLock", "MCSLock", "SleepLock", "AdaptiveMutex",
    "LOCKS", "ALL_LOCKS", "make_lock",
    "policy", "SimConfig", "encode_configs",
    "POLICY_IDS", "DEFAULT_ALPHA", "ORACLE_IDS",
    "eval_sws_delta", "oracle_update", "clamp_delta", "wake_correction",
    "latch_wuc", "release_quota", "should_sleep_on_arrival",
]

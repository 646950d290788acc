"""Spans and counters of the sweep path, on the profiler's clock.

**Switching them on.**  The spans record exactly while a ``torch.profiler``
records; nothing else turns them on.  Wrap the call::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch import trace
    from repro_torch.core.stream import sweep_stream

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = sweep_stream(cols, target_cs=150)
    s = trace.session()
    s.stats()["rollout.flag"]       # {"count", "total_ns", "self_ns"}
    s.counters["rollout.row_steps"]

Each span is also entered as a profiler record of its name
(``torch._C._profiler._RecordFunctionFast``), so the profiler's own trace
(``prof.export_chrome_trace``) shows it on the host's row, on the
kernels' clock, as an operation (``cpu_op``).  Not as a
``torch.profiler.record_function``: that is a ``user_annotation``, which
Kineto also projects onto the card's timeline as a device event covering
the kernels launched inside it, and a reader that takes every device
event for work then counts those kernels twice (on an H100, K1's device
seconds read doubled and its roofline share halved).  Nothing is written
to disk here.

**The gate.**  ``sweep_stream``, ``simulate_columns`` and
``simulate_batch`` call :func:`gate` once on entry (whether a profiler
records) and pass the bool down; every span and counter site tests it.
Off, :func:`span` returns one shared null context and :func:`count` does
nothing: no record, no CUDA event, no device work.

**Sessions.**  The first span after the profiler turns on (an entry's
gate read finding it on where the previous read found it off) starts a new
session and drops the previous one; :func:`session` returns the newest, or
``None``.  Two profilers back to back, with no untraced entry between
them, share one session.  A session holds:

* ``records``: one tuple a finished span, ``(name, id, parent, sweep,
  shard, start_ns, end_ns)``.  ``parent`` is the enclosing span's id (-1
  at the root); ``sweep`` is the root span's id, shared by every span of
  one ``sweep_stream`` call; ``shard`` is the shard index (inherited from
  the enclosing span where a site gives none; ``None`` outside a shard).
  Times are Unix-epoch nanoseconds from ``time.time_ns()``, the clock
  the profiler converts its events to (``start_ns()`` of its Kineto
  events).  ``perf_counter_ns`` plus a fixed offset would drift from it
  wherever the wall clock is slewed (0.5 % on one test machine).
* ``counters``: totals by name.

**Spans**, from the entry point down: ``stream.sweep`` (a
``sweep_stream`` call), ``stream.encode``, ``stream.plan``,
``stream.copy_in`` (a shard's columns to its device), ``rollout.core``
(the rollout: the shards' carries and the block loop), ``rollout.block``
(one block of one shard), ``wrappers.launch`` (K1's wrapper: checks,
outputs, pointers, the launch; the plain version on the CPU),
``rollout.flag`` (a shard's count of converged rows read back: the host
waits on K1 and the reduction), ``stream.copy_back`` (a shard's summaries
to the host), ``stream.reduce`` (quarantine and ``CellReduce``).

**Counters.**  ``rollout.row_steps``: rows times sub-steps of every block
launched (the tail block cut at the horizon); ``rollout.done_row_steps``:
the part of them on rows whose ``completed`` had reached ``target_cs``
when the block started, counted where the rollout reads the flag (early
exit on).  Both sum over the shards.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: Fields of a record, in order.
FIELDS = ("name", "id", "parent", "sweep", "shard", "start_ns", "end_ns")

_OFF = contextlib.nullcontext()


class Session:
    """The spans and counters recorded under one profiler (see the module
    docstring)."""

    def __init__(self):
        self.records: list[tuple] = []
        self.counters: dict[str, int] = defaultdict(int)
        self._open: list[_Span] = []
        self._next_id = 0

    def stats(self) -> dict[str, dict]:
        """For each span name: ``count``, ``total_ns`` and ``self_ns`` (the
        durations less the parts their child spans cover)."""
        covered = defaultdict(int)
        for r in self.records:
            if r[2] >= 0:
                covered[r[2]] += r[6] - r[5]
        out = {}
        for r in self.records:
            d = out.setdefault(r[0], {"count": 0, "total_ns": 0,
                                      "self_ns": 0})
            d["count"] += 1
            d["total_ns"] += r[6] - r[5]
            d["self_ns"] += r[6] - r[5] - covered[r[1]]
        return out


class _Span:
    __slots__ = ("_s", "_name", "_shard", "_id", "_parent", "_sweep",
                 "_t0", "_rf")

    def __init__(self, s: Session, name: str, shard):
        self._s, self._name, self._shard = s, name, shard

    def __enter__(self):
        s = self._s
        top = s._open[-1] if s._open else None
        self._id = s._next_id
        s._next_id += 1
        if top is None:
            self._parent, self._sweep = -1, self._id
        else:
            self._parent, self._sweep = top._id, top._sweep
            if self._shard is None:
                self._shard = top._shard
        s._open.append(self)
        self._rf = torch._C._profiler._RecordFunctionFast(self._name)
        self._rf.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        s = self._s
        t1 = time.time_ns()
        self._rf.__exit__(*exc)
        s._open.pop()
        s.records.append((self._name, self._id, self._parent, self._sweep,
                          self._shard, self._t0, t1))
        return False


_session: Session | None = None
_was_on = False     # what the last gate read found
_fresh = False      # the profiler turned on since: the next span starts one


def gate() -> bool:
    """Whether a profiler records now; read once on entry to a sweep and
    passed down."""
    global _was_on, _fresh
    on = torch._C._autograd._profiler_enabled()
    if on and not _was_on:
        _fresh = True
    _was_on = on
    return on


def _current() -> Session:
    global _session, _fresh
    if _fresh or _session is None:
        _session, _fresh = Session(), False
    return _session


def span(on: bool, name: str, shard: int | None = None):
    """A span named ``name`` where ``on``, else a shared null context."""
    return _Span(_current(), name, shard) if on else _OFF


def count(on: bool, name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` where ``on``."""
    if on:
        _current().counters[name] += n


def session() -> Session | None:
    """The newest session, or ``None`` before the first traced span."""
    return _session

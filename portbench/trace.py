"""Reading the profiler's trace of a measured window.

The harness runs the window under ``torch.profiler`` (CPU and CUDA
activity) inside a ``record_function`` span named :data:`WINDOW` and hands
the profiler's events here in Chrome-trace form (:func:`profiler_events`;
nothing is written to disk).  Device activity is every
kernel, copy and set on a card; its busy time is the union of those
intervals inside the window, per card.  An idle gap is a stretch of the
window in which a card runs nothing, labelled by the innermost host
operation (an ATen op or a CUDA runtime call) under the gap's middle, or
``host (no traced op)`` when the host was in Python between calls.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NO_OP = "host (no traced op)"


def union(intervals: np.ndarray) -> np.ndarray:
    """Merged, sorted ``(n, 2)`` intervals of ``(n, 2)`` ``[start, end]``."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    return np.stack([iv[first, 0], reach[last]], axis=1)


def gaps(busy: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The complement of merged intervals ``busy`` within ``[lo, hi]``."""
    e = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    return e[e[:, 1] > e[:, 0]]


def read(events: list) -> dict:
    """Window, device busy and idle, kernel totals and idle gaps by host
    activity from trace events: Chrome-trace dicts (times in
    microseconds) or ``(name, cat, ts, dur, device)`` tuples."""
    rows = [e if isinstance(e, tuple) else
            (e.get("name"), e.get("cat"), float(e.get("ts", 0.0)),
             float(e.get("dur", -1.0)), int(e.get("args", {})
                                              .get("device", 0)))
            for e in events]
    win = [r for r in rows if r[0] == WINDOW and r[1] == "user_annotation"]
    if not win:
        return {}
    lo, hi = win[0][2], win[0][2] + win[0][3]
    per_dev = defaultdict(list)
    by_name = defaultdict(float)
    kernel_s = 0.0
    host = []
    for name, cat, ts, dur, dev in rows:
        if dur < 0 or ts > hi or ts + dur < lo:
            continue
        if cat in DEVICE_CATS:
            a, b = max(ts, lo), min(ts + dur, hi)
            if b <= a:
                continue
            per_dev[dev].append((a, b))
            by_name[name] += (b - a) * 1e-6
            if cat == "kernel":
                kernel_s += (b - a) * 1e-6
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, name))
    if not per_dev:
        return {}
    busy = {d: union(np.asarray(v, float)) for d, v in per_dev.items()}
    busy_s = {d: float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6
              for d, iv in busy.items()}
    host.sort(key=lambda h: h[0])
    starts = np.asarray([h[0] for h in host], float)
    idle = gaps(busy[min(busy)], lo, hi)
    mids = 0.5 * (idle[:, 0] + idle[:, 1])
    js = np.searchsorted(starts, mids, side="right")
    idle_by = defaultdict(float)
    for (a, b), mid, j in zip(idle, mids, js):
        label, best = NO_OP, None
        for k in range(j - 1, max(j - 16, -1), -1):
            s, t, name = host[k]
            if t >= mid and (best is None or t - s < best):
                label, best = name, t - s
        idle_by[label] += (b - a) * 1e-6
    top = lambda d: [[k, float(v)] for k, v in sorted(d.items(),
                                                      key=lambda kv: -kv[1])
                     [:10]]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": busy_s,
            "devices": sorted(busy),
            "idle_intervals": len(idle),
            "kernel_s": kernel_s,
            "device_ops": top(by_name),
            "idle_gaps": top(idle_by)}


def _category(e) -> str:
    """The Chrome-trace category of a Kineto event, from the fields every
    profiler build has (``activity_type`` where it exists)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    if e.name() == WINDOW:
        return "user_annotation"
    if str(e.device_type()).endswith("CUDA"):
        if e.name().startswith("Memcpy"):
            return "gpu_memcpy"
        if e.name().startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if e.name().startswith("cuda") else "cpu_op"


def profiler_events(prof) -> list:
    """The events of a finished ``torch.profiler.profile`` as ``(name,
    cat, ts, dur, device)`` tuples (microseconds), read from its
    in-memory results."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        cat = _category(e)
        if name == WINDOW and cat != "user_annotation":
            continue                    # the span's projection on a card
        out.append((name, cat, e.start_ns() * 1e-3, e.duration_ns() * 1e-3,
                    e.device_index()))
    return out

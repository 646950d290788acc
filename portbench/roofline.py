"""The yardstick of the kernel layer: peaks of the card and the work a
sweep's inputs need.

Frozen copies of the data-sheet peaks and of the simulator kernel's
operation counts that the port's chip smoke test uses
(``chip_smoke.py``: ``SIMT_LANE_OPS_PER_S``, ``HBM_BYTES_PER_S``,
``OPS_PER_THREAD_STEP``, ``OPS_PER_THREAD_STEP_OPEN``,
``OPS_PER_ROW_STEP_OPEN``).  The work counted is what the inputs need,
not what a rollout launches: each config's planned horizon (the frozen
planner of :mod:`portbench.traffic`, capped at the step cap) rounded up to
a whole 32-step block, times its active threads, at the count of a
sub-step in which nothing happens; each input column and each output
column crosses memory once.  So the count does not change with the
implementation, and a rollout that runs fewer wasted row-steps reads a
larger share.
"""

from __future__ import annotations

import numpy as np

from . import traffic as TR

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
#: Single f32 / i32 lane operations a second outside the tensor cores:
#: 128 lanes a clock per SM x 132 SMs x 1.98 GHz (no FMA: -fmad=false).
SIMT_LANE_OPS_PER_S = 128 * 132 * 1.98e9
#: Lane operations of one simulated thread in a sub-step in which nothing
#: happens (closed loop), and the open loop's per-thread and per-row
#: additions.
OPS_PER_THREAD_STEP = 46
OPS_PER_THREAD_STEP_OPEN = OPS_PER_THREAD_STEP + 10
OPS_PER_ROW_STEP_OPEN = 38 + 5 + 7
#: Bytes of a config's encoded input columns (30 context columns and dt)
#: and of its summary outputs (7 closed columns; open: 7 more and the
#: 64-bin histogram), 4 bytes each.
IN_BYTES = 31 * 4
OUT_BYTES_CLOSED = 7 * 4
OUT_BYTES_OPEN = (7 + 7 + 64) * 4


def needed_work(cols: dict, target_cs: int) -> dict:
    """Operations and bytes one sweep of ``cols`` needs."""
    _, steps = TR.plan(cols, target_cs)
    B = TR.BLOCK_STEPS
    steps = -(-np.minimum(steps, TR.MAX_STEPS) // B) * B
    threads = np.asarray(cols["threads"], np.int64)
    open_loop = bool(np.any(np.asarray(cols.get("arrival", 0)) != 0))
    C = len(threads)
    if open_loop:
        ops = int((steps * (threads * OPS_PER_THREAD_STEP_OPEN
                            + OPS_PER_ROW_STEP_OPEN)).sum())
        n_bytes = C * (IN_BYTES + OUT_BYTES_OPEN)
    else:
        ops = int((steps * threads * OPS_PER_THREAD_STEP).sum())
        n_bytes = C * (IN_BYTES + OUT_BYTES_CLOSED)
    return {"ops": ops, "bytes": n_bytes,
            "seconds": max(ops / SIMT_LANE_OPS_PER_S,
                           n_bytes / HBM_BYTES_PER_S)}

"""What decides ``correct``: the timed sweep's answers against the plain
reference.

Three layers are compared, each exactly (an exact comparison has the
limit 0; see ``PERF.md`` for the readings the limits were set from):

* **rollout** — a sample of the sweep's configs, drawn from the run's
  seed, plus the config with the longest planned horizon, recomputed by
  :mod:`portbench.reference.locksim` for as many steps as the sweep ran
  them: every summary field, bit for bit (``rows_differing``); the open
  loop's latency histogram where a departure's bin is fixed to the last
  ulp of a device ``log2`` (:func:`hist_agrees`).  Every row's ``t_end``
  must be its steps run times its ``dt`` (``t_end_wrong``) and every
  float summary finite (``nonfinite``).
* **early exit** — a sweep that stopped before its planned horizon did so
  at a block boundary with every config at ``target_cs`` or more, and no
  sampled config converged later than it stopped (``exit_faults``).
* **reduction** — the on-device ``CellReduce`` win counts equal a host
  recount from the sweep's own per-config throughput
  (``wins_differing``).
"""

from __future__ import annotations

import os

import numpy as np

from . import traffic as TR
from .reference import locksim as L

#: Configs of the sweep the reference recomputes, besides the one with
#: the longest planned horizon.
SAMPLE = 16
LIMITS = {"rows_differing": 0, "wins_differing": 0, "exit_faults": 0,
          "t_end_wrong": 0, "nonfinite": 0}
SUMMARY = ("completed", "spin_cpu", "wake_count", "final_sws", "t_end",
           "steps_run", "fairness")
OPEN_SUMMARY = ("arrived", "shed", "departed", "slo_viol", "lat_sum",
                "occ_int", "in_flight")


def sample_rows(seed: int, C: int, steps: np.ndarray) -> list[int]:
    """The configs checked: :data:`SAMPLE` drawn from the seed, and the
    first config with the longest planned horizon."""
    rng = np.random.default_rng(int(seed) & (2 ** 63 - 1))
    rows = rng.choice(C, size=min(SAMPLE, C), replace=False).tolist()
    longest = int(np.argmax(steps))
    return sorted(set(rows) | {longest})


def hist_agrees(prog, ref, amb) -> bool:
    """A program histogram against the reference's: equal, except that a
    departure the reference found within 1e-4 of a bin edge may sit in
    either neighbouring bin (``amb[b]`` counts those at the edge below
    bin ``b``, each counted by ``ref`` in bin ``b - 1``)."""
    prog, ref, amb = (np.asarray(a, np.int64) for a in (prog, ref, amb))
    if prog.sum() != ref.sum():
        return False
    cp, cr = np.cumsum(prog), np.cumsum(ref)
    slack = amb[1:len(cp) + 1]
    return bool(np.all((cp <= cr) & (cp >= cr - slack)))


def row_agrees(prog: dict, ref: dict) -> bool:
    """One config's summary (the fields of ``prog``) against the
    reference's: equal field for field, the histogram by
    :func:`hist_agrees`."""
    for f, v in prog.items():
        if f == "lat_hist":
            if not hist_agrees(v, ref["lat_hist"], ref["lat_ambiguous"]):
                return False
        elif not v == ref[f]:
            return False
    return True


def host_wins(completed, t_end, cell_ids, n_cells: int, group: int):
    """The win counts recounted on the host in the device's float32: the
    first throughput maximum of each group of variants, added to its
    cell."""
    thr = (np.asarray(completed).astype(np.float32)
           / np.maximum(np.asarray(t_end, np.float32), np.float32(1e-30)))
    win = thr.reshape(-1, group).argmax(axis=1)
    wins = np.zeros((n_cells, group), np.int64)
    np.add.at(wins, (np.asarray(cell_ids), win), 1)
    return wins


def _field(res, name):
    v = getattr(res, name, None)
    return None if v is None else np.asarray(v)


def compare(sweep: TR.Sweep, cols: dict, res, seed: int,
            workers: int | None = None) -> dict:
    """Readings of every check of one sweep's result ``res`` (a
    ``StreamResult``) for the RAW columns ``cols`` it ran; the reference
    runs in ``workers`` processes (default: one a CPU)."""
    C = sweep.n_configs
    dt, steps = TR.plan(cols, sweep.target_cs)
    horizon = min(int(steps.max()), TR.MAX_STEPS)
    steps_run = _field(res, "steps_run").astype(np.int64)
    completed = _field(res, "completed").astype(np.int64)
    t_end = _field(res, "t_end").astype(np.float32)
    out = {}

    floats = [_field(res, f) for f in ("t_end", "spin_cpu", "lat_sum",
                                       "occ_int")]
    out["nonfinite"] = int(sum((~np.isfinite(a.astype(np.float64))).sum()
                               for a in floats if a is not None))
    out["t_end_wrong"] = int(np.count_nonzero(
        t_end != (steps_run.astype(np.float32) * dt).astype(np.float32)))

    early = steps_run < horizon
    exit_faults = int(np.count_nonzero(early & (completed
                                                < sweep.target_cs)))
    exit_faults += int(np.count_nonzero(early & (steps_run
                                                 % TR.BLOCK_STEPS != 0)))
    exit_faults += int(np.count_nonzero(steps_run > horizon))

    wins = _field(res, "wins")
    if wins is None:
        out["wins_differing"] = C // sweep.group
    else:
        ref_wins = host_wins(completed, t_end, sweep.cell_ids,
                             len(sweep.cell_names), sweep.group)
        out["wins_differing"] = int(np.abs(ref_wins - wins).sum()) \
            if wins.shape == ref_wins.shape else C // sweep.group

    rows = sample_rows(seed, C, steps)
    # longest first (about the critical sections a row runs), so the
    # pool's last task is a short one
    rows.sort(key=lambda i: -steps_run[i] / max(int(steps[i]), 1))
    got = run_rows([(TR.encode_row(cols, i, dt[i]), int(steps_run[i]),
                     sweep.target_cs, "float32") for i in rows], workers)
    open_loop = _field(res, "lat_hist") is not None
    fields = SUMMARY + (OPEN_SUMMARY + ("lat_hist",) if open_loop else ())
    differing = 0
    for i, r in zip(rows, got):
        differing += not row_agrees({f: _field(res, f)[i] for f in fields},
                                    r)
        cb = r["converged_block"]
        if early[i] and cb is not None and cb * TR.BLOCK_STEPS > steps_run[i]:
            exit_faults += 1
    out["rows_differing"] = differing
    out["exit_faults"] = exit_faults
    out["rows_checked"] = len(rows)
    return out


def run_rows(args, workers: int | None = None):
    """:func:`portbench.reference.locksim.simulate_row` over argument
    tuples in a pool of spawned processes (one per CPU, at most one per
    task); every process has ended when this returns."""
    import multiprocessing as mp

    n = max(1, min(len(args), workers or os.cpu_count() or 1))
    if n == 1:
        return [L.simulate_row(*a) for a in args]
    pool = mp.get_context("spawn").Pool(n)
    try:
        out = pool.starmap(L.simulate_row, args, chunksize=1)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return out


def verdict(readings: dict) -> bool:
    return all(readings[k] <= v for k, v in LIMITS.items())

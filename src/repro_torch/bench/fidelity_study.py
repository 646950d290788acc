"""dt-convergence study on the port: xdes quantization error vs the
event-driven DES.

The batched engine (:mod:`repro_torch.core.xdes`, on the card through the
``lock_sim_block`` kernel) quantizes time to a fixed ``dt`` and resolves
simultaneous events in thread-id order; the event-driven DES
(:mod:`repro_torch.core.des`, on the host) is exact.  This study pins the
quantization-error band: it sweeps ``dt`` across two decades around the
planner's default (``plan_schedule`` picks ``min(cs_mean, wake)/6``) on
three workload rows and reports the relative throughput and spin-CPU
error of xdes against seed-averaged DES ground truth — every xdes cell
from ONE batched call (per-config ``dt`` column, shared horizon, early
exit).

    PYTHONPATH=src python -m repro_torch.bench.fidelity_study [--quick] \
        [--backend ref] [--device cpu]

Artifacts: ``reports/torch/fidelity_dt.json`` (full grid) and
``reports/torch/fidelity_dt.md`` (the table), written as the reference's
``benchmarks/fidelity_study.py`` writes them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.core import xdes
from repro_torch.core.des import simulate
from repro_torch.core.policy import SimConfig
from repro_torch.device import resolve_device

SHORT = (0.0, 3.7e-6)
WAKE = 8e-6

#: The workload rows of the study (3 of the 4 registry rows; hetero is
#: covered by the parity tests — its per-thread scales make seed-averaged
#: DES ground truth needlessly expensive for a dt sweep).
ROWS = ("constant", "bursty", "jitter")
#: (lock, threads, cores) cells: a windowed and a pure-spin discipline.
CELLS = (("mutable", 8, 4), ("ttas", 12, 4))
#: dt grid (s): two decades around the planner default (~0.3 µs here).
DTS = (1e-7, 3e-7, 1e-6, 3e-6, 1e-5)


def _cfg(row, lock, threads, cores, seed):
    return SimConfig(lock, threads=threads, cores=cores, cs=SHORT,
                     ncs=SHORT, wake_latency=WAKE, seed=seed, workload=row,
                     wl_period=8e-5)


def run_study(seeds=(0, 1, 2), des_target: int = 2500,
              xdes_target: int = 1200, n_steps: int = 150_000,
              verbose: bool = True, backend: str = "kernel",
              device=None) -> dict:
    """Returns the full (workload x cell x dt) error grid.

    DES ground truth is seed-averaged throughput / spin-CPU-per-CS; the
    xdes side runs every (workload, cell, seed, dt) combination in one
    ``simulate_batch`` call with a per-config ``dt`` column, on ``device``
    (``None``: the card, raising without CUDA before the DES runs).
    """
    device = resolve_device(device)
    t0 = time.time()
    des_ref = {}
    for row in ROWS:
        for lock, tc, cores in CELLS:
            rs = [simulate(lock, threads=tc, cores=cores, cs=SHORT,
                           ncs=SHORT, wake_latency=WAKE,
                           target_cs=des_target, seed=s,
                           **_cfg(row, lock, tc, cores, s)
                           .workload_kwargs())
                  for s in seeds]
            des_ref[(row, lock)] = {
                "throughput": float(np.mean([r.throughput for r in rs])),
                "sync_cpu_per_cs":
                    float(np.mean([r.sync_cpu_per_cs for r in rs])),
            }
    des_wall = time.time() - t0

    cfgs, dts = [], []
    for row in ROWS:
        for lock, tc, cores in CELLS:
            for s in seeds:
                for dt in DTS:
                    cfgs.append(_cfg(row, lock, tc, cores, s))
                    dts.append(dt)
    t0 = time.time()
    res = xdes.simulate_batch(cfgs, dt=np.asarray(dts, np.float32),
                              n_steps=n_steps, target_cs=xdes_target,
                              early_exit=True, backend=backend,
                              device=device)
    xdes_wall = time.time() - t0

    S, D = len(seeds), len(DTS)
    thr = res.throughput.reshape(len(ROWS), len(CELLS), S, D).mean(axis=2)
    cpu = res.sync_cpu_per_cs.reshape(len(ROWS), len(CELLS), S,
                                      D).mean(axis=2)

    grid = []
    for ri, row in enumerate(ROWS):
        for ci, (lock, tc, cores) in enumerate(CELLS):
            ref = des_ref[(row, lock)]
            for di, dt in enumerate(DTS):
                thr_err = thr[ri, ci, di] / ref["throughput"] - 1.0
                cpu_err = (cpu[ri, ci, di]
                           / max(ref["sync_cpu_per_cs"], 1e-12) - 1.0)
                grid.append({
                    "workload": row, "lock": lock, "threads": tc,
                    "cores": cores, "dt": dt,
                    "throughput_rel_err": round(float(thr_err), 4),
                    "spin_cpu_rel_err": round(float(cpu_err), 4),
                })

    band = {f"{dt:g}": round(float(max(
        abs(g["throughput_rel_err"]) for g in grid if g["dt"] == dt)), 4)
        for dt in DTS}
    out = {
        "meta": {"rows": list(ROWS),
                 "cells": [list(c) for c in CELLS], "dts": list(DTS),
                 "seeds": list(seeds), "des_target_cs": des_target,
                 "xdes_target_cs": xdes_target,
                 "des_wall_s": round(des_wall, 1),
                 "xdes_wall_s": round(xdes_wall, 1),
                 "n_configs": len(cfgs)},
        "des_reference": {f"{r}/{l}": v for (r, l), v in des_ref.items()},
        "grid": grid,
        "throughput_err_band_by_dt": band,
    }
    if verbose:
        print(f"fidelity study: {len(cfgs)} xdes configs in one call "
              f"({xdes_wall:.1f}s) vs {len(des_ref) * len(seeds)} DES runs "
              f"({des_wall:.1f}s)")
        print(f"{'dt (s)':>8}  max |throughput err|")
        for dt in DTS:
            print(f"{dt:8g}  {band[f'{dt:g}']:.1%}")
    return out


def write_md(out: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write("# dt-convergence study — xdes vs event-driven DES\n\n")
        m = out["meta"]
        f.write(f"Workload rows {m['rows']}, cells {m['cells']} "
                f"(lock, threads, cores), seeds {m['seeds']}; xdes side is "
                f"{m['n_configs']} configs in ONE batched call "
                f"({m['xdes_wall_s']}s).  Reading guide: "
                "docs/performance.md#fidelity-the-dt-quantization-error-"
                "band, docs/workloads.md.\n\n")
        f.write("## Max |relative throughput error| by dt\n\n"
                "| dt (s) | band |\n|---|---|\n")
        for dt in m["dts"]:
            f.write(f"| {dt:g} | "
                    f"{out['throughput_err_band_by_dt'][f'{dt:g}']:.1%} "
                    "|\n")
        f.write("\n## Full grid\n\n| workload | lock | dt (s) "
                "| throughput err | spin-CPU err |\n|---|---|---|---|---|\n")
        for g in out["grid"]:
            f.write(f"| {g['workload']} | {g['lock']} | {g['dt']:g} "
                    f"| {g['throughput_rel_err']:+.1%} "
                    f"| {g['spin_cpu_rel_err']:+.1%} |\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer seeds / shorter horizons (~4x faster)")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="kernel: the CUDA kernel; ref: its plain PyTorch "
                         "version")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    ap.add_argument("--out", default="reports/torch/fidelity_dt.json")
    args = ap.parse_args(argv)
    out = run_study(seeds=(0,) if args.quick else (0, 1, 2),
                    des_target=800 if args.quick else 2500,
                    xdes_target=400 if args.quick else 1200,
                    backend=args.backend, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    md_path = os.path.splitext(args.out)[0] + ".md"
    write_md(out, md_path)
    print(f"wrote {args.out}, {md_path}")
    return out


if __name__ == "__main__":
    main()

"""Workload x discipline x oracle diagram — which lock wins under which
workload, on the port.

Every workload row (``repro_torch.core.policy.WORKLOAD_ROWS``: the paper's
constant uniform draws, bursty ON/OFF duty cycles, heterogeneous
per-thread CS/NCS scales, Poisson-like jittered arrivals) crossed with
every discipline-diagram variant, on every random scenario of the
adaptive-spin design space — one
:func:`repro_torch.core.xdes.simulate_batch` call
(:func:`repro_torch.bench.sweep.workload_grid`) through the
``lock_sim_block`` kernel on the card (``--backend ref``: its plain
PyTorch version; ``--device cpu``: on the host).  The winner flips with
workload shape; the mutable lock's value is that it does not need to know
the shape in advance.  Artifacts, under ``reports/torch/`` by default:

* ``workload_diagram.json`` — full per-(workload, variant) stats
* ``workload_phase_diagram.csv`` — which (discipline, oracle) wins per
  (workload x CS length x subscription) bucket
* ``workload_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/workload_diagram.py``): the
same result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.workload_diagram \
        [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep
from repro_torch.bench.discipline_diagram import auto_scenarios
from repro_torch.configs.catalog import (LOCK_WORKLOADS,
                                         lock_workload_variants)


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "workload_phase_diagram"
                        ) -> tuple[str, str]:
    """Render the workload grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    meta = result["meta"]
    variant_names = meta["variant_names"]

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("workload,cs,subscription,n,winner,win_share,"
                + ",".join(f"wins_{n}" for n in variant_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['workload']},{cell['cs']},{cell['sub']},"
                    f"{cell['n']},{cell['winner']},{cell['win_share']},"
                    + ",".join(str(cell["wins_by_variant"].get(n, 0))
                               for n in variant_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    with open(md_path, "w") as f:
        f.write("# Workload phase diagram — which lock wins under which "
                "workload\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_workloads']} workload rows x "
                f"{meta['n_variants']} (discipline, oracle) variants = "
                f"{meta['n_configs']} configurations, one "
                f"{'sharded ' if meta['sharded'] else ''}batched xdes call "
                f"({meta['backend']} backend, {meta['n_devices']} "
                f"device(s), {meta['n_steps']} steps, {meta['wall_s']}s "
                f"wall).\n\nWorkload rows and how to read this page: "
                "docs/workloads.md; discipline rows: docs/disciplines.md; "
                "oracle families: docs/oracles.md.\n\n")
        f.write("## Discipline wins per workload (best variant per "
                "scenario)\n\n")
        disc_names = list(next(iter(result["workloads"].values())))
        f.write("| workload | " + " | ".join(disc_names)
                + " | top discipline |\n")
        f.write("|---" * (len(disc_names) + 2) + "|\n")
        for w, rows in result["workloads"].items():
            top = max(rows, key=lambda d: rows[d]["wins"])
            f.write(f"| {w} | "
                    + " | ".join(str(rows[d]["wins"]) for d in disc_names)
                    + f" | {top} |\n")
        f.write("\n## Phase diagram\n\nBuckets: workload row x CS length "
                "(short ≤ 10 µs < mid ≤ 100 µs < long) x subscription "
                "(threads vs cores).  The per-scenario best is taken "
                "within the workload, so winners are judged against the "
                "other locks under the same hold-time model.\n\n")
        f.write("| workload | CS | subscription | n | winning variant "
                "| win share |\n|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['workload']} | {cell['cs']} | {cell['sub']} "
                    f"| {cell['n']} | {cell['winner']} "
                    f"| {cell['win_share']:.2f} |\n")
        f.write("\n## Variant detail (per workload)\n\n| workload "
                "| variant | wins | mean ratio | p10 ratio "
                "| spin CPU/CS (µs) |\n|---|---|---|---|---|---|\n")
        for v in sorted(result["variants"],
                        key=lambda v: (v["workload"],
                                       -v["mean_ratio_to_best"])):
            f.write(f"| {v['workload']} | {v['name']} | {v['wins']} "
                    f"| {v['mean_ratio_to_best']:.3f} "
                    f"| {v['p10_ratio_to_best']:.3f} "
                    f"| {v['mean_sync_cpu_per_cs_us']:.2f} |\n")
    return csv_path, md_path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke-scale grid (<60 s on CPU)")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="default: auto-sized to the device count "
                         "(100/device full, 12/device with --quick)")
    ap.add_argument("--target-cs", type=int, default=None,
                    help="default: 150 (40 with --quick)")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="kernel: the CUDA kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-shard", action="store_true",
                    help="turn the config-axis split off even where there "
                         "is more than one shard device")
    ap.add_argument("--stream", choices=("auto", "on", "off"),
                    default="auto",
                    help="run the grid chunk-by-chunk under a memory "
                         "budget (auto: stream at >= %d configs)"
                         % sweep.STREAM_AUTO)
    ap.add_argument("--mem-mb", type=float, default=None,
                    help="streaming memory budget in MiB (default: "
                         "REPRO_SWEEP_MEM_MB env, else device-derived)")
    ap.add_argument("--out", default="reports/torch/workload_diagram.json")
    args = ap.parse_args(argv)

    n_variants = len(lock_workload_variants())
    base = 12 if args.quick else 100
    n_scenarios = args.scenarios or auto_scenarios(
        base, n_variants, device=args.device)
    result = sweep.workload_grid(
        n_scenarios=n_scenarios,
        target_cs=args.target_cs or (40 if args.quick else 150),
        backend=args.backend, seed=args.seed,
        workloads=LOCK_WORKLOADS,
        shard=False if args.no_shard else None,
        stream={"auto": None, "on": True, "off": False}[args.stream],
        mem_mb=args.mem_mb, device=args.device)

    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    csv_path, md_path = write_phase_diagram(result, out_dir)
    print(f"wrote {args.out}, {csv_path}, {md_path}")
    return result


if __name__ == "__main__":
    main()

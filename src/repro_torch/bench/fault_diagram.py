"""Fault x discipline diagram — which lock survives which failure mode, on
the port.

Every fault/interference row (``repro_torch.core.policy.FAULT_ROWS``: the
benign baseline, lock-holder preemption, CPU oversubscription, lost
wake-ups with timeout recovery, and timer jitter) crossed with every
(discipline, oracle) variant of the discipline diagram, on every random
scenario of the adaptive-spin design space — one
:func:`repro_torch.core.xdes.simulate_batch` call, or a streamed sweep at
>= :data:`repro_torch.bench.sweep.STREAM_AUTO` configs
(:func:`repro_torch.bench.sweep.fault_grid`), through the
``lock_sim_block`` kernel on the card (``--backend ref``: its plain
PyTorch version; ``--device cpu``: on the host).

The ``none`` row reproduces the benign "which lock wins where" map on the
same scenarios; the fault rows show where that ranking flips.  Artifacts,
under ``reports/torch/`` by default:

* ``fault_diagram.json`` — full per-(fault, variant) stats
* ``fault_phase_diagram.csv`` — which (discipline, oracle) wins per
  (fault x CS length x subscription) bucket
* ``fault_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/fault_diagram.py``): the same
result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.fault_diagram [--quick] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep
from repro_torch.bench.discipline_diagram import auto_scenarios
from repro_torch.configs.catalog import (LOCK_FAULTS,
                                         lock_discipline_variants)


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "fault_phase_diagram"
                        ) -> tuple[str, str]:
    """Render the fault grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    variant_names = result["meta"]["variant_names"]
    faults = result["meta"]["faults"]

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("fault,cs,subscription,n,winner,win_share,"
                + ",".join(f"wins_{n}" for n in variant_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['fault']},{cell['cs']},{cell['sub']},"
                    f"{cell['n']},{cell['winner']},{cell['win_share']},"
                    + ",".join(str(cell["wins_by_variant"].get(n, 0))
                               for n in variant_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    meta = result["meta"]
    with open(md_path, "w") as f:
        f.write("# Fault phase diagram — which lock survives which "
                "failure mode\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_faults']} fault rows x {meta['n_variants']} "
                f"(discipline, oracle) variants = {meta['n_configs']} "
                f"configurations, one "
                f"{'sharded ' if meta['sharded'] else ''}batched xdes call "
                f"({meta['backend']} backend, {meta['n_devices']} "
                f"device(s), {meta['n_steps']} steps, {meta['wall_s']}s "
                f"wall).\n\nFault rows, their encodings and the "
                "scenario-scaled fault window: docs/robustness.md; "
                "discipline rows: docs/disciplines.md.\n\n")
        f.write("## Fault summary (wins and throughput retained vs the "
                "benign row)\n\n")
        f.write("| fault | " + " | ".join(
            f"{d} wins / retained"
            for d in next(iter(result["faults"].values()))) + " |\n")
        f.write("|---|" + "---|" * len(
            next(iter(result["faults"].values()))) + "\n")
        for fl in faults:
            rows = result["faults"][fl]
            cells = []
            for d, r in rows.items():
                ret = ("—" if r["mean_retained_vs_none"] is None
                       else f"{r['mean_retained_vs_none']:.2f}")
                cells.append(f"{r['wins']} / {ret}")
            f.write(f"| {fl} | " + " | ".join(cells) + " |\n")
        f.write("\n## Phase diagram\n\nBuckets: fault row x CS length "
                "(short ≤ 10 µs < mid ≤ 100 µs < long) x subscription "
                "(threads vs cores).  The `none` rows reproduce the "
                "benign discipline diagram on the same scenarios.\n\n")
        f.write("| fault | CS | subscription | n | winning variant "
                "| win share |\n|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['fault']} | {cell['cs']} | {cell['sub']} "
                    f"| {cell['n']} | {cell['winner']} "
                    f"| {cell['win_share']:.2f} |\n")
        f.write("\n## Variant detail\n\n| fault | variant | wins "
                "| mean ratio | p10 ratio | retained vs none "
                "| spin CPU/CS (µs) |\n|---|---|---|---|---|---|---|\n")
        for v in result["variants"]:
            ret = ("—" if v["mean_retained_vs_none"] is None
                   else f"{v['mean_retained_vs_none']:.3f}")
            f.write(f"| {v['fault']} | {v['name']} | {v['wins']} "
                    f"| {v['mean_ratio_to_best']:.3f} "
                    f"| {v['p10_ratio_to_best']:.3f} | {ret} "
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
    ap.add_argument("--out", default="reports/torch/fault_diagram.json")
    args = ap.parse_args(argv)

    n_cells = len(LOCK_FAULTS) * len(lock_discipline_variants())
    base = 12 if args.quick else 100
    n_scenarios = args.scenarios or auto_scenarios(
        base, n_cells, device=args.device)
    result = sweep.fault_grid(
        n_scenarios=n_scenarios,
        target_cs=args.target_cs or (40 if args.quick else 150),
        backend=args.backend, seed=args.seed,
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

"""Discipline x oracle diagram — the full "which lock wins where" map, on
the port.

Every waiting-discipline row (``repro_torch.core.policy.DISCIPLINE_ROWS``:
the spin family, the pure sleep lock, the glibc adaptive mutex, the
paper's mutable lock, the FIFO/MCS ticket-handoff row and the related-work
rows) crossed with every SWS oracle family (``ORACLE_ROWS``), on every
random scenario of the adaptive-spin design space — one
:func:`repro_torch.core.xdes.simulate_batch` call
(:func:`repro_torch.bench.sweep.discipline_grid`) through the
``lock_sim_block`` kernel on the card (``--backend ref``: its plain
PyTorch version; ``--device cpu``: on the host).  ``--refine`` adds the
coarse->dense phase-boundary lattice (:func:`repro_torch.bench.sweep.
refine_grid`).  Artifacts, under ``reports/torch/`` by default:

* ``discipline_diagram.json`` — full per-variant stats
* ``discipline_phase_diagram.csv`` — which (discipline, oracle) wins per
  workload bucket (CS length x subscription x wake latency)
* ``discipline_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/discipline_diagram.py``): the
same result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.discipline_diagram \
        [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep
from repro_torch.configs.catalog import lock_discipline_variants
from repro_torch.device import shard_count


def auto_scenarios(base: int, n_variants: int,
                   max_configs: int = 100_000, device=None) -> int:
    """Scale the scenario count to the shard devices of ``device``
    (:func:`repro_torch.device.shard_count`): ``base`` per shard, capped
    so the grid stays under ``max_configs`` rows."""
    return min(base * max(1, shard_count(device)),
               max(base, max_configs // max(1, n_variants)))


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "discipline_phase_diagram"
                        ) -> tuple[str, str]:
    """Render the discipline grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    variant_names = [v["name"] for v in result["variants"]]

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("cs,subscription,wake,n,winner,win_share,"
                + ",".join(f"wins_{n}" for n in variant_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['cs']},{cell['sub']},{cell['wake']},"
                    f"{cell['n']},{cell['winner']},{cell['win_share']},"
                    + ",".join(str(cell["wins_by_variant"].get(n, 0))
                               for n in variant_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    meta = result["meta"]
    with open(md_path, "w") as f:
        f.write("# Discipline phase diagram — which lock wins where\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_variants']} (discipline, oracle) variants = "
                f"{meta['n_configs']} configurations, one "
                f"{'sharded ' if meta['sharded'] else ''}batched xdes call "
                f"({meta['backend']} backend, {meta['n_devices']} "
                f"device(s), {meta['n_steps']} steps, {meta['wall_s']}s "
                f"wall).\n\nDiscipline rows and how to add one: "
                "docs/disciplines.md; oracle families: docs/oracles.md.\n\n")
        f.write("## Discipline summary (best variant per scenario)\n\n")
        f.write("| discipline | wins | best-variant mean ratio-to-best "
                "| mean spin CPU/CS (µs) |\n|---|---|---|---|\n")
        for name, row in result["disciplines"].items():
            f.write(f"| {name} | {row['wins']} "
                    f"| {row['best_variant_mean_ratio']:.3f} "
                    f"| {row['mean_sync_cpu_per_cs_us']:.2f} |\n")
        f.write("\n## Phase diagram\n\nBuckets: CS length (short ≤ 10 µs "
                "< mid ≤ 100 µs < long), subscription (threads vs cores), "
                "wake latency (fast ≤ 10 µs < slow).\n\n")
        f.write("| CS | subscription | wake | n | winning variant "
                "| win share |\n|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['cs']} | {cell['sub']} | {cell['wake']} "
                    f"| {cell['n']} | {cell['winner']} "
                    f"| {cell['win_share']:.2f} |\n")
        f.write("\n## Variant detail\n\n| variant | wins | mean ratio "
                "| p10 ratio | spin CPU/CS (µs) |\n|---|---|---|---|---|\n")
        for v in sorted(result["variants"],
                        key=lambda v: -v["mean_ratio_to_best"]):
            f.write(f"| {v['name']} | {v['wins']} "
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
                         "(200/device full, 24/device with --quick)")
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
    ap.add_argument("--refine", action="store_true",
                    help="also run the coarse->dense phase-boundary "
                         "refinement lattice (sweep.refine_grid) and "
                         "attach it under result['refine']")
    ap.add_argument("--out", default="reports/torch/discipline_diagram.json")
    args = ap.parse_args(argv)

    n_variants = len(lock_discipline_variants())
    base = 24 if args.quick else 200
    n_scenarios = args.scenarios or auto_scenarios(
        base, n_variants, device=args.device)
    result = sweep.discipline_grid(
        n_scenarios=n_scenarios,
        target_cs=args.target_cs or (40 if args.quick else 150),
        backend=args.backend, seed=args.seed,
        shard=False if args.no_shard else None,
        stream={"auto": None, "on": True, "off": False}[args.stream],
        mem_mb=args.mem_mb, device=args.device)
    if args.refine:
        result["refine"] = sweep.refine_grid(
            nx=8 if args.quick else 16, ny=6 if args.quick else 12,
            factor=2 if args.quick else 3,
            target_cs=args.target_cs or (40 if args.quick else 150),
            backend=args.backend, seed=args.seed,
            shard=False if args.no_shard else None,
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

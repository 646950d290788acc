"""Park-cost x discipline diagram — when is parking worth it, on the port.

The M:N lightweight-thread environment axis (``SimConfig.park_cost``
scaling the park/unpark round trip across three orders of magnitude)
crossed with every (discipline, oracle) variant of the discipline
diagram, on every random scenario of the adaptive-spin design space — one
:func:`repro_torch.core.xdes.simulate_batch` call
(:func:`repro_torch.bench.sweep.park_grid`) through the ``lock_sim_block``
kernel on the card (``--backend ref``: its plain PyTorch version;
``--device cpu``: on the host).  The ``park_cost=1`` slice reproduces the
benign "which lock wins where" map on the same scenarios.  Artifacts,
under ``reports/torch/`` by default:

* ``park_diagram.json`` — full per-(park_cost, variant) stats
* ``park_phase_diagram.csv`` — which (discipline, oracle) wins per
  (park_cost x CS length x subscription) bucket
* ``park_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/park_diagram.py``): the same
result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.park_diagram [--quick] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep
from repro_torch.bench.discipline_diagram import auto_scenarios
from repro_torch.configs.catalog import (LOCK_PARK_COSTS,
                                         lock_discipline_variants)


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "park_phase_diagram"
                        ) -> tuple[str, str]:
    """Render the park grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    variant_names = result["meta"]["variant_names"]
    park_costs = result["meta"]["park_costs"]

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("park_cost,cs,subscription,n,winner,win_share,"
                + ",".join(f"wins_{n}" for n in variant_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['park_cost']},{cell['cs']},{cell['sub']},"
                    f"{cell['n']},{cell['winner']},{cell['win_share']},"
                    + ",".join(str(cell["wins_by_variant"].get(n, 0))
                               for n in variant_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    meta = result["meta"]
    with open(md_path, "w") as f:
        f.write("# Park-cost phase diagram — when is parking worth "
                "it\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_park_costs']} park costs x "
                f"{meta['n_variants']} (discipline, oracle) variants = "
                f"{meta['n_configs']} configurations, one "
                f"{'sharded ' if meta['sharded'] else ''}batched xdes call "
                f"({meta['backend']} backend, {meta['n_devices']} "
                f"device(s), {meta['n_steps']} steps, {meta['wall_s']}s "
                f"wall).\n\nThe park_cost axis and the discipline rows: "
                "docs/disciplines.md.\n\n")
        f.write("## Park-cost summary (wins and throughput retained vs "
                "park_cost=1)\n\n")
        f.write("| park_cost | " + " | ".join(
            f"{d} wins / retained"
            for d in next(iter(result["park_costs"].values()))) + " |\n")
        f.write("|---|" + "---|" * len(
            next(iter(result["park_costs"].values()))) + "\n")
        for p in park_costs:
            rows = result["park_costs"][str(p)]
            cells = []
            for d, r in rows.items():
                ret = ("—" if r["mean_retained_vs_unit"] is None
                       else f"{r['mean_retained_vs_unit']:.2f}")
                cells.append(f"{r['wins']} / {ret}")
            f.write(f"| {p} | " + " | ".join(cells) + " |\n")
        f.write("\n## Phase diagram\n\nBuckets: park_cost x CS length "
                "(short ≤ 10 µs < mid ≤ 100 µs < long) x subscription "
                "(threads vs cores).  The `park_cost=1` rows reproduce "
                "the benign discipline diagram on the same scenarios.\n\n")
        f.write("| park_cost | CS | subscription | n | winning variant "
                "| win share |\n|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['park_cost']} | {cell['cs']} "
                    f"| {cell['sub']} | {cell['n']} | {cell['winner']} "
                    f"| {cell['win_share']:.2f} |\n")
        f.write("\n## Variant detail\n\n| park_cost | variant | wins "
                "| mean ratio | p10 ratio | retained vs unit "
                "| spin CPU/CS (µs) |\n|---|---|---|---|---|---|---|\n")
        for v in result["variants"]:
            ret = ("—" if v["mean_retained_vs_unit"] is None
                   else f"{v['mean_retained_vs_unit']:.3f}")
            f.write(f"| {v['park_cost']} | {v['name']} | {v['wins']} "
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
                         "(50/device full, 8/device with --quick)")
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
    ap.add_argument("--out", default="reports/torch/park_diagram.json")
    args = ap.parse_args(argv)

    n_cells = len(LOCK_PARK_COSTS) * len(lock_discipline_variants())
    base = 8 if args.quick else 50
    n_scenarios = args.scenarios or auto_scenarios(
        base, n_cells, device=args.device)
    result = sweep.park_grid(
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

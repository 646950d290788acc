"""Arrival-rate x discipline diagram — which lock serves traffic best, on
the port.

Every open-loop arrival row (``repro_torch.core.policy.ARRIVAL_ROWS``:
constant-rate Poisson and the ON/OFF bursty row) at every offered-load
fraction of the scenario's service capacity, crossed with every
discipline-diagram variant, on random scenarios of the adaptive-spin
design space — one :func:`repro_torch.core.xdes.simulate_batch` call
(:func:`repro_torch.bench.sweep.arrival_grid`) through the open variant of
the ``lock_sim_block`` kernel on the card (``--backend ref``: its plain
PyTorch version; ``--device cpu``: on the host), reporting per-request
p50/p95/p99, SLO-violation fraction and shed fraction from the on-device
latency histograms.  Artifacts, under ``reports/torch/`` by default:

* ``arrival_diagram.json`` — full per-(arrival, rho, variant) stats
* ``arrival_phase_diagram.csv`` — throughput AND p95 winner per
  (arrival row x offered load) cell
* ``arrival_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/arrival_diagram.py``): the
same result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.arrival_diagram \
        [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep
from repro_torch.bench.discipline_diagram import auto_scenarios
from repro_torch.configs.catalog import (LOCK_ARRIVAL_RHOS,
                                         LOCK_ARRIVALS,
                                         lock_arrival_variants)


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "arrival_phase_diagram"
                        ) -> tuple[str, str]:
    """Render the arrival grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    variant_names = result["meta"]["variant_names"]

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("arrival,rho,n,winner,win_share,lat_winner,lat_win_share,"
                "mean_slo_frac,mean_shed_frac,"
                + ",".join(f"wins_{n}" for n in variant_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['arrival']},{cell['rho']},{cell['n']},"
                    f"{cell['winner']},{cell['win_share']},"
                    f"{cell['lat_winner']},{cell['lat_win_share']},"
                    f"{cell['mean_slo_frac']:.6f},"
                    f"{cell['mean_shed_frac']:.6f},"
                    + ",".join(str(cell["wins_by_variant"].get(n, 0))
                               for n in variant_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    meta = result["meta"]
    with open(md_path, "w") as f:
        f.write("# Arrival phase diagram — which lock serves traffic "
                "best\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_arrivals']} arrival rows x {meta['n_rhos']} "
                f"load fractions x {meta['n_variants']} (discipline, "
                f"oracle) variants = {meta['n_configs']} configurations, "
                f"one {'sharded ' if meta['sharded'] else ''}open-loop "
                f"batched xdes call ({meta['backend']} backend, "
                f"{meta['n_devices']} device(s), {meta['n_steps']} steps, "
                f"{meta['wall_s']}s wall).\n\nArrival rows and the "
                "latency-histogram semantics: docs/open_loop.md; "
                "discipline rows: docs/disciplines.md.\n\n")
        f.write("## Phase diagram\n\nCells: arrival row x offered load "
                "(fraction rho of the scenario's closed-form service "
                "capacity).  Winners by throughput and by mean p95 "
                "sojourn; SLO/shed fractions are cell means.\n\n")
        f.write("| arrival | rho | n | thr winner | share | p95 winner "
                "| share | SLO-viol | shed |\n"
                "|---|---|---|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['arrival']} | {cell['rho']} | {cell['n']} "
                    f"| {cell['winner']} | {cell['win_share']:.2f} "
                    f"| {cell['lat_winner']} "
                    f"| {cell['lat_win_share']:.2f} "
                    f"| {cell['mean_slo_frac']:.3f} "
                    f"| {cell['mean_shed_frac']:.3f} |\n")
        f.write("\n## Variant detail\n\n| arrival | rho | variant | thr "
                "wins | p95 wins | mean p50 (µs) | mean p95 (µs) "
                "| mean p99 (µs) | SLO-viol | shed |\n"
                "|---|---|---|---|---|---|---|---|---|---|\n")
        for v in result["variants"]:
            f.write(f"| {v['arrival']} | {v['rho']} | {v['name']} "
                    f"| {v['wins']} | {v['lat_wins']} "
                    f"| {v['mean_p50_us']:.1f} | {v['mean_p95_us']:.1f} "
                    f"| {v['mean_p99_us']:.1f} | {v['mean_slo_frac']:.3f} "
                    f"| {v['mean_shed_frac']:.3f} |\n")
    return csv_path, md_path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke-scale grid (<60 s on CPU)")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="default: auto-sized to the device count "
                         "(50/device full, 6/device with --quick)")
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
    ap.add_argument("--out", default="reports/torch/arrival_diagram.json")
    args = ap.parse_args(argv)

    n_variants = len(lock_arrival_variants())
    base = 6 if args.quick else 50
    n_scenarios = args.scenarios or auto_scenarios(
        base, n_variants, device=args.device)
    result = sweep.arrival_grid(
        n_scenarios=n_scenarios,
        target_cs=args.target_cs or (40 if args.quick else 150),
        backend=args.backend, seed=args.seed,
        arrivals=LOCK_ARRIVALS, rhos=LOCK_ARRIVAL_RHOS,
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

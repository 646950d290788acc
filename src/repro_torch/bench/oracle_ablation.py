"""Oracle ablation — the paper's future work ("study other approaches to
resize the spinning window", §5) on the port, as ONE batched call.

Four SWS-adaptation families, each swept over its ``(K, sws_max)`` tuning
grid on every random scenario of the adaptive-spin design space:

    paper   — EvalSWS: double on late wake-up, -1 after K clean (E1-E12)
    aimd    — +1 on late wake-up, halve after K clean (Fissile-style
              backoff splitting: favors CPU savings over latency)
    fixed   — no adaptation: window pinned at the retrial budget K
              (glibc ``spin_count`` cap / Oracle RDBMS ``_spin_count``)
    history — EWMA of the late-wake rate (glibc adaptive-mutex smoothing);
              grow above 2x the 1/(K+1) target, shrink below half

The whole ``(oracle, K, sws_max) x scenario`` product is one
:func:`repro_torch.core.xdes.simulate_batch` call
(:func:`repro_torch.bench.sweep.oracle_grid`) through the ``lock_sim_block``
kernel on the card (``--backend ref``: its plain PyTorch version;
``--device cpu``: on the host).  Artifacts, under ``reports/torch/`` by
default:

* ``oracle_ablation.json`` — full per-variant / per-family stats
* ``oracle_phase_diagram.csv`` — which family wins per workload bucket
  (CS length x subscription x wake latency)
* ``oracle_phase_diagram.md`` — the same as a readable report

The writer is the reference's (``benchmarks/oracle_ablation.py``): the
same result dict gives byte-identical files.

    PYTHONPATH=src python -m repro_torch.bench.oracle_ablation [--quick] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import sweep


def write_phase_diagram(result: dict, reports_dir: str = "reports/torch",
                        stem: str = "oracle_phase_diagram") -> tuple[str, str]:
    """Render the oracle grid's phase diagram to ``<stem>.csv`` and
    ``<stem>.md`` under ``reports_dir``.  Returns the two paths."""
    os.makedirs(reports_dir, exist_ok=True)
    fam_names = list(result["families"])

    csv_path = os.path.join(reports_dir, stem + ".csv")
    with open(csv_path, "w") as f:
        f.write("cs,subscription,wake,n,winner,win_share,"
                + ",".join(f"wins_{n}" for n in fam_names) + "\n")
        for cell in result["phase"]:
            f.write(f"{cell['cs']},{cell['sub']},{cell['wake']},"
                    f"{cell['n']},{cell['winner']},{cell['win_share']},"
                    + ",".join(str(cell["wins_by_family"][n])
                               for n in fam_names) + "\n")

    md_path = os.path.join(reports_dir, stem + ".md")
    meta = result["meta"]
    with open(md_path, "w") as f:
        f.write("# Oracle phase diagram — which SWS oracle wins where\n\n")
        f.write(f"{meta['n_scenarios']} random scenarios x "
                f"{meta['n_variants']} (oracle, K, sws_max) variants = "
                f"{meta['n_configs']} mutable-lock configurations, one "
                f"batched xdes call ({meta['backend']} backend, "
                f"{meta['n_steps']} steps, {meta['wall_s']}s wall).\n\n"
                "Update rules and tuning guidance: docs/oracles.md.\n\n")
        f.write("## Family summary (best tuning per scenario)\n\n")
        f.write("| family | wins | best-tuned mean ratio-to-best "
                "| mean spin CPU/CS (µs) |\n|---|---|---|---|\n")
        for name, row in result["families"].items():
            f.write(f"| {name} | {row['wins']} "
                    f"| {row['best_tuned_mean_ratio']:.3f} "
                    f"| {row['mean_sync_cpu_per_cs_us']:.2f} |\n")
        f.write("\n## Phase diagram\n\nBuckets: CS length (short ≤ 10 µs "
                "< mid ≤ 100 µs < long), subscription (threads vs cores), "
                "wake latency (fast ≤ 10 µs < slow).\n\n")
        f.write("| CS | subscription | wake | n | winning family "
                "| win share |\n|---|---|---|---|---|---|\n")
        for cell in result["phase"]:
            f.write(f"| {cell['cs']} | {cell['sub']} | {cell['wake']} "
                    f"| {cell['n']} | {cell['winner']} "
                    f"| {cell['win_share']:.2f} |\n")
        f.write("\n## Variant detail\n\n| variant | wins | mean ratio "
                "| p10 ratio | spin CPU/CS (µs) | mean final SWS |\n"
                "|---|---|---|---|---|---|\n")
        for v in sorted(result["variants"],
                        key=lambda v: -v["mean_ratio_to_best"]):
            f.write(f"| {v['name']} | {v['wins']} "
                    f"| {v['mean_ratio_to_best']:.3f} "
                    f"| {v['p10_ratio_to_best']:.3f} "
                    f"| {v['mean_sync_cpu_per_cs_us']:.2f} "
                    f"| {v['mean_final_sws']:.1f} |\n")
    return csv_path, md_path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke-scale grid (<30 s)")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="default: 200 (24 with --quick)")
    ap.add_argument("--target-cs", type=int, default=None,
                    help="default: 150 (40 with --quick)")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="kernel: the CUDA kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", choices=("auto", "on", "off"),
                    default="auto",
                    help="run the grid chunk-by-chunk under a memory "
                         "budget (auto: stream at >= %d configs)"
                         % sweep.STREAM_AUTO)
    ap.add_argument("--mem-mb", type=float, default=None,
                    help="streaming memory budget in MiB (default: "
                         "REPRO_SWEEP_MEM_MB env, else device-derived)")
    ap.add_argument("--out", default="reports/torch/oracle_ablation.json")
    args = ap.parse_args(argv)

    stream = {"auto": None, "on": True, "off": False}[args.stream]
    if args.quick:
        result = sweep.oracle_grid(n_scenarios=args.scenarios or 24,
                                   target_cs=args.target_cs or 40,
                                   backend=args.backend, seed=args.seed,
                                   ks=(3, 10), sws_maxes=(None,),
                                   stream=stream, mem_mb=args.mem_mb,
                                   device=args.device)
    else:
        result = sweep.oracle_grid(n_scenarios=args.scenarios or 200,
                                   target_cs=args.target_cs or 150,
                                   backend=args.backend, seed=args.seed,
                                   stream=stream, mem_mb=args.mem_mb,
                                   device=args.device)

    # all three artifacts (JSON + CSV + MD) land in the same directory
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    csv_path, md_path = write_phase_diagram(result, out_dir)
    print(f"wrote {args.out}, {csv_path}, {md_path}")
    return result


if __name__ == "__main__":
    main()

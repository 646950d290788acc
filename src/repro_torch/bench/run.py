"""Benchmark orchestrator on the port — one entry per paper artifact.

The port of ``benchmarks/run.py``, through ``repro_torch.bench`` only:

    PYTHONPATH=src python -m repro_torch.bench.run [--quick | --full] \\
        [--device cpu]

| benchmark  | paper artifact         | module                            |
|------------|------------------------|-----------------------------------|
| fig1       | Fig. 1 timelines       | repro_torch.bench.lockbench (DES) |
| fig3       | Fig. 3 lockbench grid  | repro_torch.bench.lockbench (xdes) |
| sweep      | Fig. 3 grid + scenario | repro_torch.bench.sweep           |
| phold      | Fig. 4 PHOLD/PDES      | repro_torch.bench.phold           |
| sched      | §3 technique, batches  | repro_torch.bench.sched_bench     |
| oracle     | §5 oracle families     | repro_torch.bench.oracle_ablation |
| discipline | discipline x oracle map| repro_torch.bench.discipline_diagram |
| workload   | workload x lock map    | repro_torch.bench.workload_diagram |
| arrival    | open-loop traffic map  | repro_torch.bench.arrival_diagram |
| fault      | fault x lock map       | repro_torch.bench.fault_diagram   |
| park       | park-cost x lock map   | repro_torch.bench.park_diagram    |
| perf       | engine perf trajectory | repro_torch.bench.perf_bench      |

The sweeps run through the kernels on the card (``--device cpu``: their
plain versions on the host).  Artifacts land under ``reports/torch/``;
the summary CSV printed at the end has the reference's row names.
``--quick`` runs the batched sweep, the oracle-family grid, the five
diagrams and ``perf_bench --quick`` at smoke scale.
"""

from __future__ import annotations

import argparse
import json
import os
import time

REPORTS = os.path.join("reports", "torch")


def _banner(text: str, first: bool = False) -> None:
    print(("" if first else "\n") + "=" * 72)
    print(text)
    print("=" * 72)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sample counts (slower)")
    ap.add_argument("--quick", action="store_true",
                    help="batched-sweep smoke only")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    args = ap.parse_args(argv)
    dev = [] if args.device is None else ["--device", args.device]
    os.makedirs(REPORTS, exist_ok=True)
    t0 = time.time()
    summary: list[tuple[str, object]] = []

    if args.quick:
        _banner("[quick] batched xdes sweep smoke (fig3 grid + scenarios)",
                first=True)
        from repro_torch.bench import sweep
        sw = sweep.main(["--quick"] + dev)
        for claim, ok in sw["fig3"]["claims"].items():
            summary.append((f"sweep.fig3.{claim}", ok))
        summary.append(("sweep.scenario.mutable.mean_ratio",
                        round(sw["scenario"]["mean_ratio_to_best"]
                              ["mutable"], 3)))
        _banner("[quick] oracle-family grid smoke (phase-diagram report)")
        from repro_torch.bench import oracle_ablation
        oa = oracle_ablation.main(["--quick"] + dev)
        for fam, row in oa["families"].items():
            summary.append((f"oracle.{fam}.best_tuned_ratio",
                            round(row["best_tuned_mean_ratio"], 3)))
        _banner("[quick] discipline x oracle diagram smoke")
        from repro_torch.bench import discipline_diagram
        dd = discipline_diagram.main(["--quick"] + dev)
        for disc, row in dd["disciplines"].items():
            summary.append((f"discipline.{disc}.wins", row["wins"]))
        _banner("[quick] workload x discipline diagram smoke")
        from repro_torch.bench import workload_diagram
        wd = workload_diagram.main(["--quick"] + dev)
        for w, rows in wd["workloads"].items():
            top = max(rows, key=lambda d: rows[d]["wins"])
            summary.append((f"workload.{w}.top", top))
        _banner("[quick] arrival x discipline diagram smoke (open loop)")
        from repro_torch.bench import arrival_diagram
        ad = arrival_diagram.main(["--quick"] + dev)
        for cell in ad["phase"]:
            summary.append(
                (f"arrival.{cell['arrival']}.rho{cell['rho']}.winner",
                 cell["winner"]))
        _banner("[quick] fault x discipline diagram smoke")
        from repro_torch.bench import fault_diagram
        fd = fault_diagram.main(["--quick"] + dev)
        for fl, rows in fd["faults"].items():
            top = max(rows, key=lambda d: rows[d]["wins"])
            summary.append((f"fault.{fl}.top", top))
        _banner("[quick] park-cost x discipline diagram smoke")
        from repro_torch.bench import park_diagram
        # 4 scenarios keep the park_cost=100 horizons inside the smoke
        pd = park_diagram.main(["--quick", "--scenarios", "4"] + dev)
        for p, rows in pd["park_costs"].items():
            top = max(rows, key=lambda d: rows[d]["wins"])
            summary.append((f"park.{p}.top", top))
        _banner("[quick] xdes perf microbenchmark")
        from repro_torch.bench import perf_bench
        pb = perf_bench.main(["--quick", "--out", os.path.join(
            REPORTS, "bench_xdes_quick.json")] + dev)
        for name, x in pb["speedups"].items():
            summary.append((f"perf.{name}", x))
        _banner(f"quick smoke done in {time.time()-t0:.0f}s — summary CSV")
        _print_csv(summary)
        return summary

    _banner("[1/12] lockbench fig1 (paper Fig. 1 timelines)", first=True)
    from repro_torch.bench import lockbench
    f1 = lockbench.fig1()
    summary.append(("fig1.spin.makespan_slots",
                    f1["ttas"]["makespan_slots"]))
    summary.append(("fig1.sleep.makespan_slots",
                    f1["sleep"]["makespan_slots"]))
    summary.append(("fig1.mutable.makespan_slots",
                    f1["mutable"]["makespan_slots"]))

    _banner("[2/12] lockbench fig3 (paper Fig. 3 grid, batched xdes engine)")
    f3 = lockbench.fig3(target_cs=400 if args.full else 200,
                        device=args.device)
    for regime, data in f3.items():
        for lock in ("mutable", "pt-exp"):
            summary.append((f"fig3.{regime}.{lock}.ratio",
                            round(data["summary"][lock]["ratio_to_opt"], 3)))
    with open(os.path.join(REPORTS, "lockbench.json"), "w") as f:
        json.dump({"fig1": f1, "fig3": f3}, f, indent=1)

    _banner("[3/12] batched xdes sweep (fig3 grid + 1000-config scenarios)")
    from repro_torch.bench import sweep
    sw = sweep.main(["--target-cs", "250" if args.full else "150"] + dev)
    for claim, ok in sw["fig3"]["claims"].items():
        summary.append((f"sweep.fig3.{claim}", ok))
    for lock, r in sw["scenario"]["mean_ratio_to_best"].items():
        summary.append((f"sweep.scenario.{lock}.mean_ratio", round(r, 3)))

    _banner("[4/12] PHOLD on share-everything PDES (paper Fig. 4)")
    from repro_torch.bench import phold
    ph = phold.run_phold(n_events=3000 if args.full else 1500)
    with open(os.path.join(REPORTS, "phold.json"), "w") as f:
        json.dump(ph, f, indent=1)
    for g, rows in ph.items():
        for tc, locks in rows.items():
            summary.append((f"phold.{g}.t{tc}.mutable.speedup",
                            locks["mutable"]["speedup"]))

    _banner("[5/12] serving-window scheduler (the technique on batches)")
    from repro_torch.bench import sched_bench
    sb = sched_bench.main(["--requests", "400" if args.full else "250"])
    for pol, agg in sb.items():
        summary.append((f"sched.{pol}.late_handoff_rate",
                        round(agg["late_handoff_rate"], 3)))
        summary.append((f"sched.{pol}.avg_standby",
                        round(agg["avg_standby"], 2)))

    _banner("[6/12] oracle-family grid (paper §5 future work, batched xdes)")
    from repro_torch.bench import oracle_ablation
    oa = oracle_ablation.main(
        ["--scenarios", "200" if args.full else "100",
         "--target-cs", "150" if args.full else "100"] + dev)
    for fam, row in oa["families"].items():
        summary.append((f"oracle.{fam}.wins", row["wins"]))
        summary.append((f"oracle.{fam}.best_tuned_ratio",
                        round(row["best_tuned_mean_ratio"], 3)))

    _banner("[7/12] discipline x oracle diagram (batched xdes)")
    from repro_torch.bench import discipline_diagram
    dd = discipline_diagram.main(
        ([] if args.full else ["--scenarios", "100", "--target-cs", "100"])
        + dev)
    for disc, row in dd["disciplines"].items():
        summary.append((f"discipline.{disc}.wins", row["wins"]))
        summary.append((f"discipline.{disc}.best_variant_ratio",
                        round(row["best_variant_mean_ratio"], 3)))

    _banner("[8/12] workload x discipline diagram (batched xdes)")
    from repro_torch.bench import workload_diagram
    wd = workload_diagram.main(
        ([] if args.full else ["--scenarios", "50", "--target-cs", "100"])
        + dev)
    for w, rows in wd["workloads"].items():
        top = max(rows, key=lambda d: rows[d]["wins"])
        summary.append((f"workload.{w}.top", top))
        summary.append((f"workload.{w}.mutable.best_ratio",
                        round(rows["mutable"]["best_variant_mean_ratio"],
                              3)))

    _banner("[9/12] arrival x discipline diagram (open-loop xdes)")
    from repro_torch.bench import arrival_diagram
    ad = arrival_diagram.main(
        ([] if args.full else ["--scenarios", "25", "--target-cs", "100"])
        + dev)
    for cell in ad["phase"]:
        summary.append(
            (f"arrival.{cell['arrival']}.rho{cell['rho']}.winner",
             cell["winner"]))
        summary.append(
            (f"arrival.{cell['arrival']}.rho{cell['rho']}.slo_frac",
             round(cell["mean_slo_frac"], 3)))

    _banner("[10/12] fault x discipline diagram (batched xdes)")
    from repro_torch.bench import fault_diagram
    fd = fault_diagram.main(
        ([] if args.full else ["--scenarios", "50", "--target-cs", "100"])
        + dev)
    for fl, rows in fd["faults"].items():
        top = max(rows, key=lambda d: rows[d]["wins"])
        summary.append((f"fault.{fl}.top", top))
        ret = rows["sleep"]["mean_retained_vs_none"]
        summary.append((f"fault.{fl}.sleep.retained",
                        None if ret is None else round(ret, 3)))

    _banner("[11/12] park-cost x discipline diagram (batched xdes)")
    from repro_torch.bench import park_diagram
    pkd = park_diagram.main(
        ([] if args.full else ["--scenarios", "25", "--target-cs", "100"])
        + dev)
    for p, rows in pkd["park_costs"].items():
        top = max(rows, key=lambda d: rows[d]["wins"])
        summary.append((f"park.{p}.top", top))
        ret = rows["sleep"]["mean_retained_vs_unit"]
        summary.append((f"park.{p}.sleep.retained",
                        None if ret is None else round(ret, 3)))

    _banner("[12/12] xdes perf microbenchmark "
            "(reports/torch/bench_xdes.json)")
    from repro_torch.bench import perf_bench
    pb = perf_bench.main((["--full-size"] if args.full else []) + dev)
    with open(os.path.join(REPORTS, "perf_bench.md"), "w") as f:
        f.write(perf_bench.summarize(pb) + "\n")
    for name, x in pb["speedups"].items():
        summary.append((f"perf.{name}", x))

    _banner(f"benchmark suite done in {time.time()-t0:.0f}s — summary CSV")
    _print_csv(summary)
    return summary


def _print_csv(summary) -> None:
    print("name,value")
    for k, v in summary:
        print(f"{k},{v}")


if __name__ == "__main__":
    main()

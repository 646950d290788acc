"""Serving-window benchmark on the port: the paper's oracle governing
decode-batch admission — the port's copy of ``benchmarks/sched_bench.py``.

Workload: bursty arrivals into a slot-based decode engine.  The standby
pool (prefilled-ahead requests) is the spinning window:

    window = 0      -> pure "sleep lock": every handoff pays prefill openly
    window = max    -> pure "spin lock": max standby KV held at all times
    EvalSWS         -> the paper's self-tuned window

Metrics mirror the paper's two axes:
    late_handoff_rate  — responsiveness (paper: CS-access latency)
    avg_standby        — resource waste (paper: spin CPU), in KV-slots held

Claim validated: the mutable window reaches a late-handoff rate close to
the window=max policy while holding a standby pool closer to window=0 —
i.e. it buys spin-level latency at a fraction of the resource cost, under
a workload it was not tuned for.  (Asserted in
tests/test_torch_paper_claims.py.)

The step-level runs (:func:`run_policy`) drive the port's
:class:`~repro_torch.serve.SimulatedEngine` on the host; ``--xdes`` runs
the same ablation through the batched engine on the card
(:func:`repro_torch.serve.xdes_policy_sweep`, the ``lock_sim_block``
kernel; ``--backend ref`` its plain version, ``--device cpu`` the host).

    PYTHONPATH=src python -m repro_torch.bench.sched_bench [--xdes \
        --scenarios N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.serve import ContinuousBatcher, Request, SimulatedEngine


def bursty_workload(n_requests: int = 400, seed: int = 0):
    """Arrival pattern with phase shifts: calm -> burst -> calm."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n_requests):
        phase = (i // 50) % 3
        rate = (20.0, 200.0, 60.0)[phase]           # arrivals per sec
        t += rng.exponential(1.0 / rate)
        reqs.append((t, Request(
            rid=i, prompt=[1] * int(rng.integers(4, 64)),
            max_new_tokens=int(rng.integers(8, 48)), arrived_at=t)))
    return reqs


def run_policy(policy: str, max_slots: int = 16, max_standby: int = 16,
               n_requests: int = 400, seed: int = 0) -> dict:
    eng = SimulatedEngine(max_slots=max_slots, prefill_cost=8e-3,
                          step_base=2e-3, step_per_slot=2e-4)
    bat = ContinuousBatcher.from_policy(eng, policy, max_standby=max_standby)
    reqs = bursty_workload(n_requests, seed)
    i = 0
    while i < len(reqs) or not bat.idle():
        while i < len(reqs) and reqs[i][0] <= eng.now:
            bat.submit(reqs[i][1])
            i += 1
        if bat.idle():                       # engine idle: jump to arrival
            eng.now = max(eng.now, reqs[i][0])
            continue
        bat.run_step()
    s = bat.stats.summary()
    s["policy"] = policy
    s["makespan_s"] = round(eng.now, 3)
    return s


def xdes_sweep(n_scenarios: int = 100, target_cs: int = 150,
               backend: str = "kernel", workload: str = "constant",
               device=None) -> dict:
    """The same zero/max/mutable ablation driven THROUGH xdes: slot/standby
    dynamics encoded on the SimConfig row schema
    (:class:`repro_torch.serve.SchedScenario`) and swept on the card as one
    batched call — scheduler policies ride the same engine as the lock
    disciplines.  ``workload`` selects a hold-time row (e.g. ``bursty``
    for wave-like admission, ``hetero`` for mixed decode lengths) on the
    SAME machines as the constant sweep."""
    from repro_torch.serve import sample_sched_scenarios, xdes_policy_sweep

    return xdes_policy_sweep(
        sample_sched_scenarios(n_scenarios, workload=workload),
        target_cs=target_cs, backend=backend, verbose=True, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--xdes", action="store_true",
                    help="run the ablation through the batched xdes engine "
                         "(one device call) instead of the step-level "
                         "engine simulator")
    ap.add_argument("--scenarios", type=int, default=100,
                    help="scenario count for --xdes")
    ap.add_argument("--workload", default="constant",
                    choices=("constant", "bursty", "hetero", "jitter"),
                    help="hold-time row for --xdes scenarios "
                         "(bursty = wave-like admission)")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="--xdes: kernel = the CUDA kernel; ref = its plain "
                         "PyTorch version")
    ap.add_argument("--device", default=None,
                    help="--xdes: default the CUDA card; 'cpu' runs the "
                         "plain versions on the host")
    ap.add_argument("--out", default="reports/torch/sched_bench.json")
    args = ap.parse_args(argv)
    if args.xdes:
        out = xdes_sweep(n_scenarios=args.scenarios,
                         workload=args.workload, backend=args.backend,
                         device=args.device)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
        return out["policies"]
    out = {}
    print(f"{'policy':>8} {'late-handoff':>13} {'avg standby':>12} "
          f"{'avg queue':>10} {'makespan':>9}")
    for policy in ("zero", "max", "mutable"):
        rows = [run_policy(policy, n_requests=args.requests, seed=s)
                for s in (0, 1, 2)]
        agg = {k: float(np.mean([r[k] for r in rows]))
               for k in ("late_handoff_rate", "avg_standby", "avg_queue",
                         "makespan_s", "completed")}
        out[policy] = agg
        print(f"{policy:>8} {agg['late_handoff_rate']:13.3f} "
              f"{agg['avg_standby']:12.2f} {agg['avg_queue']:10.2f} "
              f"{agg['makespan_s']:9.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()

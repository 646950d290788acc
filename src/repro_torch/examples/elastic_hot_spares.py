"""Hot-spare pool sized by the paper's oracle — fault tolerance at 1000+
nodes (``runtime/elastic.py``).

The port of ``examples/elastic_hot_spares.py``.  Simulates a year of
cluster operation with a time-varying failure rate (quiet weeks, then a
bad batch of machines) and compares three policies:

    cold-only    — no hot spares (pure sleep lock): every failure pays the
                   full provision+restore latency
    always-max   — max hot spares (pure spin lock): instant recovery,
                   maximum reserved capacity
    mutable      — the paper's window: doubles after an exposed failure,
                   decays after K masked ones

    PYTHONPATH=src python -m repro_torch.examples.elastic_hot_spares

The simulation is host-only (numpy and the runtime's window): ``--device``
is taken as by the other examples and changes nothing.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.oracle import EvalSWS, FixedOracle
from repro_torch.runtime import ElasticMesh, HotSparePool

HOT_S, COLD_S = 30.0, 600.0
DAY = 86_400.0
POLICIES = ("cold-only", "always-max", "mutable")


def simulate(policy: str, seed: int = 0, days: int = 365) -> dict:
    rng = np.random.default_rng(seed)
    if policy == "cold-only":
        pool = HotSparePool(16, initial=0, oracle=FixedOracle(),
                            hot_spinup_s=HOT_S, cold_spinup_s=COLD_S)
    elif policy == "always-max":
        pool = HotSparePool(16, initial=16, oracle=FixedOracle(),
                            hot_spinup_s=HOT_S, cold_spinup_s=COLD_S)
    else:
        pool = HotSparePool(16, initial=1, oracle=EvalSWS(k=10),
                            hot_spinup_s=HOT_S, cold_spinup_s=COLD_S)
    t = 0.0
    warm_at: list[float] = []
    while t < days * DAY:
        # failure rate: 0.5/day baseline, 6/day during "bad batches"
        bad = (int(t / DAY) % 60) < 5
        rate = (6.0 if bad else 0.5) / DAY
        dt = rng.exponential(1.0 / rate)
        t += dt
        pool.tick(dt)
        # spares that finished warming before this failure
        ready = [w for w in warm_at if w <= t]
        if ready:
            pool.on_spare_ready(len(ready))
            warm_at = [w for w in warm_at if w > t]
        before = pool.cold_queue
        pool.on_failure()
        for _ in range(pool.cold_queue - before):
            warm_at.append(t + COLD_S)
    s = pool.stats
    return {
        "policy": policy,
        "failures": s.failures,
        "exposed": s.exposed,
        "mean_recovery_s": s.recovery_s_total / max(1, s.failures),
        "hot_host_days": s.hot_host_seconds / DAY,
        "window_tail": s.window_trace[-5:] if s.window_trace else [],
    }


def main(argv=None) -> dict:
    """Print the re-mesh plan and the three policies' rows; assert the
    paper's trade-off.  Returns ``{policy: row}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="taken as by the other examples; host-only")
    ap.parse_args(argv)
    em = ElasticMesh(chips_per_host=4, model_axis=16, global_batch=256)
    plan = em.plan(61)
    print(f"[re-mesh] 61 healthy hosts -> mesh {plan.shape} "
          f"(accum x{em.accum_for(plan)} keeps the global batch)\n")
    print(f"{'policy':>12} {'failures':>9} {'exposed':>8} "
          f"{'mean recovery':>14} {'hot host-days':>14}")
    rows = {}
    for policy in POLICIES:
        r = simulate(policy)
        rows[policy] = r
        print(f"{policy:>12} {r['failures']:9d} {r['exposed']:8d} "
              f"{r['mean_recovery_s']:13.0f}s {r['hot_host_days']:14.1f}")
    mut, cold, mx = rows["mutable"], rows["cold-only"], rows["always-max"]
    assert mut["mean_recovery_s"] < 0.5 * cold["mean_recovery_s"]
    assert mut["hot_host_days"] < 0.7 * mx["hot_host_days"]
    print("\nmutable window: near always-max recovery at a fraction of the "
          "reserved capacity — the paper's trade-off, at cluster scale.")
    return rows


if __name__ == "__main__":
    main()

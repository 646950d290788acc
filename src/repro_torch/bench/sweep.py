"""Batched lock-simulation sweeps on the port's simulator: the sweep layer
of ``benchmarks/sweep.py``, on one NVIDIA GPU.

* ``fig3_batched`` — the paper's Fig. 3 grid (4 regimes x 5 locks x 8
  thread counts x seeds) as ONE :func:`repro_torch.core.xdes.
  simulate_batch` call, summarized as avg throughput, ratio-to-optimum and
  PT-EXP, and checked against the paper's qualitative claims C2-C4.
* ``scenario`` — a beyond-paper sweep (default 200 scenarios x 5 locks,
  one call per step-count bucket, :func:`repro_torch.core.xdes.
  plan_buckets`): "which discipline wins where", and how far a blind
  static choice and the mutable lock fall from the per-scenario optimum.
* ``oracle_grid`` — the SWS-oracle ablation (4 families x K x sws_max x
  scenarios), rendered by :mod:`repro_torch.bench.oracle_ablation`.
* ``discipline_grid`` — every discipline row x every oracle family x
  scenarios, rendered by :mod:`repro_torch.bench.discipline_diagram`.
* ``workload_grid`` — workload row x discipline variant x scenarios,
  rendered by :mod:`repro_torch.bench.workload_diagram`.
* ``arrival_grid`` — the open-loop arrival row x offered load x
  discipline variant x scenarios, with per-request tail latency from the
  on-device histograms, rendered by :mod:`repro_torch.bench.
  arrival_diagram`.
* ``fault_grid`` — fault row x discipline variant x scenarios, rendered
  by :mod:`repro_torch.bench.fault_diagram`.
* ``park_grid`` — park cost x discipline variant x scenarios, rendered by
  :mod:`repro_torch.bench.park_diagram`.
* ``refine_grid`` — a coarse->dense phase-boundary refinement lattice at
  a fixed config budget.

Arguments, result-dict keys and summaries are those of the JAX
reference's grids, so one diagram writer reads the results of either
package.  ``backend="kernel"`` (default) runs the hand-written CUDA
kernels (``lock_sim_block``, closed and open), ``backend="ref"`` their
plain PyTorch versions.  ``device=None`` is the card and raises without
CUDA; ``device="cpu"`` runs the plain versions on the host.  Every
batched call splits its config axis over the shard devices
(``simulate_batch(shard=...)``: every visible card, or
``REPRO_TORCH_SHARDS`` forced shards) when there is more than one, or
when ``shard=True`` asks; ``shard=False`` turns the split off.  The
grids' meta records ``n_devices`` (the shard count) and ``sharded``.

Every one-shot batched call is gated by ``BatchResult.validate()``: a
non-finite engine output raises with the offending config named.  Every
grid also has a **streaming** mode (``stream=True``, automatic at >=
:data:`STREAM_AUTO` configs): the grid is generated as raw column arrays
(``repro_torch.configs.catalog.lock_*_columns``) and run chunk by chunk
under a memory budget by :func:`repro_torch.core.stream.sweep_stream`,
with the phase-diagram win counts accumulated on the device
(``CellReduce``) and non-finite configs quarantined to
:data:`FAILURES_PATH`.

    PYTHONPATH=src python -m repro_torch.bench.sweep [--quick] \
        [--backend ref] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs.catalog import (LOCK_ARRIVAL_RHOS, LOCK_ARRIVALS,
                                         LOCK_CORES, LOCK_DISCIPLINE_SET,
                                         LOCK_DISCIPLINES, LOCK_FAULTS,
                                         LOCK_ORACLE_KS, LOCK_ORACLE_SWS_MAX,
                                         LOCK_ORACLES, LOCK_PARK_COSTS,
                                         LOCK_REGIMES, LOCK_SHORT,
                                         LOCK_THREADS, LOCK_WAKE,
                                         LOCK_WORKLOADS, _product_columns,
                                         lock_arrival_columns,
                                         lock_arrival_sweep,
                                         lock_discipline_columns,
                                         lock_discipline_sweep,
                                         lock_discipline_variants,
                                         lock_fault_columns, lock_fault_sweep,
                                         lock_fig3_grid, lock_oracle_columns,
                                         lock_oracle_sweep,
                                         lock_oracle_variants,
                                         lock_park_columns, lock_park_sweep,
                                         lock_scenario_columns,
                                         lock_scenario_sweep,
                                         lock_workload_columns,
                                         lock_workload_sweep,
                                         sample_scenario_columns)
from repro_torch.core import stream as xstream
from repro_torch.core import xdes
from repro_torch.core.policy import POLICY_IDS, POLICY_ROW
from repro_torch.device import resolve_device, shard_count, splits

#: Config count at which the grids switch to the streaming path by
#: default (stream=None): below it the one-shot batched call is simpler
#: and the working set is small; above it chunking + on-device reduction
#: keep memory flat (see repro_torch.core.stream).
STREAM_AUTO = 50_000

#: Structured quarantine report for streamed grids: configs whose engine
#: summaries came back non-finite are recorded here (and excluded from
#: the win-count reduction) instead of poisoning a phase diagram.  Only
#: written when a sweep quarantined something.  Under ``reports/torch/``,
#: so a run of the port never overwrites one of the reference.
FAILURES_PATH = os.path.join("reports", "torch", "sweep_failures.json")

def _placement(device, shard: bool | None = None):
    """The device a grid runs on, resolved before any host work
    (``device=None`` is the card and raises without CUDA), and the meta
    keys of its split as the reference records them: ``n_devices``, the
    shard count, and ``sharded``, ``bool(shard)`` if given, else whether
    there is more than one shard."""
    device = resolve_device(device)
    return device, {"n_devices": shard_count(device),
                    "sharded": splits(shard, device)}


def _variant_name(v: dict) -> str:
    """Display name of a (discipline, oracle) variant: *windowed* rows —
    the rows that actually read the oracle column (mutable, fissile) —
    carry a ``lock/oracle`` suffix; every other discipline appears bare
    (its oracle axis is pruned by ``lock_discipline_variants``)."""
    return (f"{v['lock']}/{v['oracle']}"
            if POLICY_ROW[POLICY_IDS[v["lock"]]].windowed else v["lock"])


# --------------------------------------------------------------------------
# Fig. 3 grid, batched
# --------------------------------------------------------------------------
def fig3_batched(target_cs: int = 250, seeds=(0, 1),
                 backend: str = "kernel", device=None,
                 verbose: bool = True) -> dict:
    device = resolve_device(device)
    configs = lock_fig3_grid(seeds=seeds)
    t0 = time.time()
    res = xdes.simulate_batch(configs, target_cs=target_cs, backend=backend,
                              device=device).validate("fig3")
    wall = time.time() - t0

    thr = res.throughput.reshape(len(LOCK_REGIMES), len(LOCK_DISCIPLINES),
                                 len(LOCK_THREADS), len(seeds)).mean(-1)
    cpu = res.sync_cpu_per_cs.reshape(thr.shape[0], thr.shape[1],
                                      thr.shape[2], len(seeds)).mean(-1)

    out: dict = {"meta": {"backend": backend, "device": str(device),
                          "n_configs": len(configs),
                          "n_steps": res.n_steps, "wall_s": round(wall, 2)}}
    for ri, regime in enumerate(LOCK_REGIMES):
        rows = {
            lock: [{"threads": int(tc), "throughput": float(thr[ri, li, ti]),
                    "sync_cpu_per_cs": float(cpu[ri, li, ti])}
                   for ti, tc in enumerate(LOCK_THREADS)]
            for li, lock in enumerate(LOCK_DISCIPLINES)
        }
        opt = thr[ri].max(axis=0)                  # optimum per thread count
        avg_opt = float(opt.mean())
        summary = {}
        for li, lock in enumerate(LOCK_DISCIPLINES):
            avg = float(thr[ri, li].mean())
            summary[lock] = {"avg_throughput": avg,
                             "ratio_to_opt": avg / avg_opt}
        pt_exp = 0.5 * (summary["ttas"]["avg_throughput"]
                        + summary["sleep"]["avg_throughput"])
        summary["pt-exp"] = {"avg_throughput": pt_exp,
                             "ratio_to_opt": pt_exp / avg_opt}
        out[regime] = {"rows": rows, "summary": summary}
        if verbose:
            print(f"\n=== {regime} (xdes, {backend}) ===")
            print(f"{'lock':>10} {'avg thr (cs/s)':>16} {'ratio':>7}")
            for lock in list(LOCK_DISCIPLINES) + ["pt-exp"]:
                s = summary[lock]
                print(f"{lock:>10} {s['avg_throughput']:16.0f} "
                      f"{s['ratio_to_opt']:7.3f}")

    out["claims"] = _check_claims(out)
    if verbose:
        print(f"\nfig3 batched: {len(configs)} configs x {res.n_steps} "
              f"steps in {wall:.1f}s -> claims {out['claims']}")
    return out


def _check_claims(f3: dict) -> dict:
    """The paper's qualitative orderings (C2-C4) on the batched results."""
    ss = f3["cs_short_ncs_short"]["summary"]
    ls = f3["cs_long_ncs_short"]["summary"]
    lo = f3["cs_short_ncs_long"]["summary"]
    # C2: short CS — mutable within ~12% of optimum and above PT-EXP.
    c2 = (ss["mutable"]["ratio_to_opt"] > ss["pt-exp"]["ratio_to_opt"]
          and ss["mutable"]["ratio_to_opt"] > 0.85)
    # C3: long CS — mutable within ~15% of optimum while spin CPU is cut
    # by >= 5x vs TTAS at 20 threads (checked on per-thread rows).
    rows = f3["cs_long_ncs_short"]["rows"]
    i20 = list(LOCK_THREADS).index(20)
    ttas_cpu = rows["ttas"][i20]["sync_cpu_per_cs"]
    mut_cpu = max(rows["mutable"][i20]["sync_cpu_per_cs"], 1e-12)
    c3 = (ls["mutable"]["ratio_to_opt"] > 0.8 and ttas_cpu / mut_cpu >= 5.0)
    # C4: low contention — every lock within ~12% of every other.
    ratios = [lo[l]["ratio_to_opt"] for l in LOCK_DISCIPLINES]
    c4 = min(ratios) > 0.85
    return {"C2": bool(c2), "C3": bool(c3), "C4": bool(c4),
            "ttas_over_mutable_cpu_at_20t": round(ttas_cpu / mut_cpu, 1)}


# --------------------------------------------------------------------------
# Beyond-paper scenario sweep
# --------------------------------------------------------------------------
def scenario(n_scenarios: int = 200, target_cs: int = 150,
             backend: str = "kernel", seed: int = 0, bucket: bool = True,
             stream: bool | None = None, mem_mb: float | None = None,
             early_exit: bool | None = None, device=None,
             verbose: bool = True) -> dict:
    """``bucket=True`` groups the heterogeneous scenarios into power-of-two
    step-count buckets (:func:`repro_torch.core.xdes.plan_buckets`) — one
    batched call per bucket instead of pinning every cell to the slowest
    scenario's horizon.  All five locks of a scenario share its planned
    step count, so per-scenario comparisons stay consistent.

    ``stream=True`` (auto at >= :data:`STREAM_AUTO` configs) feeds the
    grid as column arrays through :func:`repro_torch.core.stream.
    sweep_stream` under the ``mem_mb`` memory budget, with the per-lock
    win counts accumulated on device."""
    device = resolve_device(device)
    locks = list(LOCK_DISCIPLINES)
    C = n_scenarios * len(locks)
    if stream is None:
        stream = C >= STREAM_AUTO
    t0 = time.time()
    if stream:
        cols = lock_scenario_columns(n_scenarios=n_scenarios, seed=seed,
                                     locks=locks)
        red = xstream.CellReduce(
            group=len(locks), cell_ids=np.zeros(n_scenarios, np.int32),
            n_cells=1)
        res = xstream.sweep_stream(cols, target_cs=target_cs,
                                   backend=backend, bucket_steps=bucket,
                                   reduce=red, mem_mb=mem_mb,
                                   early_exit=early_exit,
                                   failures_path=FAILURES_PATH,
                                   device=device)
        win_counts = res.wins[0]
    else:
        configs = lock_scenario_sweep(n_scenarios=n_scenarios, seed=seed,
                                      locks=locks)
        res = xdes.simulate_batch(configs, target_cs=target_cs,
                                  backend=backend, bucket_steps=bucket,
                                  early_exit=early_exit,
                                  device=device).validate("scenario")
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, len(locks))
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, len(locks))
    best = thr.max(axis=1)
    ratio = thr / np.maximum(best[:, None], 1e-30)
    if not stream:
        win = thr.argmax(axis=1)
        win_counts = np.asarray([(win == i).sum()
                                 for i in range(len(locks))])

    out = {
        "meta": {"backend": backend, "device": str(device), "n_configs": C,
                 "n_steps": res.n_steps, "wall_s": round(wall, 2),
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1)},
        "wins": {lock: int(win_counts[i])
                 for i, lock in enumerate(locks)},
        "mean_ratio_to_best": {lock: float(ratio[:, i].mean())
                               for i, lock in enumerate(locks)},
        "p10_ratio_to_best": {lock: float(np.percentile(ratio[:, i], 10))
                              for i, lock in enumerate(locks)},
        "mean_sync_cpu_per_cs_us": {lock: float(cpu[:, i].mean() * 1e6)
                                    for i, lock in enumerate(locks)},
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        how = (f"streamed in {res.n_chunks} chunk(s) of "
               f"<= {res.chunk_size}" if stream else "one-shot")
        print(f"\nscenario sweep: {C} configs x {res.n_steps} "
              f"steps ({how}) in {wall:.1f}s "
              f"({out['meta']['configs_per_s']} cfg/s)")
        print(f"{'lock':>10} {'wins':>6} {'mean ratio':>11} "
              f"{'p10 ratio':>10} {'cpu/cs (µs)':>12}")
        for i, lock in enumerate(locks):
            print(f"{lock:>10} {out['wins'][lock]:6d} "
                  f"{out['mean_ratio_to_best'][lock]:11.3f} "
                  f"{out['p10_ratio_to_best'][lock]:10.3f} "
                  f"{out['mean_sync_cpu_per_cs_us'][lock]:12.2f}")
    return out


# --------------------------------------------------------------------------
# Oracle-family ablation grid
# --------------------------------------------------------------------------
def _scenario_feats(sc_cols: dict) -> list[dict]:
    """Coarse workload features per scenario — the phase-diagram axes —
    from :func:`repro_torch.configs.catalog.sample_scenario_columns` arrays
    (shared by the one-shot and streaming paths, which therefore bucket
    identically)."""
    return [{
        "cs": "short" if cs <= 1e-5 else "mid" if cs <= 1e-4 else "long",
        "sub": "under" if th <= co else "over",
        "wake": "fast" if wk <= 1e-5 else "slow",
    } for th, co, cs, wk in zip(sc_cols["threads"], sc_cols["cores"],
                                sc_cols["cs_hi"], sc_cols["wake"])]


def _phase_cells(keys: list[tuple]) -> tuple[list[tuple], np.ndarray]:
    """Order the distinct phase-cell keys and map each reduction group to
    its cell id — the ``CellReduce.cell_ids`` layout shared by the
    on-device (streamed) and host (one-shot) win accounting."""
    uniq = sorted(set(keys))
    kid = {k: i for i, k in enumerate(uniq)}
    return uniq, np.asarray([kid[k] for k in keys], np.int32)


def _host_wins(throughput, n_cells: int, cell_ids, group: int) -> np.ndarray:
    """Host twin of the streamed on-device accumulation: win counts per
    (phase cell, variant) from the per-config throughput columns."""
    win = np.asarray(throughput).reshape(-1, group).argmax(axis=1)
    wins = np.zeros((n_cells, group), np.int64)
    np.add.at(wins, (np.asarray(cell_ids), win), 1)
    return wins


def oracle_grid(n_scenarios: int = 200, target_cs: int = 150,
                backend: str = "kernel", seed: int = 0,
                oracles=LOCK_ORACLES, ks=LOCK_ORACLE_KS,
                sws_maxes=LOCK_ORACLE_SWS_MAX, stream: bool | None = None,
                mem_mb: float | None = None,
                early_exit: bool | None = None,
                device=None, verbose: bool = True) -> dict:
    """The full ``(oracle, K, sws_max) x scenario`` product as ONE
    :func:`repro_torch.core.xdes.simulate_batch` call (no per-cell Python
    loop) — or, with ``stream=True`` (auto at >=
    :data:`STREAM_AUTO` configs), chunk-by-chunk under a memory budget
    via :func:`repro_torch.core.stream.sweep_stream` with the phase-cell win
    counts accumulated on device — summarized three ways:

    * per variant — wins, mean/p10 throughput ratio to the per-scenario
      best variant, spin CPU per CS;
    * per family — wins of its best-tuned variant and the ratio a
      per-scenario best tuning of that family achieves;
    * phase diagram — which family wins in each (CS-length x
      subscription x wake-latency) workload bucket, the "which oracle
      wins where" artifact rendered by
      :mod:`repro_torch.bench.oracle_ablation`.
    """
    device = resolve_device(device)
    variants = lock_oracle_variants(oracles, ks, sws_maxes)
    V = len(variants)
    C = n_scenarios * V
    if stream is None:
        stream = C >= STREAM_AUTO
    feats = _scenario_feats(sample_scenario_columns(n_scenarios, seed))
    uniq, cell_ids = _phase_cells(
        [(f["cs"], f["sub"], f["wake"]) for f in feats])
    t0 = time.time()
    if stream:
        cols = lock_oracle_columns(n_scenarios=n_scenarios, seed=seed,
                                   oracles=oracles, ks=ks,
                                   sws_maxes=sws_maxes)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, mem_mb=mem_mb,
            early_exit=early_exit, failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_oracle_sweep(n_scenarios=n_scenarios, seed=seed,
                                    oracles=oracles, ks=ks,
                                    sws_maxes=sws_maxes)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend,
            early_exit=early_exit, device=device).validate("oracle_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, V)
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, V)
    sws = res.final_sws.reshape(n_scenarios, V)
    best = np.maximum(thr.max(axis=1), 1e-30)
    ratio = thr / best[:, None]
    win_v = wins_cells.sum(axis=0)

    def vname(v):
        m = "cores" if v["sws_max"] is None else v["sws_max"]
        return f"{v['oracle']}-k{v['k']}-m{m}"

    out_variants = [{
        "name": vname(v), "oracle": v["oracle"], "k": v["k"],
        "sws_max": v["sws_max"], "wins": int(win_v[i]),
        "mean_ratio_to_best": float(ratio[:, i].mean()),
        "p10_ratio_to_best": float(np.percentile(ratio[:, i], 10)),
        "mean_sync_cpu_per_cs_us": float(cpu[:, i].mean() * 1e6),
        "mean_final_sws": float(sws[:, i].mean()),
    } for i, v in enumerate(variants)]

    fam_names = list(dict.fromkeys(v["oracle"] for v in variants))
    fam_cols = {f: [i for i, v in enumerate(variants) if v["oracle"] == f]
                for f in fam_names}
    families = {f: {
        "wins": int(win_v[cols].sum()),
        # ratio achieved by the best tuning of this family per scenario
        "best_tuned_mean_ratio": float(ratio[:, cols].max(axis=1).mean()),
        "mean_sync_cpu_per_cs_us": float(cpu[:, cols].mean() * 1e6),
    } for f, cols in fam_cols.items()}

    phase = []
    for ci, (cs_b, sub_b, wake_b) in enumerate(uniq):
        counts = {f: int(wins_cells[ci, cols].sum())
                  for f, cols in fam_cols.items()}
        n = sum(counts.values())
        winner = max(counts, key=counts.get)
        phase.append({"cs": cs_b, "sub": sub_b, "wake": wake_b, "n": n,
                      "winner": winner,
                      "win_share": round(counts[winner] / n, 3),
                      "wins_by_family": counts})

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_variants": V, "n_configs": C,
                 "n_steps": res.n_steps, "wall_s": round(wall, 2),
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1)},
        "variants": out_variants,
        "families": families,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\noracle grid: {C} configs ({n_scenarios} "
              f"scenarios x {V} variants) x {res.n_steps} steps "
              f"in {wall:.1f}s ({out['meta']['configs_per_s']} cfg/s)")
        print(f"{'family':>9} {'wins':>5} {'best-tuned ratio':>17} "
              f"{'cpu/cs (µs)':>12}")
        for f, row in families.items():
            print(f"{f:>9} {row['wins']:5d} "
                  f"{row['best_tuned_mean_ratio']:17.3f} "
                  f"{row['mean_sync_cpu_per_cs_us']:12.2f}")
    return out


# --------------------------------------------------------------------------
# Discipline x oracle diagram grid
# --------------------------------------------------------------------------
def discipline_grid(n_scenarios: int = 200, target_cs: int = 150,
                    backend: str = "kernel", seed: int = 0,
                    disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
                    shard: bool | None = None, stream: bool | None = None,
                    mem_mb: float | None = None,
                    early_exit: bool | None = None,
                    device=None, verbose: bool = True) -> dict:
    """The full ``(discipline, oracle) x scenario`` product — every row of
    ``DISCIPLINE_ROWS`` crossed with every ``ORACLE_ROWS`` family — as ONE
    :func:`repro_torch.core.xdes.simulate_batch` call — or, with
    ``stream=True`` (auto at >= :data:`STREAM_AUTO` configs), chunk by
    chunk under a memory budget via
    :func:`repro_torch.core.stream.sweep_stream` with phase-cell win counts
    accumulated on device — summarized three ways:

    * per variant — wins, mean/p10 throughput ratio to the per-scenario
      best variant, spin CPU per CS, fairness spread;
    * per discipline — wins of its best variant and the ratio its
      best-oracle tuning achieves per scenario;
    * phase diagram — which (discipline, oracle) wins in each (CS-length
      x subscription x wake-latency) workload bucket: the "which lock
      wins where" artifact rendered by
      :mod:`repro_torch.bench.discipline_diagram`.
    """
    device, split = _placement(device, shard)
    variants = lock_discipline_variants(disciplines, oracles)
    V = len(variants)
    C = n_scenarios * V
    if stream is None:
        stream = C >= STREAM_AUTO
    feats = _scenario_feats(sample_scenario_columns(n_scenarios, seed))
    uniq, cell_ids = _phase_cells(
        [(f["cs"], f["sub"], f["wake"]) for f in feats])
    t0 = time.time()
    if stream:
        cols = lock_discipline_columns(n_scenarios=n_scenarios, seed=seed,
                                       disciplines=disciplines,
                                       oracles=oracles)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, shard=shard,
            mem_mb=mem_mb, early_exit=early_exit,
            failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_discipline_sweep(n_scenarios=n_scenarios, seed=seed,
                                        disciplines=disciplines,
                                        oracles=oracles)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend, shard=shard,
            early_exit=early_exit, device=device).validate("discipline_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, V)
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, V)
    best = np.maximum(thr.max(axis=1), 1e-30)
    ratio = thr / best[:, None]
    win_v = wins_cells.sum(axis=0)

    vname = _variant_name

    out_variants = [{
        "name": vname(v), "lock": v["lock"], "oracle": v["oracle"],
        "wins": int(win_v[i]),
        "mean_ratio_to_best": float(ratio[:, i].mean()),
        "p10_ratio_to_best": float(np.percentile(ratio[:, i], 10)),
        "mean_sync_cpu_per_cs_us": float(cpu[:, i].mean() * 1e6),
    } for i, v in enumerate(variants)]

    disc_names = list(dict.fromkeys(v["lock"] for v in variants))
    disc_cols = {d: [i for i, v in enumerate(variants) if v["lock"] == d]
                 for d in disc_names}
    by_discipline = {d: {
        "wins": int(win_v[cols].sum()),
        "best_variant_mean_ratio": float(ratio[:, cols].max(axis=1).mean()),
        "mean_sync_cpu_per_cs_us": float(cpu[:, cols].mean() * 1e6),
    } for d, cols in disc_cols.items()}

    variant_names = [vname(v) for v in variants]
    phase = []
    for ci, (cs_b, sub_b, wake_b) in enumerate(uniq):
        counts = {variant_names[i]: int(wins_cells[ci, i])
                  for i in range(V) if wins_cells[ci, i]}
        n = sum(counts.values())
        winner = max(counts, key=counts.get)
        phase.append({"cs": cs_b, "sub": sub_b, "wake": wake_b, "n": n,
                      "winner": winner,
                      "win_share": round(counts[winner] / n, 3),
                      "wins_by_variant": counts})

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_variants": V, "n_configs": C,
                 "n_steps": res.n_steps, "wall_s": round(wall, 2),
                 **split,
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1)},
        "variants": out_variants,
        "disciplines": by_discipline,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\ndiscipline grid: {C} configs ({n_scenarios} "
              f"scenarios x {V} variants) x {res.n_steps} steps in "
              f"{wall:.1f}s on {out['meta']['n_devices']} device(s) "
              f"({out['meta']['configs_per_s']} cfg/s)")
        print(f"{'discipline':>10} {'wins':>5} {'best-variant ratio':>19} "
              f"{'cpu/cs (µs)':>12}")
        for d, row in by_discipline.items():
            print(f"{d:>10} {row['wins']:5d} "
                  f"{row['best_variant_mean_ratio']:19.3f} "
                  f"{row['mean_sync_cpu_per_cs_us']:12.2f}")
    return out


# --------------------------------------------------------------------------
# Workload x discipline x oracle diagram grid
# --------------------------------------------------------------------------
def workload_grid(n_scenarios: int = 100, target_cs: int = 150,
                  backend: str = "kernel", seed: int = 0,
                  workloads=LOCK_WORKLOADS,
                  disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
                  shard: bool | None = None, stream: bool | None = None,
                  mem_mb: float | None = None,
                  early_exit: bool | None = None,
                  device=None, verbose: bool = True) -> dict:
    """The full ``workload x (discipline, oracle) x scenario`` product —
    every row of ``WORKLOAD_ROWS`` crossed with every discipline-diagram
    variant — as ONE :func:`repro_torch.core.xdes.simulate_batch` call,
    summarized three ways:

    * per (workload, variant) — wins, mean/p10 throughput ratio to the
      per-(scenario, workload) best variant, spin CPU per CS;
    * per workload — which discipline wins how often under that hold-time
      model, and each discipline's best-variant mean ratio;
    * phase diagram — which (discipline, oracle) wins in each
      (workload x CS-length x subscription) bucket: the "which lock wins
      under which workload" artifact rendered by
      :mod:`repro_torch.bench.workload_diagram`.

    The per-scenario best is taken *within* a workload, so a variant is
    judged against the other locks under the same workload — never
    against an easier workload's throughput.  With ``stream=True`` (auto
    at >= :data:`STREAM_AUTO` configs) the sweep runs chunk-by-chunk via
    :func:`repro_torch.core.stream.sweep_stream`; each ``(scenario, workload)``
    slice of ``V`` variants is one reduction group, so the on-device
    argmax is the same within-workload contest.
    """
    device, split = _placement(device, shard)
    disc_variants = lock_discipline_variants(disciplines, oracles)
    W, V = len(workloads), len(disc_variants)
    C = n_scenarios * W * V
    if stream is None:
        stream = C >= STREAM_AUTO
    feats = _scenario_feats(sample_scenario_columns(n_scenarios, seed))
    # One phase key per (scenario, workload) group of V variants.
    uniq, cell_ids = _phase_cells(
        [(w, f["cs"], f["sub"]) for f in feats for w in workloads])
    t0 = time.time()
    if stream:
        cols = lock_workload_columns(n_scenarios=n_scenarios, seed=seed,
                                     workloads=workloads,
                                     disciplines=disciplines,
                                     oracles=oracles)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, shard=shard,
            mem_mb=mem_mb, early_exit=early_exit,
            failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_workload_sweep(n_scenarios=n_scenarios, seed=seed,
                                      workloads=workloads,
                                      disciplines=disciplines,
                                      oracles=oracles)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend, shard=shard,
            early_exit=early_exit, device=device).validate("workload_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, W, V)
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, W, V)
    best = np.maximum(thr.max(axis=2), 1e-30)          # (S, W)
    ratio = thr / best[..., None]
    # per-(workload, variant) win counts from the phase-cell matrix:
    # every (scenario, workload) group maps to exactly one cell whose key
    # starts with that workload, so summing cells by workload recovers
    # the within-workload contest.
    cell_w = np.asarray([list(workloads).index(k[0]) for k in uniq])
    win_wv = np.zeros((W, V), np.int64)
    np.add.at(win_wv, cell_w, wins_cells)

    vname = _variant_name

    variant_names = [vname(v) for v in disc_variants]
    out_variants = [{
        "workload": w, "name": variant_names[i],
        "lock": disc_variants[i]["lock"],
        "oracle": disc_variants[i]["oracle"],
        "wins": int(win_wv[wi, i]),
        "mean_ratio_to_best": float(ratio[:, wi, i].mean()),
        "p10_ratio_to_best": float(np.percentile(ratio[:, wi, i], 10)),
        "mean_sync_cpu_per_cs_us": float(cpu[:, wi, i].mean() * 1e6),
    } for wi, w in enumerate(workloads) for i in range(V)]

    disc_names = list(dict.fromkeys(v["lock"] for v in disc_variants))
    disc_cols = {d: [i for i, v in enumerate(disc_variants)
                     if v["lock"] == d] for d in disc_names}
    by_workload = {}
    for wi, w in enumerate(workloads):
        by_workload[w] = {d: {
            "wins": int(win_wv[wi, cols].sum()),
            "best_variant_mean_ratio":
                float(ratio[:, wi, cols].max(axis=1).mean()),
            "mean_sync_cpu_per_cs_us":
                float(cpu[:, wi, cols].mean() * 1e6),
        } for d, cols in disc_cols.items()}

    phase = []
    order = sorted(range(len(uniq)),
                   key=lambda ci: (list(workloads).index(uniq[ci][0]),
                                   uniq[ci][1:]))
    for ci in order:
        w, cs_b, sub_b = uniq[ci]
        counts = {variant_names[i]: int(wins_cells[ci, i])
                  for i in range(V) if wins_cells[ci, i]}
        n = sum(counts.values())
        winner = max(counts, key=counts.get)
        phase.append({"workload": w, "cs": cs_b, "sub": sub_b, "n": n,
                      "winner": winner,
                      "win_share": round(counts[winner] / n, 3),
                      "wins_by_variant": counts})

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_workloads": W, "n_variants": V,
                 "n_configs": C, "n_steps": res.n_steps,
                 "wall_s": round(wall, 2),
                 **split,
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1),
                 "workloads": list(workloads),
                 "variant_names": variant_names},
        "variants": out_variants,
        "workloads": by_workload,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\nworkload grid: {C} configs ({n_scenarios} "
              f"scenarios x {W} workloads x {V} variants) x {res.n_steps} "
              f"steps in {wall:.1f}s on {out['meta']['n_devices']} "
              f"device(s) ({out['meta']['configs_per_s']} cfg/s)")
        for w in workloads:
            rows = by_workload[w]
            top = max(rows, key=lambda d: rows[d]["wins"])
            print(f"{w:>9}: top discipline {top} "
                  f"({rows[top]['wins']}/{n_scenarios} wins); "
                  + " ".join(f"{d}:{r['wins']}" for d, r in rows.items()))
    return out


# --------------------------------------------------------------------------
# Arrival-rate x discipline diagram grid (open loop)
# --------------------------------------------------------------------------
def arrival_grid(n_scenarios: int = 50, target_cs: int = 150,
                 backend: str = "kernel", seed: int = 0,
                 arrivals=LOCK_ARRIVALS, rhos=LOCK_ARRIVAL_RHOS,
                 disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
                 shard: bool | None = None, stream: bool | None = None,
                 mem_mb: float | None = None,
                 early_exit: bool | None = None,
                 device=None, verbose: bool = True) -> dict:
    """The full ``arrival x load x (discipline, oracle) x scenario``
    product — every open-loop ``ARRIVAL_ROW`` at every offered-load
    fraction ``rho`` of the scenario's service capacity — as ONE
    :func:`repro_torch.core.xdes.simulate_batch` call with the open-loop
    engine on, reporting per-request tail latency (p50/p95/p99 from the
    on-device histograms), SLO-violation fraction, and shed fraction per
    config.  Summarized three ways:

    * per (arrival, rho, variant) — throughput wins, mean p95/p99, mean
      SLO-violation and shed fractions;
    * per discipline — wins and best-variant tail latency per cell;
    * phase diagram — which (discipline, oracle) wins each
      ``(arrival row x offered load)`` cell, by throughput (the
      on-device :class:`repro_torch.core.stream.CellReduce` winner) AND by p95
      tail latency (host reduction of the per-config histograms): the
      "which lock serves traffic best" artifact rendered by
      :mod:`repro_torch.bench.arrival_diagram`.

    Row order is scenario-major, then arrival, then rho, then variant —
    reshape to ``(n_scenarios, n_arrivals, n_rhos, n_variants)``.
    Scenarios follow the :func:`sample_scenarios` seed contract, so every
    cell sees the same machines scenario-by-scenario."""
    device, split = _placement(device, shard)
    disc_variants = lock_discipline_variants(disciplines, oracles)
    A, R, V = len(arrivals), len(rhos), len(disc_variants)
    C = n_scenarios * A * R * V
    if stream is None:
        stream = C >= STREAM_AUTO
    # One phase cell per (arrival row, rho): the diagram's axes.  Every
    # (scenario, arrival, rho) slice of V variants is one reduction group.
    uniq, cell_ids = _phase_cells(
        [(a, r) for _ in range(n_scenarios) for a in arrivals
         for r in rhos])
    t0 = time.time()
    if stream:
        cols = lock_arrival_columns(n_scenarios=n_scenarios, seed=seed,
                                    arrivals=arrivals, rhos=rhos,
                                    disciplines=disciplines,
                                    oracles=oracles)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, shard=shard,
            mem_mb=mem_mb, early_exit=early_exit,
            failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_arrival_sweep(n_scenarios=n_scenarios, seed=seed,
                                     arrivals=arrivals, rhos=rhos,
                                     disciplines=disciplines,
                                     oracles=oracles)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend, shard=shard,
            early_exit=early_exit, device=device).validate("arrival_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    shape = (n_scenarios, A, R, V)
    p50 = res.p50.reshape(shape)
    p95 = res.p95.reshape(shape)
    p99 = res.p99.reshape(shape)
    slo_frac = res.slo_frac.reshape(shape)
    arrived = res.arrived.reshape(shape)
    shed_frac = (res.shed.reshape(shape)
                 / np.maximum(arrived, 1).astype(np.float64))
    # host-side tail-latency winner per (scenario, arrival, rho) group:
    # lowest p95 among variants that departed anything (NaN = no service,
    # never wins while any variant served traffic).
    p95_rank = np.where(np.isnan(p95), np.inf, p95)
    lat_win = p95_rank.reshape(-1, V).argmin(axis=1)
    lat_wins_cells = np.zeros((len(uniq), V), np.int64)
    np.add.at(lat_wins_cells, (np.asarray(cell_ids), lat_win), 1)

    vname = _variant_name

    variant_names = [vname(v) for v in disc_variants]
    cell_of = {k: i for i, k in enumerate(uniq)}
    win_thr = np.asarray(wins_cells)

    out_variants = [{
        "arrival": a, "rho": r, "name": variant_names[i],
        "lock": disc_variants[i]["lock"],
        "oracle": disc_variants[i]["oracle"],
        "wins": int(win_thr[cell_of[(a, r)], i]),
        "lat_wins": int(lat_wins_cells[cell_of[(a, r)], i]),
        "mean_p50_us": float(np.nanmean(p50[:, ai, ri, i]) * 1e6),
        "mean_p95_us": float(np.nanmean(p95[:, ai, ri, i]) * 1e6),
        "mean_p99_us": float(np.nanmean(p99[:, ai, ri, i]) * 1e6),
        "mean_slo_frac": float(np.nanmean(slo_frac[:, ai, ri, i])),
        "mean_shed_frac": float(shed_frac[:, ai, ri, i].mean()),
    } for ai, a in enumerate(arrivals) for ri, r in enumerate(rhos)
        for i in range(V)]

    phase = []
    for ai, a in enumerate(arrivals):
        for ri, r in enumerate(rhos):
            ci = cell_of[(a, r)]
            counts = {variant_names[i]: int(win_thr[ci, i])
                      for i in range(V) if win_thr[ci, i]}
            lcounts = {variant_names[i]: int(lat_wins_cells[ci, i])
                       for i in range(V) if lat_wins_cells[ci, i]}
            n = sum(counts.values())
            winner = max(counts, key=counts.get)
            lat_winner = max(lcounts, key=lcounts.get)
            phase.append({
                "arrival": a, "rho": r, "n": n,
                "winner": winner,
                "win_share": round(counts[winner] / n, 3),
                "lat_winner": lat_winner,
                "lat_win_share": round(lcounts[lat_winner]
                                       / max(sum(lcounts.values()), 1), 3),
                "mean_slo_frac": float(np.nanmean(slo_frac[:, ai, ri, :])),
                "mean_shed_frac": float(shed_frac[:, ai, ri, :].mean()),
                "wins_by_variant": counts,
                "lat_wins_by_variant": lcounts,
            })

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_arrivals": A, "n_rhos": R, "n_variants": V,
                 "n_configs": C, "n_steps": res.n_steps,
                 "wall_s": round(wall, 2),
                 **split,
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1),
                 "arrivals": list(arrivals), "rhos": list(rhos),
                 "variant_names": variant_names},
        "variants": out_variants,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\narrival grid: {C} configs ({n_scenarios} scenarios x "
              f"{A} arrivals x {R} loads x {V} variants) x {res.n_steps} "
              f"steps in {wall:.1f}s on {out['meta']['n_devices']} "
              f"device(s) ({out['meta']['configs_per_s']} cfg/s)")
        for cell in phase:
            print(f"{cell['arrival']:>8} rho={cell['rho']:<4} "
                  f"thr-winner {cell['winner']:<16} "
                  f"p95-winner {cell['lat_winner']:<16} "
                  f"slo-viol {cell['mean_slo_frac']:.3f} "
                  f"shed {cell['mean_shed_frac']:.3f}")
    return out


# --------------------------------------------------------------------------
# Fault x discipline x oracle diagram grid
# --------------------------------------------------------------------------
def fault_grid(n_scenarios: int = 100, target_cs: int = 150,
               backend: str = "kernel", seed: int = 0,
               faults=LOCK_FAULTS,
               disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
               shard: bool | None = None, stream: bool | None = None,
               mem_mb: float | None = None,
               early_exit: bool | None = None,
               device=None, verbose: bool = True) -> dict:
    """The full ``fault x (discipline, oracle) x scenario`` product —
    every row of ``FAULT_ROWS`` (benign baseline, lock-holder preemption,
    CPU oversubscription, lost wake-ups, timer jitter) crossed with every
    discipline-diagram variant — as ONE
    :func:`repro_torch.core.xdes.simulate_batch` call, summarized three
    ways:

    * per (fault, variant) — wins, mean/p10 throughput ratio to the
      per-(scenario, fault) best variant, spin CPU per CS, and the mean
      throughput retained vs the same variant on the ``none`` row (the
      degradation axis the benign diagrams cannot show);
    * per fault — which discipline wins how often under that failure
      mode, each discipline's best-variant ratio and retention;
    * phase diagram — which (discipline, oracle) wins in each
      (fault x CS-length x subscription) bucket: the "which lock
      survives which failure mode" artifact rendered by
      :mod:`repro_torch.bench.fault_diagram`.

    The per-scenario best is taken *within* a fault row, so a variant is
    judged against the other locks under the same interference — never
    against the benign machine's throughput.  Scenarios follow the
    :func:`sample_scenarios` seed contract, so the ``none`` row IS the
    discipline diagram's machine scenario-by-scenario.  With
    ``stream=True`` (auto at >= :data:`STREAM_AUTO` configs) the sweep
    runs chunk-by-chunk via :func:`repro_torch.core.stream.sweep_stream`; each
    ``(scenario, fault)`` slice of ``V`` variants is one reduction
    group, so the on-device argmax is the same within-fault contest.
    """
    device, split = _placement(device, shard)
    disc_variants = lock_discipline_variants(disciplines, oracles)
    F, V = len(faults), len(disc_variants)
    C = n_scenarios * F * V
    if stream is None:
        stream = C >= STREAM_AUTO
    feats = _scenario_feats(sample_scenario_columns(n_scenarios, seed))
    # One phase key per (scenario, fault) group of V variants.
    uniq, cell_ids = _phase_cells(
        [(fl, ft["cs"], ft["sub"]) for ft in feats for fl in faults])
    t0 = time.time()
    if stream:
        cols = lock_fault_columns(n_scenarios=n_scenarios, seed=seed,
                                  faults=faults, disciplines=disciplines,
                                  oracles=oracles)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, shard=shard,
            mem_mb=mem_mb, early_exit=early_exit,
            failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_fault_sweep(n_scenarios=n_scenarios, seed=seed,
                                   faults=faults, disciplines=disciplines,
                                   oracles=oracles)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend, shard=shard,
            early_exit=early_exit, device=device).validate("fault_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, F, V)
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, F, V)
    best = np.maximum(thr.max(axis=2), 1e-30)          # (S, F)
    ratio = thr / best[..., None]
    # Throughput retained vs the benign row, same scenario and variant —
    # the robustness ordinate (1.0 = unaffected).  Only defined when the
    # grid includes the "none" row.
    retained = None
    if "none" in faults:
        base = np.maximum(thr[:, list(faults).index("none"), :], 1e-30)
        retained = thr / base[:, None, :]
    # per-(fault, variant) win counts from the phase-cell matrix: every
    # (scenario, fault) group maps to exactly one cell whose key starts
    # with that fault, so summing cells by fault recovers the
    # within-fault contest.
    cell_f = np.asarray([list(faults).index(k[0]) for k in uniq])
    win_fv = np.zeros((F, V), np.int64)
    np.add.at(win_fv, cell_f, wins_cells)

    vname = _variant_name

    variant_names = [vname(v) for v in disc_variants]
    out_variants = [{
        "fault": fl, "name": variant_names[i],
        "lock": disc_variants[i]["lock"],
        "oracle": disc_variants[i]["oracle"],
        "wins": int(win_fv[fi, i]),
        "mean_ratio_to_best": float(ratio[:, fi, i].mean()),
        "p10_ratio_to_best": float(np.percentile(ratio[:, fi, i], 10)),
        "mean_retained_vs_none": (float(retained[:, fi, i].mean())
                                  if retained is not None else None),
        "mean_sync_cpu_per_cs_us": float(cpu[:, fi, i].mean() * 1e6),
    } for fi, fl in enumerate(faults) for i in range(V)]

    disc_names = list(dict.fromkeys(v["lock"] for v in disc_variants))
    disc_cols = {d: [i for i, v in enumerate(disc_variants)
                     if v["lock"] == d] for d in disc_names}
    by_fault = {}
    for fi, fl in enumerate(faults):
        by_fault[fl] = {d: {
            "wins": int(win_fv[fi, cols].sum()),
            "best_variant_mean_ratio":
                float(ratio[:, fi, cols].max(axis=1).mean()),
            "mean_retained_vs_none":
                (float(retained[:, fi, cols].mean())
                 if retained is not None else None),
            "mean_sync_cpu_per_cs_us":
                float(cpu[:, fi, cols].mean() * 1e6),
        } for d, cols in disc_cols.items()}

    phase = []
    order = sorted(range(len(uniq)),
                   key=lambda ci: (list(faults).index(uniq[ci][0]),
                                   uniq[ci][1:]))
    for ci in order:
        fl, cs_b, sub_b = uniq[ci]
        counts = {variant_names[i]: int(wins_cells[ci, i])
                  for i in range(V) if wins_cells[ci, i]}
        n = sum(counts.values())
        winner = max(counts, key=counts.get)
        phase.append({"fault": fl, "cs": cs_b, "sub": sub_b, "n": n,
                      "winner": winner,
                      "win_share": round(counts[winner] / n, 3),
                      "wins_by_variant": counts})

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_faults": F, "n_variants": V,
                 "n_configs": C, "n_steps": res.n_steps,
                 "wall_s": round(wall, 2),
                 **split,
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1),
                 "faults": list(faults),
                 "variant_names": variant_names},
        "variants": out_variants,
        "faults": by_fault,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\nfault grid: {C} configs ({n_scenarios} "
              f"scenarios x {F} faults x {V} variants) x {res.n_steps} "
              f"steps in {wall:.1f}s on {out['meta']['n_devices']} "
              f"device(s) ({out['meta']['configs_per_s']} cfg/s)")
        for fl in faults:
            rows = by_fault[fl]
            top = max(rows, key=lambda d: rows[d]["wins"])
            print(f"{fl:>9}: top discipline {top} "
                  f"({rows[top]['wins']}/{n_scenarios} wins); "
                  + " ".join(f"{d}:{r['wins']}" for d, r in rows.items()))
    return out


# --------------------------------------------------------------------------
# Park-cost x discipline x oracle diagram grid (M:N environments)
# --------------------------------------------------------------------------
def park_grid(n_scenarios: int = 50, target_cs: int = 150,
              backend: str = "kernel", seed: int = 0,
              park_costs=LOCK_PARK_COSTS,
              disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
              shard: bool | None = None, stream: bool | None = None,
              mem_mb: float | None = None,
              early_exit: bool | None = None,
              device=None, verbose: bool = True) -> dict:
    """The full ``park_cost x (discipline, oracle) x scenario`` product —
    the M:N lightweight-thread environment axis (``SimConfig.park_cost``
    scaling the park/unpark round trip across three orders of magnitude)
    crossed with every discipline-diagram variant — as ONE
    :func:`repro_torch.core.xdes.simulate_batch` call, summarized three
    ways:

    * per (park_cost, variant) — wins, mean/p10 throughput ratio to the
      per-(scenario, park_cost) best variant, spin CPU per CS, and the
      throughput retained vs the same variant at ``park_cost=1`` (how
      hard the environment re-prices each sleep-leaning row);
    * per park_cost — which discipline wins how often in that
      environment;
    * phase diagram — which (discipline, oracle) wins in each
      (park_cost x CS-length x subscription) bucket: the "when is
      parking worth it" artifact rendered by
      :mod:`repro_torch.bench.park_diagram`.

    The per-scenario best is taken *within* a park-cost slice, so a
    variant is judged against the other locks in the same environment.
    Scenarios follow the :func:`sample_scenarios` seed contract, so the
    ``park_cost=1`` slice IS the discipline diagram's machine
    scenario-by-scenario."""
    device, split = _placement(device, shard)
    disc_variants = lock_discipline_variants(disciplines, oracles)
    K, V = len(park_costs), len(disc_variants)
    C = n_scenarios * K * V
    if stream is None:
        stream = C >= STREAM_AUTO
    feats = _scenario_feats(sample_scenario_columns(n_scenarios, seed))
    # One phase key per (scenario, park_cost) group of V variants.
    uniq, cell_ids = _phase_cells(
        [(p, ft["cs"], ft["sub"]) for ft in feats for p in park_costs])
    t0 = time.time()
    if stream:
        cols = lock_park_columns(n_scenarios=n_scenarios, seed=seed,
                                 park_costs=park_costs,
                                 disciplines=disciplines, oracles=oracles)
        res = xstream.sweep_stream(
            cols, target_cs=target_cs, backend=backend, shard=shard,
            mem_mb=mem_mb, early_exit=early_exit,
            failures_path=FAILURES_PATH,
            reduce=xstream.CellReduce(V, cell_ids, len(uniq)),
            device=device)
        wins_cells = res.wins
    else:
        configs = lock_park_sweep(n_scenarios=n_scenarios, seed=seed,
                                  park_costs=park_costs,
                                  disciplines=disciplines, oracles=oracles)
        res = xdes.simulate_batch(
            configs, target_cs=target_cs, backend=backend, shard=shard,
            early_exit=early_exit, device=device).validate("park_grid")
        wins_cells = _host_wins(res.throughput, len(uniq), cell_ids, V)
    wall = time.time() - t0

    thr = res.throughput.reshape(n_scenarios, K, V)
    cpu = res.sync_cpu_per_cs.reshape(n_scenarios, K, V)
    best = np.maximum(thr.max(axis=2), 1e-30)          # (S, K)
    ratio = thr / best[..., None]
    # Throughput retained vs the park_cost=1 baseline, same scenario and
    # variant — the re-pricing ordinate (only when the grid includes 1.0).
    retained = None
    if 1.0 in park_costs:
        base = np.maximum(thr[:, list(park_costs).index(1.0), :], 1e-30)
        retained = thr / base[:, None, :]
    cell_k = np.asarray([list(park_costs).index(k[0]) for k in uniq])
    win_kv = np.zeros((K, V), np.int64)
    np.add.at(win_kv, cell_k, wins_cells)

    vname = _variant_name

    variant_names = [vname(v) for v in disc_variants]
    out_variants = [{
        "park_cost": p, "name": variant_names[i],
        "lock": disc_variants[i]["lock"],
        "oracle": disc_variants[i]["oracle"],
        "wins": int(win_kv[ki, i]),
        "mean_ratio_to_best": float(ratio[:, ki, i].mean()),
        "p10_ratio_to_best": float(np.percentile(ratio[:, ki, i], 10)),
        "mean_retained_vs_unit": (float(retained[:, ki, i].mean())
                                  if retained is not None else None),
        "mean_sync_cpu_per_cs_us": float(cpu[:, ki, i].mean() * 1e6),
    } for ki, p in enumerate(park_costs) for i in range(V)]

    disc_names = list(dict.fromkeys(v["lock"] for v in disc_variants))
    disc_cols = {d: [i for i, v in enumerate(disc_variants)
                     if v["lock"] == d] for d in disc_names}
    by_park = {}
    for ki, p in enumerate(park_costs):
        by_park[str(p)] = {d: {
            "wins": int(win_kv[ki, cols].sum()),
            "best_variant_mean_ratio":
                float(ratio[:, ki, cols].max(axis=1).mean()),
            "mean_retained_vs_unit":
                (float(retained[:, ki, cols].mean())
                 if retained is not None else None),
            "mean_sync_cpu_per_cs_us":
                float(cpu[:, ki, cols].mean() * 1e6),
        } for d, cols in disc_cols.items()}

    phase = []
    order = sorted(range(len(uniq)),
                   key=lambda ci: (list(park_costs).index(uniq[ci][0]),
                                   uniq[ci][1:]))
    for ci in order:
        p, cs_b, sub_b = uniq[ci]
        counts = {variant_names[i]: int(wins_cells[ci, i])
                  for i in range(V) if wins_cells[ci, i]}
        n = sum(counts.values())
        winner = max(counts, key=counts.get)
        phase.append({"park_cost": p, "cs": cs_b, "sub": sub_b, "n": n,
                      "winner": winner,
                      "win_share": round(counts[winner] / n, 3),
                      "wins_by_variant": counts})

    out = {
        "meta": {"backend": backend, "device": str(device),
                 "n_scenarios": n_scenarios,
                 "n_park_costs": K, "n_variants": V,
                 "n_configs": C, "n_steps": res.n_steps,
                 "wall_s": round(wall, 2),
                 **split,
                 "streamed": bool(stream),
                 "configs_per_s": round(C / max(wall, 1e-9), 1),
                 "park_costs": list(park_costs),
                 "variant_names": variant_names},
        "variants": out_variants,
        "park_costs": by_park,
        "phase": phase,
    }
    if stream:
        out["meta"].update(chunk_size=res.chunk_size,
                           n_chunks=res.n_chunks,
                           budget_mb=round(res.budget_mb, 1))
    if verbose:
        print(f"\npark grid: {C} configs ({n_scenarios} "
              f"scenarios x {K} park costs x {V} variants) x "
              f"{res.n_steps} steps in {wall:.1f}s on "
              f"{out['meta']['n_devices']} device(s) "
              f"({out['meta']['configs_per_s']} cfg/s)")
        for p in park_costs:
            rows = by_park[str(p)]
            top = max(rows, key=lambda d: rows[d]["wins"])
            print(f"{p:>9}: top discipline {top} "
                  f"({rows[top]['wins']}/{n_scenarios} wins); "
                  + " ".join(f"{d}:{r['wins']}" for d, r in rows.items()))
    return out


# --------------------------------------------------------------------------
# Coarse -> dense resolution refinement
# --------------------------------------------------------------------------
def refine_grid(nx: int = 16, ny: int = 12, factor: int = 3,
                target_cs: int = 150, backend: str = "kernel", seed: int = 0,
                disciplines=LOCK_DISCIPLINE_SET, oracles=LOCK_ORACLES,
                cs_range: tuple = (1e-6, 4e-4), thread_range: tuple = (2, 32),
                max_configs: int = 100_000, mem_mb: float | None = None,
                shard: bool | None = None, device=None,
                verbose: bool = True) -> dict:
    """Two-pass phase-boundary refinement over a regular (CS length x
    thread count) lattice at the paper's fixed machine (``LOCK_CORES``
    cores, short NCS, ``LOCK_WAKE`` wake latency).

    Pass 1 streams a coarse ``ny x nx`` lattice (every point crossed with
    every discipline variant) and takes the per-point winner from the
    on-device :class:`repro_torch.core.stream.CellReduce` win matrix.  Pass 2
    re-streams only the dense sub-lattice points (``factor`` x finer per
    axis) that fall in coarse cells touching a phase boundary — where the
    winner differs from a 4-neighbour — so the dense budget is spent on
    the boundary, not the interior.  Total configs are capped at
    ``max_configs`` (dense points beyond the cap are dropped, reported in
    ``meta``).
    """
    device = resolve_device(device)
    variants = lock_discipline_variants(disciplines, oracles)
    V = len(variants)

    vname = _variant_name

    variant_names = [vname(v) for v in variants]

    def lattice_cols(cs_vals, th_vals):
        """(P,) scenario columns for the row-major cs x threads lattice."""
        cs, th = np.meshgrid(cs_vals, th_vals)          # (len(th), len(cs))
        cs, th = cs.ravel(), th.ravel()
        P = cs.size
        sc = {"threads": th.astype(np.int64),
              "cores": np.full(P, LOCK_CORES, np.int64),
              "cs_hi": cs.astype(np.float64),
              "ncs_hi": np.full(P, LOCK_SHORT[1], np.float64),
              "wake": np.full(P, LOCK_WAKE, np.float64),
              "contention": np.ones(P, np.float64),
              "seed": np.full(P, seed, np.int64)}
        return _product_columns(sc, variants), P

    def winners(cs_vals, th_vals):
        cols, P = lattice_cols(cs_vals, th_vals)
        red = xstream.CellReduce(V, np.arange(P, dtype=np.int32), P)
        res = xstream.sweep_stream(cols, target_cs=target_cs,
                                   backend=backend, shard=shard,
                                   mem_mb=mem_mb, reduce=red,
                                   failures_path=FAILURES_PATH,
                                   device=device)
        return np.asarray(res.wins).argmax(axis=1), res

    t0 = time.time()
    cs_coarse = np.geomspace(cs_range[0], cs_range[1], nx)
    th_coarse = np.unique(np.rint(np.linspace(
        thread_range[0], thread_range[1], ny)).astype(np.int64))
    ny = len(th_coarse)
    win_c, res_c = winners(cs_coarse, th_coarse)
    grid = win_c.reshape(ny, nx)

    boundary = np.zeros((ny, nx), bool)
    boundary[:, 1:] |= grid[:, 1:] != grid[:, :-1]
    boundary[:, :-1] |= grid[:, 1:] != grid[:, :-1]
    boundary[1:, :] |= grid[1:, :] != grid[:-1, :]
    boundary[:-1, :] |= grid[1:, :] != grid[:-1, :]

    cs_dense = np.geomspace(cs_range[0], cs_range[1], factor * nx)
    th_dense = np.unique(np.rint(np.linspace(
        thread_range[0], thread_range[1], factor * ny)).astype(np.int64))
    # Map every dense point to its enclosing coarse cell (nearest coarse
    # index per axis); keep only points inside boundary cells.
    ix = np.clip(np.searchsorted(np.sqrt(cs_coarse[1:] * cs_coarse[:-1]),
                                 cs_dense), 0, nx - 1)
    iy = np.clip(np.searchsorted((th_coarse[1:] + th_coarse[:-1]) / 2.0,
                                 th_dense), 0, ny - 1)
    keep_y, keep_x = np.nonzero(boundary[np.ix_(iy, ix)])
    pts_cs = cs_dense[keep_x]
    pts_th = th_dense[keep_y]
    budget_pts = max(0, max_configs // V - nx * ny)
    n_dropped = max(0, len(pts_cs) - budget_pts)
    pts_cs, pts_th = pts_cs[:budget_pts], pts_th[:budget_pts]

    dense = []
    res_d = None
    if len(pts_cs):
        P = len(pts_cs)
        sc = {"threads": pts_th.astype(np.int64),
              "cores": np.full(P, LOCK_CORES, np.int64),
              "cs_hi": pts_cs.astype(np.float64),
              "ncs_hi": np.full(P, LOCK_SHORT[1], np.float64),
              "wake": np.full(P, LOCK_WAKE, np.float64),
              "contention": np.ones(P, np.float64),
              "seed": np.full(P, seed, np.int64)}
        cols = _product_columns(sc, variants)
        red = xstream.CellReduce(V, np.arange(P, dtype=np.int32), P)
        res_d = xstream.sweep_stream(cols, target_cs=target_cs,
                                     backend=backend, shard=shard,
                                     mem_mb=mem_mb, reduce=red,
                                     failures_path=FAILURES_PATH,
                                     device=device)
        win_d = np.asarray(res_d.wins).argmax(axis=1)
        dense = [{"cs_us": round(float(c) * 1e6, 4), "threads": int(t),
                  "winner": variant_names[w]}
                 for c, t, w in zip(pts_cs, pts_th, win_d)]
    wall = time.time() - t0

    C = (nx * ny + len(pts_cs)) * V
    out = {
        "meta": {"backend": backend, "device": str(device),
                 "nx": nx, "ny": ny, "factor": factor,
                 "n_variants": V, "n_coarse": nx * ny,
                 "n_dense": len(pts_cs), "n_dense_dropped": n_dropped,
                 "n_configs": C, "wall_s": round(wall, 2),
                 "configs_per_s": round(C / max(wall, 1e-9), 1),
                 "chunk_size": res_c.chunk_size,
                 "budget_mb": round(res_c.budget_mb, 1),
                 "variant_names": variant_names},
        "axes": {"cs_us": [round(c * 1e6, 4) for c in cs_coarse],
                 "threads": [int(t) for t in th_coarse]},
        "coarse": [[variant_names[w] for w in row] for row in grid],
        "dense": dense,
    }
    if verbose:
        print(f"\nrefine grid: {nx}x{ny} coarse + {len(pts_cs)} dense "
              f"boundary points ({C} configs) in {wall:.1f}s; "
              f"{int(boundary.sum())} boundary cells"
              + (f"; {n_dropped} dense points dropped at cap"
                 if n_dropped else ""))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smoke-scale batches")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="kernel: the CUDA kernels; ref: their plain "
                         "PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    ap.add_argument("--scenarios", type=int, default=200)
    ap.add_argument("--target-cs", type=int, default=250)
    ap.add_argument("--no-bucket", action="store_true",
                    help="run the scenario sweep as one global-horizon "
                         "batch instead of per-step-count buckets")
    ap.add_argument("--stream", choices=("auto", "on", "off"),
                    default="auto",
                    help="run sweeps chunk-by-chunk under a memory budget "
                         "(auto: stream at >= %d configs)" % STREAM_AUTO)
    ap.add_argument("--mem-mb", type=float, default=None,
                    help="streaming memory budget in MiB (default: "
                         "REPRO_SWEEP_MEM_MB env, else device-derived)")
    ap.add_argument("--out", default="reports/torch/sweep.json")
    args = ap.parse_args(argv)

    stream = {"auto": None, "on": True, "off": False}[args.stream]
    kw = dict(backend=args.backend, device=args.device)
    if args.quick:
        f3 = fig3_batched(target_cs=60, seeds=(0,), **kw)
        sc = scenario(n_scenarios=40, target_cs=50,
                      bucket=not args.no_bucket, stream=stream,
                      mem_mb=args.mem_mb, **kw)
    else:
        f3 = fig3_batched(target_cs=args.target_cs, **kw)
        sc = scenario(n_scenarios=args.scenarios,
                      target_cs=args.target_cs,
                      bucket=not args.no_bucket, stream=stream,
                      mem_mb=args.mem_mb, **kw)

    results = {"fig3": f3, "scenario": sc}
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {args.out}")
    return results


if __name__ == "__main__":
    main()

"""lockbench — the paper's synthetic benchmark (Fig. 1 timelines + Fig. 3
grid) on the port.  The Fig. 3 grid runs on the port's batched engine by
default (one :func:`repro_torch.core.xdes.simulate_batch` call through
:func:`repro_torch.bench.sweep.fig3_batched`, on the card through the
``lock_sim_block`` kernel); ``--engine des`` runs the per-cell event-driven
loop on the port's DES (:mod:`repro_torch.core.des`), the exact reference.
Fig. 1 stays event-driven (a 3-thread deterministic timeline).  Real-thread
mode runs the port's threaded locks (:func:`repro_torch.core.make_lock`).

Fig. 3 regimes (paper §4): CS and NCS lengths uniform in [0, 3.7)µs (short)
or [0, 366)µs (long); 2x2 grid.  Metrics per (lock, thread count):

    throughput      — critical sections per second (higher better)
    sync CPU        — CPU-seconds burnt in spin per CS (lower better)
    ratio           — avg throughput / avg optimum  (paper right column)
    PT-EXP          — mean of PT-SPINLOCK (ttas) and PT-MUTEX (sleep):
                      the expected value of a blind static choice

Paper claims (asserted in tests/test_torch_paper_claims.py):
  C1 (Fig 1): sleep locks need ~5 slots for 3 CSes (-40% throughput);
      the mutable lock matches spin-lock latency with sleep-level waste.
  C2 (Fig 3a/c): with short CSes MUTLOCK is within ~10% of spin locks and
      beats PT-EXP on average.
  C3 (Fig 3d/e): with long CSes MUTLOCK cuts sync CPU by ~an order of
      magnitude vs spin locks at high thread counts, with bounded
      (<~10-15%) loss from the optimum.
  C4 (Fig 3g-i): at low contention all locks converge.

The grid's constants are the catalog's (``LOCK_DISCIPLINES``,
``LOCK_REGIMES``, ``LOCK_THREADS``), so the xdes and DES grids line up
cell for cell.

    PYTHONPATH=src python -m repro_torch.bench.lockbench [--fig1] [--fig3] \
        [--threads] [--engine xdes|des] [--backend kernel|ref] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs.catalog import (LOCK_CORES, LOCK_DISCIPLINES,
                                         LOCK_LONG, LOCK_REGIMES, LOCK_SHORT,
                                         LOCK_THREADS, LOCK_WAKE)
from repro_torch.core.des import simulate

SHORT = LOCK_SHORT
LONG = LOCK_LONG
WAKE = LOCK_WAKE             # OS wake-up latency (order of a futex wake)
CORES = LOCK_CORES           # the paper's test machine
LOCKS = list(LOCK_DISCIPLINES)
REGIMES = dict(LOCK_REGIMES)
THREADS = list(LOCK_THREADS)  # >20 = time-sharing regime


# --------------------------------------------------------------------------
# Fig. 1: three threads, CS duration == wake-up latency
# --------------------------------------------------------------------------
def fig1(verbose: bool = True) -> dict:
    """Deterministic timeline experiment (paper Fig. 1): 3 threads, each
    executes ONE critical section; CS duration == wake-up latency == 1 slot;
    NCS ~ 0.  Measures the makespan in slots for the 3 CSes.

    Expected: spin = 3 slots (b2b CSes, 3 slots of spin waste);
    sleep = 5 slots (two exposed wake-ups, 2 slots waste);
    mutable = 3 slots (wake-up masked by the spinner's CS), 2 slots waste.
    The mutable row uses the steady-state window (sws=2) the oracle reaches
    after its first late wake-up — the ``convergence`` entry shows the
    transient.
    """
    res = {}
    unit = 10e-6
    for lock, kw in (("ttas", {}), ("sleep", {}),
                     ("mutable", {"initial_sws": 2})):
        r = simulate(lock, threads=3, cores=3, cs=(unit, unit),
                     ncs=(1e-9, 1e-9), wake_latency=unit,
                     target_cs=3, seed=1, max_cs_per_thread=1,
                     lock_kwargs=kw)
        res[lock] = {
            "makespan_slots": round(r.t_end / unit, 2),
            "spin_waste_slots": round(r.spin_cpu / unit, 2),
            "wakes": r.wake_count,
        }
        if verbose:
            print(f"fig1 {lock:>8}: {res[lock]}")

    # oracle dynamics: from sws=1, the doubling rule must fire on the first
    # exposed wake-up (growth) and the K-rule must decay it back when late
    # wake-ups stop (the steady state here is carried by banked semaphore
    # permits pre-waking the next thread — wake-up latency stays masked).
    sim_r = simulate("mutable", threads=3, cores=3, cs=(unit, unit),
                     ncs=(1e-9, 1e-9), wake_latency=unit, target_cs=400,
                     seed=1, lock_kwargs={"initial_sws": 1})
    trace = [s for _, s in sim_r.sws_trace]
    res["convergence"] = {"max_sws": max(trace), "final_sws": trace[-1],
                          "grew": max(trace) > 1}
    if verbose:
        print(f"fig1 oracle dynamics: {res['convergence']}")
    return res


# --------------------------------------------------------------------------
# Fig. 3 grid
# --------------------------------------------------------------------------
def fig3(target_cs: int = 400, seeds=(0, 1), verbose: bool = True,
         engine: str = "xdes", backend: str = "kernel",
         device=None) -> dict:
    """The Fig. 3 grid.  ``engine="xdes"`` (default) runs the whole grid
    as ONE batched call through :func:`repro_torch.bench.sweep.
    fig3_batched` on ``device`` (``None``: the card, raising without
    CUDA; ``backend="ref"``: the plain versions); ``engine="des"`` is the
    per-cell event-driven loop on the host (exact event times, minutes of
    Python), the exactness reference."""
    if engine == "xdes":
        from repro_torch.bench.sweep import fig3_batched

        f3 = fig3_batched(target_cs=target_cs, seeds=seeds, backend=backend,
                          device=device, verbose=verbose)
        return {k: v for k, v in f3.items() if k in REGIMES}
    if engine != "des":
        raise ValueError(f"unknown engine {engine!r} (xdes|des)")
    out: dict = {}
    for regime, (cs, ncs) in REGIMES.items():
        rows = {}
        for lock in LOCKS:
            per_tc = []
            for tc in THREADS:
                thr = cpu = 0.0
                for seed in seeds:
                    r = simulate(lock, threads=tc, cores=CORES, cs=cs,
                                 ncs=ncs, wake_latency=WAKE,
                                 target_cs=target_cs, seed=seed)
                    thr += r.throughput / len(seeds)
                    cpu += r.sync_cpu_per_cs / len(seeds)
                per_tc.append({"threads": tc, "throughput": thr,
                               "sync_cpu_per_cs": cpu})
            rows[lock] = per_tc
        # optimum per thread count + averages (paper right column)
        n = len(THREADS)
        opt = [max(rows[l][i]["throughput"] for l in LOCKS)
               for i in range(n)]
        avg_opt = sum(opt) / n
        summary = {}
        for lock in LOCKS:
            avg = sum(r["throughput"] for r in rows[lock]) / n
            summary[lock] = {"avg_throughput": avg,
                             "ratio_to_opt": avg / avg_opt}
        pt_exp = 0.5 * (summary["ttas"]["avg_throughput"]
                        + summary["sleep"]["avg_throughput"])
        summary["pt-exp"] = {"avg_throughput": pt_exp,
                             "ratio_to_opt": pt_exp / avg_opt}
        out[regime] = {"rows": rows, "summary": summary}
        if verbose:
            print(f"\n=== {regime} ===")
            print(f"{'lock':>10} {'avg thr (cs/s)':>16} {'ratio':>7} "
                  f"{'cpu/cs @20t (µs)':>18}")
            for lock in LOCKS + ["pt-exp"]:
                s = out[regime]["summary"][lock]
                cpu20 = ("" if lock == "pt-exp" else
                         f"{rows[lock][5]['sync_cpu_per_cs']*1e6:18.2f}")
                print(f"{lock:>10} {s['avg_throughput']:16.0f} "
                      f"{s['ratio_to_opt']:7.3f} {cpu20}")
    return out


# --------------------------------------------------------------------------
# Real-thread mode (the host's threads; no card)
# --------------------------------------------------------------------------
def real_threads(n_threads: int = 4, iters: int = 300,
                 verbose: bool = True) -> dict:
    import threading

    from repro_torch.core import make_lock

    res = {}
    for kind in ("ttas", "sleep", "adaptive", "mutable"):
        lock = make_lock(kind, **({"max_sws": 4} if kind == "mutable" else {}))
        counter = [0]
        t0 = time.monotonic()

        def worker():
            for _ in range(iters):
                with lock:
                    counter[0] += 1
                    time.sleep(2e-5)       # CS: I/O-ish work, releases GIL
                time.sleep(1e-5)           # NCS

        ts = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t0
        assert counter[0] == n_threads * iters, "lost updates!"
        res[kind] = {"wall_s": round(wall, 3),
                     "cs_per_s": round(counter[0] / wall, 1)}
        if kind == "mutable":
            res[kind]["final_sws"] = lock.sws
            res[kind]["late_wakeups"] = (lock.stats.late_wakeups
                                         if lock.stats else None)
        if verbose:
            print(f"threads {kind:>9}: {res[kind]}")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="lockbench: Fig. 1 timelines + Fig. 3 grid.  fig3 runs "
                    "on the batched xdes engine by default (on the card); "
                    "--engine des selects the per-cell event-driven Python "
                    "loop on the host (exact event times, much slower — "
                    "the exactness reference).  fig1 always uses the DES: "
                    "it is a 3-thread deterministic timeline, not a sweep.")
    ap.add_argument("--fig1", action="store_true")
    ap.add_argument("--fig3", action="store_true")
    ap.add_argument("--threads", action="store_true")
    ap.add_argument("--engine", choices=("xdes", "des"), default="xdes",
                    help="fig3 engine: batched xdes (default) or the "
                         "per-cell DES loop")
    ap.add_argument("--target-cs", type=int, default=None,
                    help="CS samples per cell (default: 400 xdes / "
                         "2000 des)")
    ap.add_argument("--backend", choices=("kernel", "ref"), default="kernel",
                    help="xdes fig3: kernel = the CUDA kernel; ref = its "
                         "plain PyTorch version")
    ap.add_argument("--device", default=None,
                    help="xdes fig3: default the CUDA card; 'cpu' runs the "
                         "plain versions on the host")
    ap.add_argument("--out", default="reports/torch/lockbench.json")
    args = ap.parse_args(argv)
    run_all = not (args.fig1 or args.fig3 or args.threads)
    target_cs = args.target_cs or (400 if args.engine == "xdes" else 2000)
    if (args.fig3 or run_all) and args.engine == "xdes":
        from repro_torch.device import resolve_device

        resolve_device(args.device)     # no card: raise before any work

    results = {}
    if args.fig1 or run_all:
        results["fig1"] = fig1()
    if args.fig3 or run_all:
        results["fig3"] = fig3(target_cs=target_cs, engine=args.engine,
                               backend=args.backend, device=args.device)
    if args.threads or run_all:
        results["real_threads"] = real_threads()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {args.out}")
    return results


if __name__ == "__main__":
    main()

"""Lock-simulation sweep specs of the PyTorch port (paper Fig. 3 + the
beyond-paper scenario, oracle and discipline x oracle sweeps).

The port's own copy of the lock part of ``repro/configs/catalog.py``: each
spec is a list of :class:`repro_torch.core.policy.SimConfig` rows for one
:func:`repro_torch.core.xdes.simulate_batch` call.  Row order and the
:func:`sample_scenarios` draw order are part of the contract (seeds are
stable across sweeps and equal to the reference's).  The model catalog of
the reference file is not ported yet.
"""

from __future__ import annotations

from repro_torch.core.policy import (DEFAULT_ALPHA, POLICY_IDS, POLICY_ROW,
                                     SimConfig)

LOCK_SHORT = (0.0, 3.7e-6)        # paper §4: uniform [0, 3.7) µs
LOCK_LONG = (0.0, 366e-6)         # uniform [0, 366) µs
LOCK_WAKE = 8e-6                  # order of a futex wake
LOCK_CORES = 20                   # the paper's test machine
LOCK_THREADS = (2, 4, 8, 12, 16, 20, 26, 32)
LOCK_DISCIPLINES = ("ttas", "mcs", "sleep", "adaptive", "mutable")
LOCK_REGIMES = {
    "cs_short_ncs_short": (LOCK_SHORT, LOCK_SHORT),   # Fig 3(a-c)
    "cs_long_ncs_short": (LOCK_LONG, LOCK_SHORT),     # Fig 3(d-f)
    "cs_short_ncs_long": (LOCK_SHORT, LOCK_LONG),     # Fig 3(g-i)
    "cs_long_ncs_long": (LOCK_LONG, LOCK_LONG),       # Fig 3(j-l)
}


def lock_fig3_grid(seeds=(0, 1)) -> list[SimConfig]:
    """The full Fig. 3 grid as one flat batch: regimes x locks x thread
    counts x seeds (row order matches the nested loops, so consumers can
    reshape to (regime, lock, threads, seed))."""
    return [
        SimConfig(lock, threads=tc, cores=LOCK_CORES, cs=cs, ncs=ncs,
                  wake_latency=LOCK_WAKE, seed=seed)
        for cs, ncs in LOCK_REGIMES.values()
        for lock in LOCK_DISCIPLINES
        for tc in LOCK_THREADS
        for seed in seeds
    ]


def sample_scenarios(n_scenarios: int, seed: int = 0) -> list[dict]:
    """Draw ``n_scenarios`` random machines/workloads from the adaptive-
    spin design space named in PAPERS.md: CS/NCS lengths log-uniform across
    the paper's two regimes, wake latency from fast-futex to slow-
    scheduler, cache-contention strength from uncontended to 4x the paper's
    default, and over- as well as under-subscribed machines.  The draw
    order is part of the contract (seeds are stable across sweeps)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_scenarios):
        out.append(dict(
            threads=int(rng.integers(2, 33)),
            cores=int(rng.integers(2, 33)),
            cs_hi=float(np.exp(rng.uniform(np.log(1e-6), np.log(4e-4)))),
            ncs_hi=float(np.exp(rng.uniform(np.log(1e-6), np.log(4e-4)))),
            wake=float(np.exp(rng.uniform(np.log(2e-6), np.log(5e-5)))),
            contention=float(rng.uniform(0.0, 4.0)),
            seed=i,
        ))
    return out


def lock_scenario_sweep(n_scenarios: int = 200, seed: int = 0,
                        locks=LOCK_DISCIPLINES) -> list[SimConfig]:
    """Beyond-paper scenario sweep: ``n_scenarios`` random machines/
    workloads (:func:`sample_scenarios`), each simulated under every
    discipline (default 200 x 5 = 1000 configurations).  The sampled
    contention multiplies each lock's own ``DEFAULT_ALPHA`` (MCS stays
    coherence-free, TAS stays the worst) so disciplines keep their
    hardware character across scenarios."""
    return [
        SimConfig(lock, threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[lock],
                  seed=sc["seed"])
        for sc in sample_scenarios(n_scenarios, seed)
        for lock in locks
    ]


# -- oracle-family ablation grid -------------------------------------------
#: Default (oracle, K, sws_max) product axes of the oracle sweep.  ``K`` is
#: the family's knob (shrink period for paper/aimd/history, retrial budget
#: for fixed); ``sws_max`` None means the machine's core count (the paper
#: default).  4 x 3 x 2 = 24 combinations, 23 variants per scenario after
#: duplicate-trajectory pruning (see lock_oracle_variants).
LOCK_ORACLES = ("paper", "aimd", "fixed", "history")
LOCK_ORACLE_KS = (3, 10, 30)
LOCK_ORACLE_SWS_MAX = (None, 8)


def lock_oracle_variants(oracles=LOCK_ORACLES, ks=LOCK_ORACLE_KS,
                         sws_maxes=LOCK_ORACLE_SWS_MAX) -> list[dict]:
    """The flat ``(oracle, K, sws_max)`` product (variant-axis order of
    :func:`lock_oracle_sweep` rows).

    The ``fixed`` family pins the window at ``min(K, sws_max)``, so two
    fixed variants with the same explicit cap and ``K >= cap`` are the
    same trajectory — only the first is kept (ties would otherwise skew
    the win counts toward the lower-indexed duplicate)."""
    out, seen_fixed = [], set()
    for o in oracles:
        for k in ks:
            for m in sws_maxes:
                if o == "fixed" and m is not None:
                    pin = min(k, m)
                    if (pin, m) in seen_fixed:
                        continue
                    seen_fixed.add((pin, m))
                out.append(dict(oracle=o, k=k, sws_max=m))
    return out


def lock_oracle_sweep(n_scenarios: int = 200, seed: int = 0,
                      oracles=LOCK_ORACLES, ks=LOCK_ORACLE_KS,
                      sws_maxes=LOCK_ORACLE_SWS_MAX) -> list[SimConfig]:
    """Oracle-family ablation: every ``(oracle, K, sws_max)`` variant of
    the mutable lock on every random scenario — the ablation space of the
    glibc/Oracle-RDBMS retrial families (PAPERS.md) as one flat batch for
    a single :func:`repro_torch.core.xdes.simulate_batch` call.

    Row order is scenario-major, variant-minor (reshape to
    ``(n_scenarios, n_variants)``); scenarios are drawn by
    :func:`sample_scenarios` with the same seed contract as
    :func:`lock_scenario_sweep`, so oracle results are comparable
    scenario-by-scenario with the discipline sweep."""
    variants = lock_oracle_variants(oracles, ks, sws_maxes)
    return [
        SimConfig("mutable", threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA["mutable"],
                  seed=sc["seed"], oracle=v["oracle"], k=v["k"],
                  sws_max=v["sws_max"])
        for sc in sample_scenarios(n_scenarios, seed)
        for v in variants
    ]


# -- discipline x oracle diagram grid --------------------------------------
#: Discipline axis of the full "which lock wins where" diagram: every
#: DISCIPLINE_ROW is represented (spin via ttas+mcs, sleep, adaptive,
#: mutable, the FIFO/MCS ticket-handoff row, and the related-work rows:
#: Fissile spin-then-park, Hapax FIFO admission, TTAS with seeded
#: bounded-exponential backoff).
LOCK_DISCIPLINE_SET = ("ttas", "mcs", "fifo", "sleep", "adaptive", "mutable",
                       "fissile", "hapax", "ttas_backoff")


def lock_discipline_variants(disciplines=LOCK_DISCIPLINE_SET,
                             oracles=LOCK_ORACLES) -> list[dict]:
    """The ``(discipline, oracle)`` variant axis of the discipline diagram.

    Only *windowed* discipline rows (``DISCIPLINE_ROWS[...].windowed``,
    i.e. the mutable lock) read the oracle column, so non-windowed
    disciplines appear once — sweeping their oracle would duplicate
    trajectories and skew win counts toward the lower-indexed copy (the
    same pruning rule as :func:`lock_oracle_variants`)."""
    out = []
    for d in disciplines:
        fams = oracles if POLICY_ROW[POLICY_IDS[d]].windowed else oracles[:1]
        for o in fams:
            out.append(dict(lock=d, oracle=o))
    return out


def lock_discipline_sweep(n_scenarios: int = 200, seed: int = 0,
                          disciplines=LOCK_DISCIPLINE_SET,
                          oracles=LOCK_ORACLES) -> list[SimConfig]:
    """The full discipline x oracle diagram grid as one flat batch for a
    single :func:`repro_torch.core.xdes.simulate_batch` call.

    Row order is scenario-major, variant-minor (reshape to
    ``(n_scenarios, n_variants)``); scenarios follow the
    :func:`sample_scenarios` seed contract, so every sweep family sees the
    same machines scenario-by-scenario."""
    variants = lock_discipline_variants(disciplines, oracles)
    return [
        SimConfig(v["lock"], threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[v["lock"]],
                  seed=sc["seed"], oracle=v["oracle"])
        for sc in sample_scenarios(n_scenarios, seed)
        for v in variants
    ]


"""The general generator of the benchmark's sweeps, and the planner.

A cell joins a configuration (``portbench/configs/<name>.json``: the
variant axis, the threads axis, ``target_cs``, the open-loop knobs) with a
traffic mix (``portbench/traffic/<name>.json``: the scenario design and
how its scenarios fall into the phase cells that ``CellReduce`` counts
wins over).  This module turns the two files into the RAW config columns
the program's ``sweep_stream`` takes, and into nothing else: every
generator here is a frozen copy of the catalog's, so a later change to the
program cannot move the traffic.

* ``design: "sampled"`` — random machines and workloads
  (:func:`sample_scenario_columns`: threads and cores 2-32, CS and NCS
  upper bounds log-uniform 1-400 us, wake latency 2-50 us, contention
  0-4), drawn at a fixed design seed.  Phase cells: CS length (short /
  mid / long) x subscription (under / over) x wake (fast / slow).
* ``design: "paper"`` — the paper's grid (:func:`paper_scenario_columns`):
  its four CS / NCS regimes x thread counts on a fixed machine, each a
  number of replicates.  Phase cells: (regime, threads).

The ``--seed`` of a run never moves the work: sweep ``k`` of a run adds
:func:`seed_offset` to the scenario seed column, which only the random
streams of the simulation read.  The planned horizons, and so the work a
sweep needs, are the same for every seed (:func:`plan`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

POLICY_IDS = {"tas": 0, "ttas": 1, "mcs": 2, "sleep": 3, "adaptive": 4,
              "mutable": 5, "fifo": 6, "fissile": 7, "hapax": 8,
              "ttas_backoff": 9}
ORACLE_IDS = {"paper": 0, "aimd": 1, "fixed": 2, "history": 3}
ARRIVAL_IDS = {"closed": 0, "poisson": 1, "bursty": 2}
WORKLOAD_IDS = {"constant": 0, "bursty": 1, "hetero": 2, "jitter": 3}
DEFAULT_ALPHA = {"tas": 0.05, "ttas": 0.02, "mcs": 0.0, "sleep": 0.0,
                 "adaptive": 0.02, "mutable": 0.02, "fifo": 0.0,
                 "fissile": 0.02, "hapax": 0.0, "ttas_backoff": 0.01}
DEFAULT_SPIN_BUDGET = 2e-6
QUEUE_MAX = 128
#: The rollout's step cap and block length (the program's defaults).
MAX_STEPS = 200_000
BLOCK_STEPS = 32

SCENARIO_KEYS = ("threads", "cores", "cs_hi", "ncs_hi", "wake",
                 "contention", "seed")


def load_json(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


# -- scenario designs ------------------------------------------------------
def sample_scenario_columns(n: int, seed: int = 0) -> dict:
    """``n`` random scenarios, drawn one at a time from
    ``numpy.random.default_rng(seed)`` in the catalog's order (the order is
    the seed contract: scenario ``i`` is the same in every sweep size)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append((int(rng.integers(2, 33)), int(rng.integers(2, 33)),
                     float(np.exp(rng.uniform(np.log(1e-6), np.log(4e-4)))),
                     float(np.exp(rng.uniform(np.log(1e-6), np.log(4e-4)))),
                     float(np.exp(rng.uniform(np.log(2e-6), np.log(5e-5)))),
                     float(rng.uniform(0.0, 4.0)), i))
    cols = list(zip(*rows))
    return {k: np.asarray(v, np.int64 if k in ("threads", "cores", "seed")
                          else np.float64)
            for k, v in zip(SCENARIO_KEYS, cols)}


def sampled_cells(sc: dict) -> tuple[list, np.ndarray]:
    """Phase cell of each sampled scenario: (CS length, subscription,
    wake), ids in sorted order of the distinct keys."""
    keys = [("short" if cs <= 1e-5 else "mid" if cs <= 1e-4 else "long",
             "under" if th <= co else "over",
             "fast" if wk <= 1e-5 else "slow")
            for th, co, cs, wk in zip(sc["threads"], sc["cores"],
                                      sc["cs_hi"], sc["wake"])]
    return _cell_ids(keys)


def paper_scenario_columns(regimes: dict, threads, cores: int, wake: float,
                           replicates: int) -> tuple[dict, list]:
    """The paper's grid: every (regime, thread count) on ``cores`` cores
    at wake latency ``wake``, ``replicates`` times (replicate ``r`` has
    seed ``r``); contention 1, so each lock keeps its default alpha.
    Returns the scenario columns (CS and NCS as ``[0, hi)``) and each
    scenario's (regime, threads) key."""
    rows, keys = [], []
    for r in range(replicates):
        for name, (cs_hi, ncs_hi) in regimes.items():
            for tc in threads:
                rows.append((int(tc), int(cores), float(cs_hi),
                             float(ncs_hi), float(wake), 1.0, r))
                keys.append((name, int(tc)))
    cols = list(zip(*rows))
    return ({k: np.asarray(v, np.int64 if k in ("threads", "cores", "seed")
                           else np.float64)
             for k, v in zip(SCENARIO_KEYS, cols)}, keys)


def _cell_ids(keys: list) -> tuple[list, np.ndarray]:
    uniq = sorted(set(keys))
    kid = {k: i for i, k in enumerate(uniq)}
    return uniq, np.asarray([kid[k] for k in keys], np.int32)


# -- the product -----------------------------------------------------------
def product_columns(sc: dict, variants: list, wl: dict | None = None) -> dict:
    """Scenario-major x variant-minor RAW columns: scenario columns
    repeated per variant, variant columns tiled per scenario, ``alpha =
    contention x default alpha of the lock``."""
    S, V = len(sc["seed"]), len(variants)
    rep = lambda a, dt: np.repeat(np.asarray(a, dt), V)
    tile = lambda a: np.tile(a, S)
    locks = [v.get("lock", "mutable") for v in variants]
    wl = wl or {}
    wlcol = lambda key, dflt: (rep(wl[key], np.float64) if key in wl
                               else np.full(S * V, dflt, np.float64))
    return {
        "lock": tile(np.asarray([POLICY_IDS[n] for n in locks], np.int32)),
        "threads": rep(sc["threads"], np.int32),
        "cores": rep(sc["cores"], np.int32),
        "cs_lo": np.zeros(S * V, np.float64),
        "cs_hi": rep(sc["cs_hi"], np.float64),
        "ncs_lo": np.zeros(S * V, np.float64),
        "ncs_hi": rep(sc["ncs_hi"], np.float64),
        "wake_latency": rep(sc["wake"], np.float64),
        "alpha": rep(sc["contention"], np.float64)
        * tile(np.asarray([DEFAULT_ALPHA[n] for n in locks], np.float64)),
        "sws_init": np.ones(S * V, np.int32),
        "sws_max": tile(np.asarray(
            [-1 if v.get("sws_max") is None else v["sws_max"]
             for v in variants], np.int32)),
        "k": tile(np.asarray([v.get("k", 10) for v in variants], np.int32)),
        "spin_budget": np.full(S * V, DEFAULT_SPIN_BUDGET, np.float64),
        "seed": rep(sc["seed"], np.uint32),
        "oracle": tile(np.asarray(
            [ORACLE_IDS[v.get("oracle", "paper")] for v in variants],
            np.int32)),
        "workload": tile(np.asarray(
            [WORKLOAD_IDS[v.get("workload", "constant")] for v in variants],
            np.int32)),
        "wl_period": wlcol("wl_period", 1e-4),
        "wl_duty": wlcol("wl_duty", 0.25),
        "wl_burst": wlcol("wl_burst", 8.0),
        "wl_spread": wlcol("wl_spread", 4.0),
        "arrival_phase": np.zeros(S * V, np.float64),
    }


def arrival_columns(sc: dict, disc_variants: list, arrivals, rhos,
                    knobs: dict) -> dict:
    """The open-loop product: scenario-major, then arrival row, then
    offered load ``rho`` of the scenario's closed-form capacity, then the
    discipline variant.  The SLO is ``slo_rounds`` mean CS + NCS upper
    bounds, the bursty gate's period ``period_rounds`` of them."""
    S = len(sc["seed"])
    variants = [dict(arrival=a, rho=r, **v) for a in arrivals for r in rhos
                for v in disc_variants]
    V = len(variants)
    span = sc["cs_hi"] + sc["ncs_hi"]
    wl = dict(wl_period=knobs["period_rounds"] * span,
              wl_duty=np.full(S, knobs["duty"]),
              wl_burst=np.full(S, knobs["burst"]),
              wl_spread=np.full(S, 4.0))
    cols = product_columns(sc, variants, wl)
    mean_cs = 0.5 * sc["cs_hi"]
    mean_round = 0.5 * span
    eff = np.minimum(sc["threads"], sc["cores"]).astype(np.float64)
    cap = np.minimum(1.0 / np.maximum(mean_cs, 1e-12),
                     eff / np.maximum(mean_round, 1e-12))
    cols["arrival"] = np.tile(np.asarray(
        [ARRIVAL_IDS[v["arrival"]] for v in variants], np.int32), S)
    cols["arrival_rate"] = (
        np.tile(np.asarray([v["rho"] for v in variants], np.float64), S)
        * np.repeat(cap, V))
    cols["queue_cap"] = np.full(S * V, knobs["queue_cap"], np.int32)
    cols["slo"] = np.repeat(knobs["slo_rounds"] * span, V)
    cols["tie_break"] = np.zeros(S * V, np.int32)
    return cols


# -- a cell ----------------------------------------------------------------
@dataclass
class Sweep:
    """One cell's sweep: RAW columns with the design's scenario seeds, the
    ``CellReduce`` layout, and the settings of the entry call."""

    cols: dict
    group: int
    cell_ids: np.ndarray
    cell_names: list
    target_cs: int
    n_configs: int

    def with_seed(self, seed: int, k: int) -> dict:
        """The columns of sweep ``k`` of a run with ``--seed seed``: the
        scenario seeds shifted by :func:`seed_offset` (mod 2^32)."""
        cols = dict(self.cols)
        cols["seed"] = (self.cols["seed"].astype(np.uint64)
                        + np.uint64(seed_offset(seed, k))) \
            .astype(np.uint32)
        return cols


def seed_offset(seed: int, k: int) -> int:
    """A 32-bit offset from (run seed, sweep index): splitmix64 of both."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(k) + 1) & (2 ** 64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    return (x ^ (x >> 31)) & 0xFFFFFFFF


def build(config: dict, traffic: dict) -> Sweep:
    """The sweep of a (configuration, traffic) pair (module docstring)."""
    design = traffic["design"]
    if design == "sampled":
        sc = sample_scenario_columns(traffic["scenarios"],
                                     traffic["design_seed"])
        names, scen_cells = sampled_cells(sc)
    elif design == "paper":
        regimes = {k: (v[0], v[1]) for k, v in traffic["regimes"].items()}
        sc, keys = paper_scenario_columns(regimes, traffic["threads"],
                                          traffic["cores"], traffic["wake"],
                                          traffic["replicates"])
        names, scen_cells = _cell_ids(keys)
    else:
        raise ValueError(f"unknown design {design!r}")
    disc = config["variants"]
    V = len(disc)
    if config.get("open_loop"):
        ol = config["open_loop"]
        cols = arrival_columns(sc, disc, ol["arrivals"], ol["rhos"], ol)
        keys = [(a, r) for _ in range(len(sc["seed"]))
                for a in ol["arrivals"] for r in ol["rhos"]]
        names, cell_ids = _cell_ids(keys)
    else:
        cols = product_columns(sc, disc)
        cell_ids = scen_cells
    names = ["/".join(str(x) for x in k) for k in names]
    return Sweep(cols=cols, group=V, cell_ids=cell_ids, cell_names=names,
                 target_cs=int(config["target_cs"]),
                 n_configs=len(cols["lock"]))


# -- planning and encoding -------------------------------------------------
def plan(cols: dict, target_cs: int):
    """Per-config ``dt`` (float32) and planned step count (int64): ``dt``
    resolves the faster of the mean CS length and the wake latency, and
    the steps cover about ``target_cs`` critical sections of the config
    (constant workload: no mean-scale correction)."""
    cs_b = (np.asarray(cols["cs_lo"], np.float64)
            + np.asarray(cols["cs_hi"], np.float64)) / 2.0
    ncs_m = (np.asarray(cols["ncs_lo"], np.float64)
             + np.asarray(cols["ncs_hi"], np.float64)) / 2.0
    wake = (np.asarray(cols["wake_latency"], np.float64)
            * np.asarray(cols.get("park_cost", 1.0), np.float64))
    threads = np.asarray(cols["threads"], np.int64)
    cores = np.asarray(cols["cores"], np.int64)
    if np.any(np.asarray(cols["workload"]) != 0):
        raise NotImplementedError("the planner copy covers the constant "
                                  "workload row only")
    dt = np.minimum(np.maximum(cs_b, 1e-8), np.maximum(wake, 1e-8)) / 6.0
    per_cs = (np.maximum(cs_b, (cs_b + ncs_m) / np.minimum(threads, cores))
              * 1.35 + 0.25 * wake + 2.0 * dt)
    steps = np.ceil(target_cs * per_cs / dt).astype(np.int64)
    return dt.astype(np.float32), steps


def encode_row(cols: dict, i: int, dt) -> dict:
    """Row ``i`` of RAW columns in the simulator's encoded form (float32
    durations and rates, the derived start and cap of the window), with
    its ``dt``: the reference's input."""
    g = lambda k, d=None: (cols[k][i] if k in cols else d)
    lock = int(g("lock"))
    threads = int(g("threads"))
    cores = int(g("cores"))
    sws_max = int(g("sws_max"))
    sws_max_eff = cores if sws_max < 0 else sws_max
    sws_init = int(g("sws_init"))
    if lock == POLICY_IDS["sleep"]:
        start = 1
    elif lock in (POLICY_IDS["mutable"], POLICY_IDS["fissile"]):
        start = min(max(sws_init, 1), max(sws_max_eff, 1))
    else:
        start = threads
    alpha = float(g("alpha"))
    if np.isnan(alpha):
        alpha = DEFAULT_ALPHA[{v: k for k, v in POLICY_IDS.items()}[lock]]
    f = np.float32
    return {
        "policy": lock, "threads": threads, "cores": f(cores),
        "cs_lo": f(g("cs_lo")), "cs_hi": f(g("cs_hi")),
        "ncs_lo": f(g("ncs_lo")), "ncs_hi": f(g("ncs_hi")),
        "wake": f(g("wake_latency")), "alpha": f(alpha),
        "sws_init": start, "sws_max": max(sws_max_eff, start),
        "k": int(g("k")), "spin_budget": f(g("spin_budget")),
        "seed": int(g("seed")) & 0xFFFFFFFF, "oracle": int(g("oracle")),
        "workload": int(g("workload")), "wl_period": f(g("wl_period")),
        "wl_duty": f(g("wl_duty")), "wl_burst": f(g("wl_burst")),
        "arrival_phase": f(g("arrival_phase")),
        "arrival": int(g("arrival", 0)), "arr_rate": f(g("arrival_rate", 0.0)),
        "q_cap": int(g("queue_cap", QUEUE_MAX)), "slo": f(g("slo", 1e-3)),
        "tb": int(g("tie_break", 0)), "fault": int(g("fault", 0)),
        "park_cost": f(g("park_cost", 1.0)), "dt": f(dt),
    }

"""Lock-simulation sweep specs of the PyTorch port (paper Fig. 3 + the
beyond-paper scenario, oracle, discipline x oracle, workload, fault,
park-cost and open-loop arrival sweeps, with the array-native column twins
the streamed sweep takes).

The port's own copy of the lock part of ``repro/configs/catalog.py``: each
spec is a list of :class:`repro_torch.core.policy.SimConfig` rows for one
:func:`repro_torch.core.xdes.simulate_batch` call.  Row order and the
:func:`sample_scenarios` draw order are part of the contract (seeds are
stable across sweeps and equal to the reference's).  The grids of
:mod:`repro_torch.bench.sweep` build on them.

Beside them, the model catalog of the reference file: the ten registered
architectures (exact configs from public literature / HF configs, full
size) and :func:`tiny`, the reduced smoke-test variant of the same family.
The dense, rwkv6, mamba (jamba) and MoE stacks run in the port
(:mod:`repro_torch.models`); the encoder-decoder does not yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.policy import (ARRIVAL_IDS, DEFAULT_ALPHA,
                                     DEFAULT_SPIN_BUDGET, FAULT_IDS,
                                     ORACLE_IDS, POLICY_IDS, POLICY_ROW,
                                     QUEUE_MAX, WORKLOAD_IDS, SimConfig)

from .base import (AttentionConfig, LayerSpec, MambaConfig, ModelConfig,
                   MoEConfig, RWKV6Config, register)


# --------------------------------------------------------------------------
# Dense transformers
# --------------------------------------------------------------------------
@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    """34L d2560 8H kv4 hd256 dff10240 v262144; 5 local(1024):1 global,
    dual rope theta (10k local / 1M global), qk-norm, tied+scaled embed."""
    return ModelConfig(
        name="gemma3-4b", family="dense",
        num_layers=34, d_model=2560, d_ff=10240, vocab_size=262_144,
        attention=AttentionConfig(num_heads=8, num_kv_heads=4, head_dim=256,
                                  qk_norm=True, rope_theta=1_000_000.0),
        window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
        rope_theta_pattern=(10_000.0,) * 5 + (1_000_000.0,),
        pattern=(LayerSpec("attention", "dense"),),
        embed_scale=True, act="gelu", logit_chunk=512,
    )


@register("llama3.2-1b")
def llama32_1b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        num_layers=16, d_model=2048, d_ff=8192, vocab_size=128_256,
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=64,
                                  rope_theta=500_000.0),
        pattern=(LayerSpec("attention", "dense"),),
        tie_embeddings=True, act="silu",
    )


@register("qwen2.5-14b")
def qwen25_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b", family="dense",
        num_layers=48, d_model=5120, d_ff=13824, vocab_size=152_064,
        attention=AttentionConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                                  qkv_bias=True, rope_theta=1_000_000.0),
        pattern=(LayerSpec("attention", "dense"),),
        tie_embeddings=False, act="silu",
    )


@register("stablelm-3b")
def stablelm_3b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, d_ff=6912, vocab_size=50_304,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=80,
                                  rope_theta=10_000.0),
        pattern=(LayerSpec("attention", "dense"),),
        tie_embeddings=False, act="silu",
    )


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@register("granite-moe-1b-a400m")
def granite_moe() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, d_ff=512, vocab_size=49_155,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=64,
                                  rope_theta=10_000.0),
        moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
        pattern=(LayerSpec("attention", "moe"),),
        tie_embeddings=True, act="silu",
    )


@register("qwen3-moe-235b-a22b")
def qwen3_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, d_ff=1536, vocab_size=151_936,
        attention=AttentionConfig(num_heads=64, num_kv_heads=4, head_dim=128,
                                  qk_norm=True, rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536),
        pattern=(LayerSpec("attention", "moe"),),
        tie_embeddings=False, act="silu",
    )


# --------------------------------------------------------------------------
# Hybrid (jamba): period of 8 layers — attention at position 4, mamba
# elsewhere (1:7); MoE every other layer (odd positions, top-2 of 16).
# No positional encoding (jamba relies on mamba for position).
# --------------------------------------------------------------------------
@register("jamba-1.5-large-398b")
def jamba() -> ModelConfig:
    pattern = tuple(
        LayerSpec("attention" if j == 4 else "mamba",
                  "moe" if j % 2 == 1 else "dense")
        for j in range(8))
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, d_ff=24576, vocab_size=65_536,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                                  use_rope=False),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
        pattern=pattern,
        tie_embeddings=False, act="silu",
    )


# --------------------------------------------------------------------------
# VLM (chameleon): early-fusion — VQ image tokens share the text vocab, so
# the backbone is a dense decoder over mixed token streams (frontend = ids).
# --------------------------------------------------------------------------
@register("chameleon-34b")
def chameleon() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        num_layers=48, d_model=8192, d_ff=22016, vocab_size=65_536,
        attention=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                                  qk_norm=True, rope_theta=10_000.0),
        pattern=(LayerSpec("attention", "dense"),),
        tie_embeddings=False, act="silu", input_kind="mixed",
    )


# --------------------------------------------------------------------------
# SSM (rwkv6 "Finch"): attention-free, data-dependent decay
# --------------------------------------------------------------------------
@register("rwkv6-1.6b")
def rwkv6_16b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, d_ff=7168, vocab_size=65_536,
        rwkv6=RWKV6Config(head_dim=64),
        pattern=(LayerSpec("rwkv6", "rwkv_ffn"),),
        tie_embeddings=False, act="relu_sq",
    )


# --------------------------------------------------------------------------
# Audio (whisper-large-v3): enc-dec backbone; conv/mel frontend stubbed
# (input_specs feeds (B, 1500, 1280) frame embeddings).
# --------------------------------------------------------------------------
@register("whisper-large-v3")
def whisper() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, d_ff=5120, vocab_size=51_866,
        attention=AttentionConfig(num_heads=20, num_kv_heads=20, head_dim=64,
                                  use_rope=False, out_bias=True),
        pattern=(LayerSpec("attention", "dense"),),
        encoder_layers=32, encoder_seq=1500, is_encoder_decoder=True,
        tie_embeddings=True, act="gelu", input_kind="frames",
    )


# --------------------------------------------------------------------------
# Reduced smoke-test variants
# --------------------------------------------------------------------------
def tiny(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, laptop-sized: used by per-arch smoke tests."""
    kw: dict = dict(
        name=f"tiny-{cfg.name}",
        num_layers=2 * cfg.layers_per_period,
        d_model=64, d_ff=128, vocab_size=256, logit_chunk=0,
        remat="none",
    )
    if cfg.attention is not None:
        kw["attention"] = dataclasses.replace(
            cfg.attention, num_heads=4,
            num_kv_heads=min(cfg.attention.num_kv_heads, 2)
            if cfg.attention.num_kv_heads < cfg.attention.num_heads else 4,
            head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff=32)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=4, dt_rank=8)
    if cfg.rwkv6 is not None:
        kw["rwkv6"] = dataclasses.replace(cfg.rwkv6, head_dim=16, lora_w=8,
                                          lora_mix=4)
    if cfg.window_pattern is not None:
        kw["window_pattern"] = tuple(min(w, 8) if w else 0
                                     for w in cfg.window_pattern)
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 16
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------------------
# Lock-simulation sweep specs
# --------------------------------------------------------------------------
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


# -- workload x discipline x oracle diagram grid ---------------------------
#: Workload axis of the "which lock wins under which workload" diagram:
#: every WORKLOAD_ROW (repro_torch.core.policy) is represented.
LOCK_WORKLOADS = ("constant", "bursty", "hetero", "jitter")


def lock_workload_params(sc: dict) -> dict:
    """Scenario-scaled workload knobs: the bursty ON/OFF cycle is
    ``16 x (cs_hi + ncs_hi)`` — ~32 mean CS+NCS rounds, since uniform
    draws average half their hi — so every sweep horizon sees several
    phases of each thread's duty cycle regardless of the scenario's
    timescale; spread and burst factors stay at the registry defaults."""
    return dict(wl_period=16.0 * (sc["cs_hi"] + sc["ncs_hi"]),
                wl_duty=0.25, wl_burst=8.0, wl_spread=4.0)


def lock_workload_variants(workloads=LOCK_WORKLOADS,
                           disciplines=LOCK_DISCIPLINE_SET,
                           oracles=LOCK_ORACLES) -> list[dict]:
    """The ``(workload, discipline, oracle)`` variant axis of the workload
    diagram: the discipline x oracle variants (windowed-row pruning of
    :func:`lock_discipline_variants`) replicated under every workload
    row, workload-major."""
    return [dict(workload=w, **v)
            for w in workloads
            for v in lock_discipline_variants(disciplines, oracles)]


def lock_workload_sweep(n_scenarios: int = 100, seed: int = 0,
                        workloads=LOCK_WORKLOADS,
                        disciplines=LOCK_DISCIPLINE_SET,
                        oracles=LOCK_ORACLES) -> list[SimConfig]:
    """The full workload x discipline x oracle product as one flat batch
    for a single :func:`repro_torch.core.xdes.simulate_batch` call.

    Row order is scenario-major, then workload, then (discipline, oracle)
    variant — reshape to ``(n_scenarios, n_workloads, n_variants)``.
    Scenarios follow the :func:`sample_scenarios` seed contract, so every
    workload row sees the same machines scenario-by-scenario and results
    are comparable cell-by-cell with the discipline diagram."""
    disc_variants = lock_discipline_variants(disciplines, oracles)
    return [
        SimConfig(v["lock"], threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[v["lock"]],
                  seed=sc["seed"], oracle=v["oracle"], workload=w,
                  **lock_workload_params(sc))
        for sc in sample_scenarios(n_scenarios, seed)
        for w in workloads
        for v in disc_variants
    ]


# -- fault x discipline x oracle diagram grid ------------------------------
#: Fault rows of the interference diagram: every FAULT_ROW
#: (repro_torch.core.policy) is represented — the benign baseline plus
#: lock-holder preemption, CPU oversubscription, lost wake-ups with
#: timeout recovery, and timer jitter.
LOCK_FAULTS = ("none", "preempt", "oversub", "lostwake", "jitter")
#: Per-row fault intensity: the probability/fraction knob of each row at
#: a level where the spin-vs-sleep ranking visibly flips (preempt/oversub
#: strong enough to starve spinners, wake faults frequent enough to tax
#: sleepers) without collapsing every discipline to zero throughput.
LOCK_FAULT_RATES = {"none": 0.0, "preempt": 0.6, "oversub": 0.6,
                    "lostwake": 0.5, "jitter": 0.5}


def lock_fault_params(sc: dict) -> dict:
    """Scenario-scaled fault timescale: the off-CPU / recovery window is
    ``4 x (cs_hi + ncs_hi)`` — ~8 mean CS+NCS rounds, long enough that a
    preempted holder visibly stalls its waiters, short enough that every
    auto-planned horizon (~``target_cs/2`` rounds) samples dozens of
    windows."""
    return dict(fault_scale=4.0 * (sc["cs_hi"] + sc["ncs_hi"]))


def lock_fault_variants(faults=LOCK_FAULTS,
                        disciplines=LOCK_DISCIPLINE_SET,
                        oracles=LOCK_ORACLES) -> list[dict]:
    """The ``(fault, discipline, oracle)`` variant axis of the fault
    diagram: the discipline x oracle variants (windowed-row pruning of
    :func:`lock_discipline_variants`) replicated under every fault row,
    fault-major."""
    return [dict(fault=f, fault_rate=LOCK_FAULT_RATES[f], **v)
            for f in faults
            for v in lock_discipline_variants(disciplines, oracles)]


def lock_fault_sweep(n_scenarios: int = 100, seed: int = 0,
                     faults=LOCK_FAULTS,
                     disciplines=LOCK_DISCIPLINE_SET,
                     oracles=LOCK_ORACLES) -> list[SimConfig]:
    """The full fault x discipline x oracle product as one flat batch for
    a single :func:`repro_torch.core.xdes.simulate_batch` call.

    Row order is scenario-major, then fault, then (discipline, oracle)
    variant — reshape to ``(n_scenarios, n_faults, n_variants)``.
    Scenarios follow the :func:`sample_scenarios` seed contract, so every
    fault row sees the same machines scenario-by-scenario and results are
    comparable cell-by-cell with the discipline diagram (the ``none`` row
    IS the discipline diagram's benign machine)."""
    disc_variants = lock_discipline_variants(disciplines, oracles)
    return [
        SimConfig(v["lock"], threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[v["lock"]],
                  seed=sc["seed"], oracle=v["oracle"], fault=f,
                  fault_rate=LOCK_FAULT_RATES[f],
                  **lock_fault_params(sc))
        for sc in sample_scenarios(n_scenarios, seed)
        for f in faults
        for v in disc_variants
    ]


# -- arrival-rate x discipline diagram grid (open loop) --------------------
#: Arrival rows of the open-loop diagram (every non-closed ARRIVAL_ROW).
LOCK_ARRIVALS = ("poisson", "bursty")
#: Offered-load axis: fraction ``rho`` of each scenario's closed-form
#: service capacity, spanning under-load to past saturation (shedding).
LOCK_ARRIVAL_RHOS = (0.3, 0.6, 0.9, 1.2)


def lock_arrival_capacity(sc: dict) -> float:
    """Closed-form service-capacity estimate of a scenario (requests/s):
    the lock serializes at one CS per mean CS length, and below that the
    thread pool turns over a request per mean CS+NCS round per effective
    worker.  ``rho`` in :func:`lock_arrival_sweep` scales against this."""
    mean_cs = 0.5 * sc["cs_hi"]
    mean_round = 0.5 * (sc["cs_hi"] + sc["ncs_hi"])
    eff = min(sc["threads"], sc["cores"])
    return min(1.0 / max(mean_cs, 1e-12), eff / max(mean_round, 1e-12))


def lock_arrival_params(sc: dict) -> dict:
    """Scenario-scaled open-loop knobs: the latency SLO sits at 8 mean
    CS+NCS rounds — generous under light load, violated when queueing
    sets in — and the bursty arrival gate cycles with the same scenario-
    scaled period as the workload diagram (several phases per horizon)."""
    return dict(slo=4.0 * (sc["cs_hi"] + sc["ncs_hi"]),
                **lock_workload_params(sc))


def lock_arrival_variants(arrivals=LOCK_ARRIVALS, rhos=LOCK_ARRIVAL_RHOS,
                          disciplines=LOCK_DISCIPLINE_SET,
                          oracles=LOCK_ORACLES) -> list[dict]:
    """The ``(arrival, rho, discipline, oracle)`` variant axis of the
    arrival diagram: the discipline x oracle variants (windowed-row
    pruning of :func:`lock_discipline_variants`) replicated under every
    (arrival row, offered load) cell, arrival-major then rho."""
    return [dict(arrival=a, rho=r, **v)
            for a in arrivals
            for r in rhos
            for v in lock_discipline_variants(disciplines, oracles)]


def lock_arrival_sweep(n_scenarios: int = 50, seed: int = 0,
                       arrivals=LOCK_ARRIVALS, rhos=LOCK_ARRIVAL_RHOS,
                       disciplines=LOCK_DISCIPLINE_SET,
                       oracles=LOCK_ORACLES) -> list[SimConfig]:
    """The full arrival x load x discipline x oracle product as one flat
    batch for a single :func:`repro_torch.core.xdes.simulate_batch` call
    (open-loop: every row has a non-closed arrival).

    Row order is scenario-major, then arrival, then rho, then
    (discipline, oracle) variant — reshape to
    ``(n_scenarios, n_arrivals, n_rhos, n_variants)``.  Scenarios follow
    the :func:`sample_scenarios` seed contract."""
    variants = lock_arrival_variants(arrivals, rhos, disciplines, oracles)
    return [
        SimConfig(v["lock"], threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[v["lock"]],
                  seed=sc["seed"], oracle=v["oracle"],
                  arrival=v["arrival"],
                  arrival_rate=v["rho"] * lock_arrival_capacity(sc),
                  **lock_arrival_params(sc))
        for sc in sample_scenarios(n_scenarios, seed)
        for v in variants
    ]


# -- park-cost x discipline x oracle diagram grid (M:N environments) -------
#: Park-cost axis of the M:N lightweight-thread diagram: how expensive is
#: one park/unpark round trip relative to the baseline OS futex?  0.1 is a
#: user-level M:N scheduler (park = a userspace context switch), 1 the OS
#: baseline, 10/100 oversubscribed or VM-mediated kernels — spanning three
#: orders of magnitude so every sleep-leaning row gets visibly re-priced.
LOCK_PARK_COSTS = (0.1, 1.0, 10.0, 100.0)


def lock_park_variants(park_costs=LOCK_PARK_COSTS,
                       disciplines=LOCK_DISCIPLINE_SET,
                       oracles=LOCK_ORACLES) -> list[dict]:
    """The ``(park_cost, discipline, oracle)`` variant axis of the park
    diagram: the discipline x oracle variants (windowed-row pruning of
    :func:`lock_discipline_variants`) replicated under every park-cost
    environment, park-cost-major."""
    return [dict(park_cost=p, **v)
            for p in park_costs
            for v in lock_discipline_variants(disciplines, oracles)]


def lock_park_sweep(n_scenarios: int = 50, seed: int = 0,
                    park_costs=LOCK_PARK_COSTS,
                    disciplines=LOCK_DISCIPLINE_SET,
                    oracles=LOCK_ORACLES) -> list[SimConfig]:
    """The full park-cost x discipline x oracle product as one flat batch
    for a single :func:`repro_torch.core.xdes.simulate_batch` call.

    Row order is scenario-major, then park_cost, then (discipline, oracle)
    variant — reshape to ``(n_scenarios, n_park_costs, n_variants)``.
    Scenarios follow the :func:`sample_scenarios` seed contract, so every
    park-cost environment sees the same machines scenario-by-scenario and
    results are comparable cell-by-cell with the discipline diagram (the
    ``park_cost=1`` slice IS the discipline diagram's machine)."""
    disc_variants = lock_discipline_variants(disciplines, oracles)
    return [
        SimConfig(v["lock"], threads=sc["threads"], cores=sc["cores"],
                  cs=(0.0, sc["cs_hi"]), ncs=(0.0, sc["ncs_hi"]),
                  wake_latency=sc["wake"],
                  alpha=sc["contention"] * DEFAULT_ALPHA[v["lock"]],
                  seed=sc["seed"], oracle=v["oracle"], park_cost=p)
        for sc in sample_scenarios(n_scenarios, seed)
        for p in park_costs
        for v in disc_variants
    ]

# -- array-native column twins (the streamed-sweep feed) -------------------
# Each *_columns twin emits RAW struct-of-arrays columns
# (repro_torch.core.policy.RAW_CONFIG_FIELDS) directly — no per-config
# SimConfig objects — for repro_torch.core.stream.sweep_stream.  They equal
# config_columns of the corresponding list field for field (values and
# dtypes), so either form feeds the same plans and simulations.

def sample_scenario_columns(n_scenarios: int, seed: int = 0) -> dict:
    """:func:`sample_scenarios` packed as (S,) column arrays — the same
    RNG draws in the same order (the seed contract)."""
    import numpy as np

    sc = sample_scenarios(n_scenarios, seed)
    return {k: np.asarray([s[k] for s in sc],
                          np.int64 if k in ("threads", "cores", "seed")
                          else np.float64)
            for k in ("threads", "cores", "cs_hi", "ncs_hi", "wake",
                      "contention", "seed")}


def _product_columns(sc: dict, variants: list[dict],
                     wl: dict | None = None) -> dict:
    """Scenario-major x variant-minor product as RAW columns: scenario
    feature columns repeated per variant, variant columns tiled per
    scenario, ``alpha = contention x DEFAULT_ALPHA[lock]`` per row.
    ``wl`` optionally carries per-scenario (S,) workload-knob columns
    (:func:`lock_workload_params` vectorized); missing knobs take the
    SimConfig defaults."""
    import numpy as np

    S, V = len(sc["seed"]), len(variants)
    rep = lambda a, dt: np.repeat(np.asarray(a, dt), V)
    tile = lambda a: np.tile(a, S)
    lock_names = [v.get("lock", "mutable") for v in variants]
    wl = wl or {}
    wlcol = lambda key, dflt: (rep(wl[key], np.float64) if key in wl
                               else np.full(S * V, dflt, np.float64))
    return {
        "lock": tile(np.asarray([POLICY_IDS[n] for n in lock_names],
                                np.int32)),
        "threads": rep(sc["threads"], np.int32),
        "cores": rep(sc["cores"], np.int32),
        "cs_lo": np.zeros(S * V, np.float64),
        "cs_hi": rep(sc["cs_hi"], np.float64),
        "ncs_lo": np.zeros(S * V, np.float64),
        "ncs_hi": rep(sc["ncs_hi"], np.float64),
        "wake_latency": rep(sc["wake"], np.float64),
        "alpha": rep(sc["contention"], np.float64)
        * tile(np.asarray([DEFAULT_ALPHA[n] for n in lock_names],
                          np.float64)),
        "sws_init": np.ones(S * V, np.int32),
        "sws_max": tile(np.asarray(
            [-1 if v.get("sws_max") is None else v["sws_max"]
             for v in variants], np.int32)),
        "k": tile(np.asarray([v.get("k", 10) for v in variants],
                             np.int32)),
        "spin_budget": np.full(S * V, DEFAULT_SPIN_BUDGET, np.float64),
        "seed": rep(sc["seed"], np.uint32),
        "oracle": tile(np.asarray(
            [ORACLE_IDS[v.get("oracle", "paper")] for v in variants],
            np.int32)),
        "workload": tile(np.asarray(
            [WORKLOAD_IDS[v.get("workload", "constant")]
             for v in variants], np.int32)),
        "wl_period": wlcol("wl_period", 1e-4),
        "wl_duty": wlcol("wl_duty", 0.25),
        "wl_burst": wlcol("wl_burst", 8.0),
        "wl_spread": wlcol("wl_spread", 4.0),
        "arrival_phase": np.zeros(S * V, np.float64),
    }


def lock_scenario_columns(n_scenarios: int = 200, seed: int = 0,
                          locks=LOCK_DISCIPLINES) -> dict:
    """Column twin of :func:`lock_scenario_sweep`."""
    return _product_columns(sample_scenario_columns(n_scenarios, seed),
                            [dict(lock=l) for l in locks])


def lock_oracle_columns(n_scenarios: int = 200, seed: int = 0,
                        oracles=LOCK_ORACLES, ks=LOCK_ORACLE_KS,
                        sws_maxes=LOCK_ORACLE_SWS_MAX) -> dict:
    """Column twin of :func:`lock_oracle_sweep`."""
    return _product_columns(sample_scenario_columns(n_scenarios, seed),
                            lock_oracle_variants(oracles, ks, sws_maxes))


def lock_discipline_columns(n_scenarios: int = 200, seed: int = 0,
                            disciplines=LOCK_DISCIPLINE_SET,
                            oracles=LOCK_ORACLES) -> dict:
    """Column twin of :func:`lock_discipline_sweep`."""
    return _product_columns(sample_scenario_columns(n_scenarios, seed),
                            lock_discipline_variants(disciplines, oracles))


def lock_workload_columns(n_scenarios: int = 100, seed: int = 0,
                          workloads=LOCK_WORKLOADS,
                          disciplines=LOCK_DISCIPLINE_SET,
                          oracles=LOCK_ORACLES) -> dict:
    """Column twin of :func:`lock_workload_sweep` (the scenario-scaled
    workload knobs of :func:`lock_workload_params` computed as columns)."""
    import numpy as np

    sc = sample_scenario_columns(n_scenarios, seed)
    S = len(sc["seed"])
    wl = dict(wl_period=16.0 * (sc["cs_hi"] + sc["ncs_hi"]),
              wl_duty=np.full(S, 0.25), wl_burst=np.full(S, 8.0),
              wl_spread=np.full(S, 4.0))
    return _product_columns(
        sc, lock_workload_variants(workloads, disciplines, oracles), wl)


def lock_fault_columns(n_scenarios: int = 100, seed: int = 0,
                       faults=LOCK_FAULTS,
                       disciplines=LOCK_DISCIPLINE_SET,
                       oracles=LOCK_ORACLES) -> dict:
    """Column twin of :func:`lock_fault_sweep` (the scenario-scaled fault
    window of :func:`lock_fault_params` computed as a column)."""
    import numpy as np

    sc = sample_scenario_columns(n_scenarios, seed)
    variants = lock_fault_variants(faults, disciplines, oracles)
    V = len(variants)
    cols = _product_columns(sc, variants)
    cols["fault"] = np.tile(np.asarray(
        [FAULT_IDS[v["fault"]] for v in variants], np.int32), len(sc["seed"]))
    cols["fault_rate"] = np.tile(np.asarray(
        [v["fault_rate"] for v in variants], np.float64), len(sc["seed"]))
    cols["fault_scale"] = np.repeat(4.0 * (sc["cs_hi"] + sc["ncs_hi"]), V)
    return cols


def lock_arrival_columns(n_scenarios: int = 50, seed: int = 0,
                         arrivals=LOCK_ARRIVALS, rhos=LOCK_ARRIVAL_RHOS,
                         disciplines=LOCK_DISCIPLINE_SET,
                         oracles=LOCK_ORACLES) -> dict:
    """Column twin of :func:`lock_arrival_sweep` (capacity, SLO, and the
    burst-gate knobs of :func:`lock_arrival_params` computed as columns)."""
    import numpy as np

    sc = sample_scenario_columns(n_scenarios, seed)
    S = len(sc["seed"])
    variants = lock_arrival_variants(arrivals, rhos, disciplines, oracles)
    V = len(variants)
    wl = dict(wl_period=16.0 * (sc["cs_hi"] + sc["ncs_hi"]),
              wl_duty=np.full(S, 0.25), wl_burst=np.full(S, 8.0),
              wl_spread=np.full(S, 4.0))
    cols = _product_columns(sc, variants, wl)
    # vectorized lock_arrival_capacity (same float64 ops, same values)
    mean_cs = 0.5 * sc["cs_hi"]
    mean_round = 0.5 * (sc["cs_hi"] + sc["ncs_hi"])
    eff = np.minimum(sc["threads"], sc["cores"]).astype(np.float64)
    cap = np.minimum(1.0 / np.maximum(mean_cs, 1e-12),
                     eff / np.maximum(mean_round, 1e-12))
    cols["arrival"] = np.tile(np.asarray(
        [ARRIVAL_IDS[v["arrival"]] for v in variants], np.int32), S)
    cols["arrival_rate"] = (
        np.tile(np.asarray([v["rho"] for v in variants], np.float64), S)
        * np.repeat(cap, V))
    cols["queue_cap"] = np.full(S * V, QUEUE_MAX, np.int32)
    cols["slo"] = np.repeat(4.0 * (sc["cs_hi"] + sc["ncs_hi"]), V)
    cols["tie_break"] = np.zeros(S * V, np.int32)
    return cols


def lock_park_columns(n_scenarios: int = 50, seed: int = 0,
                      park_costs=LOCK_PARK_COSTS,
                      disciplines=LOCK_DISCIPLINE_SET,
                      oracles=LOCK_ORACLES) -> dict:
    """Column twin of :func:`lock_park_sweep`."""
    import numpy as np

    sc = sample_scenario_columns(n_scenarios, seed)
    variants = lock_park_variants(park_costs, disciplines, oracles)
    cols = _product_columns(sc, variants)
    cols["park_cost"] = np.tile(np.asarray(
        [v["park_cost"] for v in variants], np.float64), len(sc["seed"]))
    return cols


#: Named sweep registry (mirrors the model-config registry above).
LOCK_SWEEPS = {
    "fig3": lock_fig3_grid,
    "scenario": lock_scenario_sweep,
    "oracle": lock_oracle_sweep,
    "discipline": lock_discipline_sweep,
    "workload": lock_workload_sweep,
    "arrival": lock_arrival_sweep,
    "fault": lock_fault_sweep,
    "park": lock_park_sweep,
}

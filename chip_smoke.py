#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and nothing else: the two kernel libraries
(the simulator's: the closed and open variants of ``lock_sim_block`` and
``lock_transitions_step``, ``lock_sim_step`` and ``oracle_step``; the
language model's: ``flash_attention`` and ``rmsnorm``) are built from
``src/repro_torch/kernels/csrc`` by this run.  Exits non-zero, printing no
result line, when there is no CUDA device or when any phase fails.

Phases (each but the first prints one JSON line):

1. the card's name and power limit, the line ``nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`` prints
2. ``build``   nvcc build of both libraries at once (one compiler per
   source): seconds, and ptxas's registers / spills for each instantiation
   (the simulator's closed and open variants at 1, 2 and 4 thread slots per
   lane; ``flash_attention`` per dtype x head-dim class; ``rmsnorm`` per
   x / w dtype x vector width)
LM1. ``flash_attention_vs_plain``  ``flash_attention`` against
   ``flash_attention_ref``, both on the card, over dtype {f32, bf16} x hd
   {16, 64, 80, 128, 256} x Sq = Sk {1, 77, 1024, 2048} x GQA group {1, 4}
   x causal x window {0, 64} x softcap {0, 30}, plus 300 queries against
   1024 keys: max|d| <= 2e-5 (f32) / the smaller of 2e-2 and two bf16 ulps
   of the plain output + 2e-5 (bf16); hd 12 and 264 refused.
LM2. ``rmsnorm_vs_plain``  ``rmsnorm`` against ``rmsnorm_ref`` on rows x D
   {1x64, 7x80, 4x2048, 4096x2048, 3x8192}, f32 (rtol 2e-6) and bf16
   (one bf16 ulp), w in x's dtype; D=70, a w in f32 under bf16 x and a
   row not 16-byte aligned refused.
LM3. ``lm_vs_plain``  llama3.2-1b at full width cut to 2 layers, f32, one
   seeded set of weights: a 300-token prefill and 8 decode steps on the
   card (through the kernels) and on the CPU (plain versions), the card
   fed the CPU's greedy tokens: logits max|d| <= 1e-3, greedy tokens equal
   wherever the CPU's top-2 margin exceeds 1e-2.
LM4. ``serve_at_size``  full llama3.2-1b (16 layers, bf16, random weights
   from a seed) through ``repro_torch.launch.serve``'s code path: the
   mutable policy, 4 slots, max_seq 2048, 16 requests of 128-1024 prompt
   tokens, 32 new tokens each: seconds, generated tokens/s, median prefill
   and decode-step ms, the kernels' launches, peak bytes, and the device's
   idle share from a second, traced pass; every request must finish with
   every token in [0, V), every prefill and every decode step launching
   K8 2 * layers + 1 times and every prefill K5 once per layer.
3. ``kernel_vs_plain``  ``lock_sim_block`` against ``lock_sim_block_ref``,
   both on the card, chained from the engine's initial state for 256 steps
   over the closed conformance matrix (every policy id x workload x fault,
   park_cost in {0.25, 1, 16}), ``tie_break="random"`` rows, a T=64 and a
   T=128 batch (2 and 4 thread slots per lane), for ``n_sub_steps`` in
   {1, 32}, with a (C,) ``limit`` that cuts rows mid-block.  All 17 state
   fields must be exactly equal.
4. ``open_kernel_vs_plain``  the same for the open variant over the open
   matrix (every arrival row x policy id x tie-break, closed rows mixed in,
   every workload and fault row, offered loads from 0.3 to 8 times each
   row's capacity, small queue caps so the overloaded rows shed) and a
   T=128 batch: all 28 state fields exactly equal; departures per open row
   and the rows that shed nothing are reported and held to a floor.
5. ``step_kernels_vs_plain``  ``lock_sim_step`` and ``lock_transitions_step``
   (closed and open) against their plain versions on the card, stepping the
   closed and the open matrix (and a T=128 / T=64 batch of each) for 256
   steps: at each step one shared state goes to the kernel and to the plain
   version, with ``stepi`` as an int, a 0-d tensor and a (C,) column in
   turn, and every output must be exactly equal; a launch with an id
   outside the registry must be refused.
6. ``oracle_kernel_vs_plain``  ``oracle_step`` against ``oracle_update_ref``
   on 10**6 seeded rows (the simulator's domain plus negative ``sws``,
   ``cnt`` and ``k + 1``, where floor division differs from C's), exactly.
7. ``fig3``    ``simulate_batch`` on the 320-config Fig. 3 grid, auto
   horizon for target_cs=18 with early exit, ``backend="kernel"`` against
   ``backend="ref"`` on the card; equal under the same rule;
   ``validate()`` passes.
8. ``scan_equals_blocked``  the scan rollout, this slice's path:
   ``simulate_batch(rollout="scan")`` on the Fig. 3 grid at the horizon
   ``fig3`` plans, and on the open matrix as an open-loop batch, through
   ``lock_sim_step`` + the fault rewind + ``lock_transitions_step`` once
   per step, against the blocked rollout through ``lock_sim_block`` with
   early exit off over the same steps: every ``BatchResult`` field exactly
   equal; seconds of both rollouts and the launches of the scan.
9. ``at_size`` the 100 005-config discipline x oracle sweep (T=32,
   target_cs=50, step-count buckets, no per-thread output) through the
   kernel: configs, buckets, launches, seconds, config-steps/s, peak bytes;
   then the same sweep without the early-exit flag, to price the one
   device-to-host read per launch, and once under ``torch.profiler`` for
   the device's busy seconds and idle share.
10. ``stream_identity``  the 720-config arrival grid through the kernel
   without early exit: one-shot ``simulate_batch`` == ``sweep_stream`` in
   at least 3 chunks, and a sweep cut after its first committed chunk then
   resumed from its checkpoint == the uninterrupted one, bit for bit.
11. ``arrival_at_size``  ``sweep_stream`` over the 100 080-config arrival
   diagram (834 scenarios x 2 arrival rows x 4 loads x 15 variants, T=32,
   target_cs=50, CellReduce over the 8 (arrival, load) cells) through the
   open kernel: seconds, config-steps/s, chunks, launches, host and device
   seconds, peak bytes, the device's busy share, the cells' winners.
12. ``kernels`` the contract line: per kernel and variant, the time per
   launch at its largest main-path shape (CUDA events, median, with the
   card kept busy while the host enqueues the launch), the plain
   version's time at the same shape, the roofline bound, and the launches
   its path made (the block kernel in the sweeps, the step pair in the
   scan rollouts, ``oracle_step`` on no path: 0); ``flash_attention`` at
   one prefill layer of llama3.2-1b and ``rmsnorm`` at a prefill and a
   decode shape, with the PyTorch call that computes the same function
   (``library_ms``: ``scaled_dot_product_attention``, ``rms_norm``) and
   the launches of ``serve_at_size``.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device — the port's main path "
                     "runs on the card only\n")
    sys.exit(1)

from repro_torch.configs import catalog  # noqa: E402
from repro_torch.core import policy as P  # noqa: E402
from repro_torch.core import stream as S  # noqa: E402
from repro_torch.core import xdes  # noqa: E402
from repro_torch.core.policy import SimConfig  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels import lm_lib  # noqa: E402
from repro_torch.kernels import lock_sim as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as LMA  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as LMN  # noqa: E402

# full f32 products in the plain versions and the f32 model on the card
# (PyTorch's defaults, stated): TF32 would keep three digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEV = torch.device("cuda")
STATE_NAMES = ref.BLOCK_STATE
OPEN_NAMES = ref.BLOCK_STATE + ref.OPEN_STATE
#: Fields that may differ by rounding between kernel and plain version,
#: with their rtol; every other field must agree bit for bit.  Empty: the
#: float row sums (spin_cpu, lat_sum) are order-free by construction and
#: occ_int adds in the plain version's order.
RTOL_FIELDS = {}

# H100 SXM data-sheet peaks used for the bound (dense, 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Arithmetic / compare / ballot operations one simulated thread needs for
#: one sub-step in which nothing happens (no wake, release, poll or
#: arrival), counted on the unconditional path of csrc/lock_sim_block.cu:
#: step setup 6, GPS advance 19, wake/gate context 4, wake-completion test
#: 4, release test 4, arrival test 5, ticket retire 4.  The bound counts
#: them for each active thread (slot < ``threads``), not for the idle lanes
#: up to T; a few of them (step setup, the rate arithmetic) are per row, so
#: the count errs high.
OPS_PER_THREAD_STEP = 46
#: The open variant's idle sub-step adds, per active thread: the free-slot
#: mask 2, its rank 6, the busy mask 2...
OPS_PER_THREAD_STEP_OPEN = OPS_PER_THREAD_STEP + 10
#: ...and once per config row (the kernel repeats these warp-uniformly on
#: every lane; the function needs them once): admission 38 (burst gate 6,
#: rate select 3, Bernoulli count with its counter hash 22, queue bound 3,
#: counters 4), the bind count 5, the busy count and the occ_int update 7.
OPS_PER_ROW_STEP_OPEN = 38 + 5 + 7
#: lock_sim_step, per active thread: the GPS advance's 19 of the count
#: above.
OPS_PER_THREAD_ADVANCE = 19
#: lock_transitions_step, per active thread: the idle stage's 21 of the
#: count above (wake/gate context, the wake, release and arrival tests,
#: ticket retire) plus the per-launch workload phase hash, 14.
OPS_PER_THREAD_TRANSITION = 21 + 14
#: oracle_step, per config: the late flag, the selected row and the clamp.
OPS_PER_ROW_ORACLE = 20


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------
def compare_states(got, want, where, names=STATE_NAMES):
    """Kernel state vs plain state; returns the largest absolute
    difference over finite floats.  Fails on the first violated field."""
    if len(got) != len(names) or len(want) != len(names):
        fail(f"{where}: {len(got)} / {len(want)} arrays, expected "
             f"{len(names)}")
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if name not in RTOL_FIELDS:
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                fail(f"{where}: {name} differs in {bad}/{g.numel()} entries")
        else:
            rtol = RTOL_FIELDS[name]
            if not torch.allclose(g, w, rtol=rtol, atol=0.0):
                rel = ((g - w).abs() / w.abs().clamp_min(1e-30)).max()
                fail(f"{where}: {name} off by rel {float(rel):.3g} "
                     f"(rtol {rtol})")
        if g.dtype.is_floating_point:
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                worst = max(worst, float((g[fin] - w[fin]).abs().max()))
    return worst


RESULT_FIELDS = ("completed", "completed_per_thread", "wake_count",
                 "final_sws", "t_end", "steps_run", "spin_cpu")


def compare_results(a, b, where, fields=RESULT_FIELDS):
    for f in fields:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            fail(f"{where}: {f} differs")


# --------------------------------------------------------------------------
# phase 3 inputs
# --------------------------------------------------------------------------
SHORT, LONG, WAKE = (0.0, 3.7e-6), (0.0, 80e-6), 8e-6
PARK_COSTS = (0.25, 1.0, 16.0)


def closed_matrix(tie_break="id", threads_hi=9, seed=0):
    """Every policy id x workload x fault, enumerated from the registries,
    park_cost riding along (200 rows with today's registries)."""
    rng = np.random.default_rng(seed)
    cfgs = []
    for lock in sorted(P.POLICY_IDS):
        for w in P.WORKLOAD_ROWS:
            for flt in P.FAULT_ROWS:
                i = len(cfgs)
                cfgs.append(SimConfig(
                    lock, threads=int(rng.integers(2, threads_hi)),
                    cores=int(rng.integers(2, 9)),
                    cs=SHORT if i % 2 else LONG, ncs=SHORT,
                    wake_latency=WAKE, seed=int(rng.integers(0, 1000)),
                    workload=w, fault=flt,
                    fault_rate=0.0 if flt == "none" else 0.25,
                    park_cost=PARK_COSTS[i % len(PARK_COSTS)],
                    tie_break=tie_break))
    return cfgs


def block_args(cols):
    has_budget = P.discipline_flags(cols["policy"])[2] > 0
    return (cols["alpha"], cols["cores"], has_budget,
            *(cols[f] for f in xdes._PRM_FIELDS))


def columns_for(cfgs):
    arrs = P.encode_configs(cfgs)
    arrs["dt"], _ = xdes.plan_schedule(cfgs, 300)
    return xdes.columns_from_numpy(arrs, DEV)


def phase_kernel_vs_plain():
    batches = {
        "matrix": (closed_matrix(), 8),
        "tie_break_random": (closed_matrix("random", seed=1), 8),
        "T64": (closed_matrix("random", threads_hi=65, seed=2), 64),
        "T128": (closed_matrix(threads_hi=129, seed=3), 128),
    }
    total, worst = 256, 0.0
    K.lock_sim_block.launches = 0
    for label, (cfgs, T) in batches.items():
        cols = columns_for(cfgs)
        args = block_args(cols)
        C = len(cfgs)
        # a (C,) limit that cuts rows inside the last two 32-step blocks
        limit = (220 + torch.arange(C, device=DEV) % 13).to(torch.int32)
        for n_sub in (1, 32):
            ks = ps = xdes._init_state(cols, T)
            for step0 in range(0, total, n_sub):
                ks = K.lock_sim_block(*ks, step0, *args, n_sub_steps=n_sub,
                                      limit=limit)
                ps = ref.lock_sim_block_ref(*ps, step0, *args,
                                            n_sub_steps=n_sub, limit=limit)
                torch.cuda.synchronize()
                worst = max(worst, compare_states(
                    ks, ps, f"{label} B={n_sub} step0={step0}"))
            if int(ps[14].sum()) == 0:
                fail(f"{label}: no critical section completed — the "
                     "comparison exercised nothing")
    # scalar limit / no limit / (C,) step0 forms of the arguments
    cfgs, T = batches["matrix"]
    cols = columns_for(cfgs)
    args = block_args(cols)
    s0 = xdes._init_state(cols, T)
    step0_col = (torch.arange(len(cfgs), device=DEV) % 5).to(torch.int32)
    for step0, limit in ((0, None), (0, 20), (step0_col, 30)):
        kk = K.lock_sim_block(*s0, step0, *args, n_sub_steps=32, limit=limit)
        pp = ref.lock_sim_block_ref(*s0, step0, *args, n_sub_steps=32,
                                    limit=limit)
        worst = max(worst, compare_states(kk, pp, f"argument forms {limit}"))
    emit({"phase": "kernel_vs_plain", "batches": list(batches),
          "rows": [len(b[0]) for b in batches.values()], "steps": total,
          "n_sub_steps": [1, 32],
          "kernel_launches": K.lock_sim_block.launches,
          "exact_fields": len(STATE_NAMES), "max_abs_err": worst})
    return worst


#: Offered loads of the open matrix, as fractions of each row's closed-form
#: capacity (``catalog.lock_arrival_capacity``): three under it, where
#: binding and departure dominate, and two past it, where the small queue
#: caps shed.
OPEN_RHOS = (0.3, 0.6, 0.9, 2.0, 8.0)
#: Fewest departures per open row that the open matrix must average.  Its
#: 256 steps hold about 40 short critical sections (dt is a sixth of the
#: mean CS), so the horizon, not the load, bounds the departures.
MIN_DEPARTED_PER_OPEN_ROW = 10


def open_matrix(threads_hi=9, rhos=OPEN_RHOS, seed=0):
    """Every arrival row x policy id x tie-break (closed rows mixed in with
    the open ones), every workload and fault row riding along, offered
    loads cycling through ``rhos``, queue caps from 2 to QUEUE_MAX so that
    the overloaded rows shed (120 rows)."""
    rng = np.random.default_rng(seed)
    workloads, faults = list(P.WORKLOAD_ROWS), list(P.FAULT_ROWS)
    cfgs = []
    for lock in sorted(P.POLICY_IDS):
        for arrival in P.ARRIVAL_ROWS:
            for tb in P.TIE_BREAK_IDS:
                for cs in (SHORT, LONG):
                    i = len(cfgs)
                    flt = faults[i % len(faults)]
                    threads = int(rng.integers(2, threads_hi))
                    cores = int(rng.integers(2, 9))
                    capacity = catalog.lock_arrival_capacity(dict(
                        cs_hi=cs[1], ncs_hi=SHORT[1], threads=threads,
                        cores=cores))
                    cfgs.append(SimConfig(
                        lock, threads=threads, cores=cores, cs=cs, ncs=SHORT,
                        wake_latency=WAKE, seed=int(rng.integers(0, 1000)),
                        workload=workloads[i % len(workloads)],
                        wl_period=8e-5,
                        arrival=arrival,
                        arrival_rate=(0.0 if arrival == "closed" else
                                      rhos[i % len(rhos)] * capacity),
                        queue_cap=int(rng.choice([2, 4, 16, P.QUEUE_MAX])),
                        slo=float(rng.uniform(2e-6, 1e-4)), tie_break=tb,
                        fault=flt, fault_rate=0.0 if flt == "none" else 0.25,
                        park_cost=PARK_COSTS[i % len(PARK_COSTS)]))
    return cfgs


def phase_open_kernel_vs_plain():
    batches = {
        "open_matrix": (open_matrix(), 8),
        # loads past capacity fill the queue, so requests bind past lane 32
        "T128": ([c for c in open_matrix(129, (8.0, 32.0), seed=1)
                  if c.arrival != "closed"][:24], 128),
    }
    total, worst = 256, 0.0
    K.lock_sim_block.open_launches = 0
    totals = dict(arrived=0, shed=0, departed=0, hist=0, wide_bound=0)
    per_row = {}
    for label, (cfgs, T) in batches.items():
        cols = columns_for(cfgs)
        args = block_args(cols)
        C = len(cfgs)
        limit = (220 + torch.arange(C, device=DEV) % 13).to(torch.int32)
        for n_sub in (1, 32):
            ks = ps = xdes._init_state(cols, T, open_loop=True)
            for step0 in range(0, total, n_sub):
                ks = K.lock_sim_block(*ks[:17], step0, *args,
                                      n_sub_steps=n_sub, limit=limit,
                                      open_state=ks[17:])
                ps = ref.lock_sim_block_ref(*ps[:17], step0, *args,
                                            n_sub_steps=n_sub, limit=limit,
                                            open_state=ps[17:])
                torch.cuda.synchronize()
                worst = max(worst, compare_states(
                    ks, ps, f"{label} B={n_sub} step0={step0}", OPEN_NAMES))
                # requests bound to slots of the upper lanes (NS > 1)
                totals["wide_bound"] += int((ps[17][:, 32:] >= 0).sum())
            for i, key in ((22, "arrived"), (23, "shed"), (24, "departed")):
                totals[key] += int(ps[i].sum())
            totals["hist"] += int(ps[19].sum())
        openr = cols["arrival"] != P.AR_CLOSED
        dep = ps[24][openr].double()
        per_row[label] = {
            "open_rows": int(openr.sum()),
            "departed_min": int(dep.min()),
            "departed_median": float(dep.median()),
            "departed_mean": float(dep.mean()),
            # open rows that departed requests and shed none
            "shed_free_rows": int(((ps[23] == 0) & (ps[24] > 0)
                                   & openr).sum())}
    if min(totals.values()) <= 0:
        fail(f"open matrix exercised too little: {totals}")
    om = per_row["open_matrix"]
    if (om["departed_mean"] < MIN_DEPARTED_PER_OPEN_ROW
            or 4 * om["shed_free_rows"] < om["open_rows"]):
        fail(f"open matrix: too few departures or shed-free rows: {om}")
    emit({"phase": "open_kernel_vs_plain", "batches": list(batches),
          "rows": [len(b[0]) for b in batches.values()], "steps": total,
          "n_sub_steps": [1, 32],
          "kernel_launches": K.lock_sim_block.open_launches,
          "exact_fields": len(OPEN_NAMES) - len(RTOL_FIELDS),
          "rtol_fields": RTOL_FIELDS, "exercised": totals,
          "per_open_row": per_row, "max_abs_err": worst})
    return worst


# --------------------------------------------------------------------------
# phases 5-6: the per-step kernels
# --------------------------------------------------------------------------
TRANSITION_NAMES = ref.TRANSITION_THREAD_STATE + ref.TRANSITION_CONFIG_STATE


def advance_args(cols):
    """``alpha, cores, dt, has_budget``: the GPS advance's columns."""
    return (cols["alpha"], cols["cores"], cols["dt"],
            P.discipline_flags(cols["policy"])[2] > 0)


def step_inputs(cols, state, step):
    """The scan rollout's step ``step`` from ``state``: the plain GPS
    advance and fault rewind, and the (C,) ``now2`` and 0-d ``stepi``."""
    i = torch.tensor(step, dtype=torch.int32, device=DEV)
    i_f = i.to(torch.float32)
    rem, burn = ref.lock_sim_step_ref(state[0], state[1],
                                      *advance_args(cols))
    rem = ref.fault_rewind(state[0], rem, cols["alpha"], cols["cores"],
                           cols["dt"], i_f * cols["dt"], cols["seed"],
                           cols["fault"], cols["flt_rate"], cols["flt_scale"])
    return rem, burn, (i_f + 1.0) * cols["dt"], i


def phase_step_kernels_vs_plain():
    batches = {
        "matrix": (closed_matrix(), 8, False),
        "T128": (closed_matrix(threads_hi=129, seed=3), 128, False),
        "open_matrix": (open_matrix(), 8, True),
        "open_T64": (open_matrix(65, (0.9, 8.0), seed=1), 64, True),
    }
    total, worst = 256, 0.0
    K.lock_sim_step.launches = 0
    K.lock_transitions_step.launches = 0
    K.lock_transitions_step.open_launches = 0
    completed = {}
    for label, (cfgs, T, open_loop) in batches.items():
        cols = columns_for(cfgs)
        args = block_args(cols)
        prm = args[3:]
        adv = advance_args(cols)
        state = xdes._init_state(cols, T, open_loop)
        names = TRANSITION_NAMES + (ref.OPEN_STATE if open_loop else ())
        C = len(cfgs)
        for step in range(total):
            where = f"{label} step {step}"
            st, rem = state[0], state[1]
            want = ref.lock_sim_step_ref(st, rem, *adv)
            got = K.lock_sim_step(st, rem, *adv)
            worst = max(worst, compare_states(got, want, f"{where} advance",
                                              ("rem", "burn")))
            rem1, burn, now2, i = step_inputs(cols, state, step)
            # stepi as an int, a 0-d tensor and a (C,) column in turn
            stepi = (step, i, i.expand(C).contiguous())[step % 3]
            ostate = state[17:] if open_loop else None
            want = ref.lock_transitions_ref(st, rem1, *state[2:16], now2, i,
                                            *prm, open_state=ostate)
            got = K.lock_transitions_step(st, rem1, *state[2:16], now2,
                                          stepi, *prm, open_state=ostate)
            torch.cuda.synchronize()
            worst = max(worst, compare_states(got, want, f"{where} "
                                              "transitions", names))
            state = (*want[:16], state[16] + burn, *want[16:])
        completed[label] = int(state[14].sum())
        if completed[label] == 0:
            fail(f"{label}: no critical section completed — the comparison "
                 "exercised nothing")
        if open_loop and int(state[24].sum()) == 0:
            fail(f"{label}: no request departed")
    launches = (K.lock_sim_step.launches, K.lock_transitions_step.launches,
                K.lock_transitions_step.open_launches)
    # a policy id outside the registry is refused before any launch
    cols = columns_for(closed_matrix())
    state = xdes._init_state(cols, 8)
    rem1, _, now2, i = step_inputs(cols, state, 0)
    prm = list(block_args(cols)[3:])
    prm[xdes._PRM_FIELDS.index("policy")] = torch.full_like(
        cols["policy"], len(P.POLICY_IDS))
    try:
        K.lock_transitions_step(state[0], rem1, *state[2:16], now2, i, *prm)
        fail("lock_transitions_step launched with a policy id outside the "
             "registry")
    except ValueError:
        pass
    if K.lock_transitions_step.launches != launches[1]:
        fail("a refused lock_transitions_step call counted a launch")
    emit({"phase": "step_kernels_vs_plain", "batches": list(batches),
          "rows": [len(b[0]) for b in batches.values()], "steps": total,
          "lock_sim_step_launches": launches[0],
          "lock_transitions_step_launches": launches[1],
          "lock_transitions_step_open_launches": launches[2],
          "completed": completed, "mismatches": 0,
          "exact_fields": {"lock_sim_step": 2,
                           "lock_transitions_step": len(TRANSITION_NAMES),
                           "lock_transitions_step_open":
                               len(TRANSITION_NAMES) + len(ref.OPEN_STATE)},
          "max_abs_err": worst})
    return worst


#: Rows of the oracle comparison and timing.
ORACLE_CONFIGS = 10**6


def oracle_inputs(n, seed=0):
    """Seeded oracle observations: the simulator's domain (``k >= 1``,
    ``1 <= sws <= sws_max``, ``0 <= ewma <= EWMA_ONE``, 0/1 flags) plus
    negative ``sws``, ``cnt`` and ``k + 1`` on a sixth of the rows each,
    where Python's floor division and C's truncating one differ."""
    rng = np.random.default_rng(seed)
    sws_max = rng.integers(1, 64, n)
    sws = rng.integers(1, sws_max + 1)
    cnt = rng.integers(0, 40, n)
    k = rng.integers(1, 31, n)
    odd = rng.integers(0, 6, n)
    sws = np.where(odd == 0, rng.integers(-64, 0, n), sws)
    cnt = np.where(odd == 1, rng.integers(-40, 0, n), cnt)
    k = np.where(odd == 2, rng.integers(-40, -1, n), k)
    cols = (rng.integers(0, len(P.ORACLE_IDS), n), rng.integers(0, 2, n),
            rng.integers(0, 2, n), sws, cnt, rng.integers(0, 257, n), k,
            sws_max)
    return [torch.from_numpy(c.astype(np.int32)).to(DEV) for c in cols]


def phase_oracle_kernel_vs_plain():
    args = oracle_inputs(ORACLE_CONFIGS)
    K.oracle_step.launches = 0
    want = ref.oracle_update_ref(*args)
    got = K.oracle_step(*args)
    flags = K.oracle_step(args[0], args[1].bool(), args[2].bool(), *args[3:])
    torch.cuda.synchronize()
    names = ("delta", "cnt", "ewma")
    compare_states(got, want, "oracle_step", names)
    compare_states(flags, want, "oracle_step, bool flags", names)
    bad = args[0].clone()
    bad[7] = len(P.ORACLE_IDS)
    try:
        K.oracle_step(bad, *args[1:])
        fail("oracle_step launched with an oracle id outside the registry")
    except ValueError:
        pass
    emit({"phase": "oracle_kernel_vs_plain", "rows": ORACLE_CONFIGS,
          "oracle_ids": sorted(P.ORACLE_IDS.values()),
          "negative_rows": {"sws": int((args[3] < 0).sum()),
                            "cnt": int((args[4] < 0).sum()),
                            "k_plus_1": int((args[6] + 1 < 0).sum())},
          "launches": K.oracle_step.launches, "mismatches": 0,
          "exact_fields": len(names), "max_abs_err": 0.0})
    return args


def phase_scan_equals_blocked():
    """The scan rollout (K2 + rewind + K3 per step) against the blocked
    rollout (K1) on the Fig. 3 grid and on the open matrix, every field
    exact.  The launch counts are set to 0 just before each scan and read
    just after."""
    out = {"phase": "scan_equals_blocked"}
    launches = {}
    for label, cfgs, fields in (
            ("fig3", catalog.lock_fig3_grid(), RESULT_FIELDS),
            ("open_matrix", open_matrix(),
             RESULT_FIELDS + xdes.OPEN_RESULT_FIELDS)):
        torch.cuda.synchronize()
        K.lock_sim_step.launches = 0
        K.lock_transitions_step.launches = 0
        K.lock_transitions_step.open_launches = 0
        t0 = time.perf_counter()
        scan = xdes.simulate_batch(cfgs, target_cs=FIG3_TARGET_CS,
                                   rollout="scan")
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        n = (K.lock_sim_step.launches, K.lock_transitions_step.launches,
             K.lock_transitions_step.open_launches)
        K.lock_sim_block.launches = K.lock_sim_block.open_launches = 0
        t0 = time.perf_counter()
        blocked = xdes.simulate_batch(cfgs, target_cs=FIG3_TARGET_CS,
                                      early_exit=False)
        torch.cuda.synchronize()
        t_blocked = time.perf_counter() - t0
        nb = K.lock_sim_block.launches + K.lock_sim_block.open_launches
        compare_results(scan, blocked, f"scan_equals_blocked {label}",
                        fields)
        scan.validate(f"scan {label}")
        open_loop = label == "open_matrix"
        if n[0] != scan.n_steps or n[2 if open_loop else 1] != scan.n_steps \
                or n[1 if open_loop else 2] != 0:
            fail(f"scan {label}: {n} launches over {scan.n_steps} steps")
        if (scan.steps_run != scan.n_steps).any():
            fail(f"scan {label}: the scan rollout stopped early")
        launches[label] = n
        out[label] = {"configs": len(cfgs), "n_steps": scan.n_steps,
                      "scan_seconds": t_scan, "blocked_seconds": t_blocked,
                      "lock_sim_step_launches": n[0],
                      "lock_transitions_step_launches": n[1],
                      "lock_transitions_step_open_launches": n[2],
                      "lock_sim_block_launches": nb,
                      "completed": int(scan.completed.sum()),
                      "fields": list(fields), "mismatches": 0}
        if open_loop:
            out[label]["departed"] = int(scan.departed.sum())
    emit(out)
    return launches


# --------------------------------------------------------------------------
# phases 7-12
# --------------------------------------------------------------------------
def phase_fig3():
    cfgs = catalog.lock_fig3_grid()
    K.lock_sim_block.launches = 0
    t0 = time.perf_counter()
    kern = xdes.simulate_batch(cfgs, target_cs=FIG3_TARGET_CS,
                               backend="kernel")
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = K.lock_sim_block.launches
    t0 = time.perf_counter()
    plain = xdes.simulate_batch(cfgs, target_cs=FIG3_TARGET_CS,
                                backend="ref")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    compare_results(kern, plain, "fig3")
    kern.validate("fig3 grid")
    if launches <= 0:
        fail("fig3: simulate_batch(backend='kernel') launched no kernel")
    if not (kern.completed >= FIG3_TARGET_CS).all():
        fail("fig3: early exit left a config below target_cs")
    emit({"phase": "fig3", "configs": len(cfgs),
          "target_cs": FIG3_TARGET_CS, "n_steps": kern.n_steps,
          "steps_run": int(kern.steps_run[0]), "launches": launches,
          "kernel_seconds": t_kernel, "plain_seconds": t_plain,
          "equal": True})


def timed_sweep(cfgs, **kw):
    """One at-size sweep through the kernel; (result, seconds, launches)
    with the launch count set to 0 just before and read just after."""
    torch.cuda.synchronize()
    K.lock_sim_block.launches = 0
    t0 = time.perf_counter()
    res = xdes.simulate_batch(cfgs, target_cs=AT_SIZE_TARGET_CS,
                              bucket_steps=True, keep_per_thread=False,
                              max_threads=32, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, K.lock_sim_block.launches


def profiled(run, *kernels):
    """One more pass of ``run`` under ``torch.profiler``, tracing the card:
    (what ``run`` returns, device seconds summed over every kernel and
    copy, then the device seconds of each kernel whose name contains one of
    ``kernels``).  All work is on one stream, so the sum is the time the
    device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) * 1e-6
    return (res, busy, *(sum(e.self_device_time_total for e in on_device
                             if name in e.key) * 1e-6 for name in kernels))


def phase_stream_identity():
    """Streamed == one-shot and resumed == uninterrupted, bit for bit, on
    the kernel backend without early exit."""
    cols = catalog.lock_arrival_columns(n_scenarios=STREAM_SCENARIOS)
    cfgs = catalog.lock_arrival_sweep(n_scenarios=STREAM_SCENARIOS)
    C, V = len(cfgs), ARRIVAL_VARIANTS
    reduce = S.CellReduce(V, np.arange(C // V) % ARRIVAL_CELLS,
                          ARRIVAL_CELLS)
    kw = dict(target_cs=STREAM_TARGET_CS, early_exit=False, max_threads=32)
    t0 = time.perf_counter()
    one = xdes.simulate_batch(cfgs, keep_per_thread=False, **kw)
    chunked = S.sweep_stream(cols, mem_mb=STREAM_MEM_MB, reduce=reduce,
                             **kw)
    fields = (S.SUMMARY_FIELDS + S.OPEN_SUMMARY_FIELDS + ("lat_hist",))
    if chunked.n_chunks < 3:
        fail(f"stream_identity: {chunked.n_chunks} chunks, expected >= 3")
    compare_results(chunked, one, "stream_identity chunked vs one-shot",
                    fields)
    # the host fold of the one-shot run, in the device's float32 arithmetic
    thr = one.completed.astype(np.float32) / np.maximum(one.t_end,
                                                        np.float32(1e-30))
    host_wins = np.zeros((ARRIVAL_CELLS, V), np.int64)
    np.add.at(host_wins, (reduce.cell_ids,
                          thr.reshape(-1, V).argmax(axis=1)), 1)
    if not np.array_equal(chunked.wins, host_wins):
        fail("stream_identity: on-device wins differ from the host fold")

    class Interrupted(Exception):
        """The sweep dying after its first committed chunk."""

    real, calls = S._run_chunk, [0]

    def dying(*a, **k):
        calls[0] += 1
        if calls[0] > 1:
            raise Interrupted
        return real(*a, **k)

    with tempfile.TemporaryDirectory() as ckpt:
        S._run_chunk = dying
        try:
            S.sweep_stream(cols, mem_mb=STREAM_MEM_MB, reduce=reduce,
                           checkpoint_dir=ckpt, **kw)
        except Interrupted:
            pass
        finally:
            S._run_chunk = real
        if calls[0] != 2:
            fail(f"stream_identity: the interrupted sweep ran "
                 f"{calls[0]} chunks")
        resumed = S.sweep_stream(cols, mem_mb=STREAM_MEM_MB, reduce=reduce,
                                 checkpoint_dir=ckpt, resume=True, **kw)
    if resumed.resumed_chunks != 1:
        fail(f"stream_identity: resumed {resumed.resumed_chunks} chunks")
    compare_results(resumed, chunked, "stream_identity resumed",
                    fields + ("wins",))
    one.validate("stream_identity one-shot")
    chunked.validate("stream_identity chunked")
    emit({"phase": "stream_identity", "configs": C,
          "target_cs": STREAM_TARGET_CS, "n_steps": chunked.n_steps,
          "chunks": chunked.n_chunks, "chunk_size": chunked.chunk_size,
          "resumed_chunks": resumed.resumed_chunks,
          "departed": int(one.departed.sum()),
          "seconds": time.perf_counter() - t0, "equal": True})


def phase_arrival_at_size():
    """The 100 080-config arrival diagram through the open kernel."""
    t0 = time.perf_counter()
    cols = catalog.lock_arrival_columns(n_scenarios=ARRIVAL_SCENARIOS)
    build_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrs = P.encode_columns(cols)
    arrs["dt"], steps = xdes.plan_schedule_columns(cols, AT_SIZE_TARGET_CS)
    host_seconds = time.perf_counter() - t0    # what every sweep repeats
    C, V = len(cols["lock"]), ARRIVAL_VARIANTS
    reduce = S.CellReduce(V, np.arange(C // V) % ARRIVAL_CELLS,
                          ARRIVAL_CELLS)

    def sweep():
        torch.cuda.synchronize()
        K.lock_sim_block.launches = K.lock_sim_block.open_launches = 0
        t = time.perf_counter()
        res = S.sweep_stream(cols, target_cs=AT_SIZE_TARGET_CS,
                             reduce=reduce, max_threads=32)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t, K.lock_sim_block.open_launches,
                K.lock_sim_block.launches)

    torch.cuda.reset_peak_memory_stats()
    res, seconds, launches, closed = sweep()     # the main path, counted
    peak = torch.cuda.max_memory_allocated()
    res.validate("arrival at-size sweep")
    if launches <= 0 or closed != 0:
        fail(f"arrival_at_size: {launches} open / {closed} closed launches")
    if res.completed.shape != (C,) or res.lat_hist.shape != (C, P.LAT_NBINS):
        fail("arrival_at_size: result has the wrong shape")
    if int(res.departed.sum()) <= 0 or res.wins.sum() != C // V:
        fail("arrival_at_size: no request departed, or wins miscounted")
    _, s_again, _, _ = sweep()
    res_t, busy, kernel_busy = profiled(sweep, "lock_sim_block_kernel")
    traced_s = res_t[1]
    ok = kernel_busy > 0.0
    windowed = lambda lock: P.POLICY_ROW[P.POLICY_IDS[lock]].windowed
    names = [f"{v['lock']}/{v['oracle']}" if windowed(v["lock"])
             else v["lock"] for v in catalog.lock_discipline_variants()]
    cells = [f"{a}@{r}" for a in catalog.LOCK_ARRIVALS
             for r in catalog.LOCK_ARRIVAL_RHOS]
    config_steps = int(res.steps_run.astype(np.int64).sum())
    emit({"phase": "arrival_at_size", "configs": C, "threads_axis": 32,
          "target_cs": AT_SIZE_TARGET_CS, "n_steps": res.n_steps,
          "chunks": res.n_chunks, "chunk_size": res.chunk_size,
          "budget_mb": res.budget_mb, "launches": launches,
          "seconds": seconds, "config_steps": config_steps,
          "config_steps_per_s": config_steps / seconds,
          "peak_bytes": peak,
          "bytes_per_config_model": res.bytes_per_config,
          "host_columns_seconds": build_seconds,
          "host_plan_encode_seconds": host_seconds,
          "repeat_seconds": s_again, "traced_seconds": traced_s,
          "device_busy_seconds": busy if ok else None,
          "kernel_device_seconds": kernel_busy if ok else None,
          "host_seconds": s_again - busy if ok else None,
          "device_busy_share": busy / s_again if ok else None,
          "departed": int(res.departed.sum()),
          "shed_frac": float(res.shed.sum() / max(res.arrived.sum(), 1)),
          "median_p95_us": float(np.nanmedian(res.p95) * 1e6),
          "winners": {cells[i]: names[int(np.argmax(res.wins[i]))]
                      for i in range(ARRIVAL_CELLS)}})
    return arrs, steps, res, launches


def phase_at_size(n_scenarios):
    cfgs = catalog.lock_discipline_sweep(n_scenarios=n_scenarios)
    t0 = time.perf_counter()
    _, steps = xdes.plan_schedule(cfgs, AT_SIZE_TARGET_CS)
    P.encode_configs(cfgs)
    host_seconds = time.perf_counter() - t0     # what every sweep repeats
    buckets = xdes.plan_buckets(steps)
    torch.cuda.reset_peak_memory_stats()
    res, seconds, launches = timed_sweep(cfgs)  # the main path, counted
    peak = torch.cuda.max_memory_allocated()
    res.validate("at-size sweep")
    if launches <= 0:
        fail("at_size: the main path launched no kernel")
    if res.completed.shape != (len(cfgs),) or res.fairness is None:
        fail("at_size: result has the wrong shape")
    # the cost of the early-exit flag (one device-to-host read per launch):
    # the same sweep without it, then with it once more
    _, s_noflag, l_noflag = timed_sweep(cfgs, early_exit=False)
    _, s_again, l_again = timed_sweep(cfgs)
    res_t, busy, kernel_busy = profiled(lambda: timed_sweep(cfgs),
                                        "lock_sim_block_kernel")
    s_traced = res_t[1]
    traced = kernel_busy > 0.0      # a trace without device time: no reading
    config_steps = int(res.steps_run.astype(np.int64).sum())
    emit({"phase": "at_size", "configs": len(cfgs), "threads_axis": 32,
          "target_cs": AT_SIZE_TARGET_CS, "buckets": len(buckets),
          "launches": launches, "seconds": seconds,
          "config_steps": config_steps,
          "config_steps_per_s": config_steps / seconds,
          "reached_target": float((res.completed
                                   >= AT_SIZE_TARGET_CS).mean()),
          "peak_bytes": peak,
          "host_plan_encode_seconds": host_seconds,
          "repeat_seconds": s_again, "repeat_launches": l_again,
          "no_exit_flag_seconds": s_noflag,
          "no_exit_flag_launches": l_noflag,
          # from the traced pass; the idle share is held against the
          # untraced repeat, since tracing slows the host side only
          "traced_seconds": s_traced,
          "device_busy_seconds": busy if traced else None,
          "kernel_device_seconds": kernel_busy if traced else None,
          "device_idle_share": 1.0 - busy / s_again if traced else None})
    return cfgs, steps, max(buckets, key=len), launches


#: Cycles the card spins before a timed kernel launch (about 2.5 ms), long
#: enough for the host to enqueue the launch behind it: the events then
#: bracket the kernel's device time, not the wrapper's Python time.
HIDE_HOST_CYCLES = 5_000_000


def median_ms(fn, reps, hide_host=False):
    """Median of ``reps`` timings of ``fn`` by CUDA events.  With
    ``hide_host`` the card is kept busy while the host enqueues ``fn``'s
    launches, so a short kernel is timed on the device alone."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def roofline(n_bytes, ops):
    """The least time of a launch: ``n_bytes`` over the memory rate against
    ``ops`` over the float32 rate, the larger wins."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms}


def time_pair(kern, plain, where, names, shape):
    """Hold one kernel launch against its plain version, then time both
    (CUDA events; median of 20 launches on the device alone, and, for
    comparison, with the wrapper's host time; median of 3 plain calls)."""
    compare_states(kern(), plain(), where, names)
    return {"ms": median_ms(kern, 20, hide_host=True),
            "with_host_ms": median_ms(kern, 20),
            "plain_ms": median_ms(plain, 3), "library_ms": None,
            "shape": shape}


def time_launches(cols, T, n_steps, open_loop, ops_per_thread_step,
                  ops_per_row_step=0):
    """Time the kernels at ``cols``' shape from the state halfway through
    an ``n_steps`` run: one block launch (32 sub-steps) and, from the same
    state, one ``lock_sim_step`` (closed only: it has one variant) and one
    ``lock_transitions_step`` launch, each against its plain version.  The
    roofline bound of each: every input read once, every output written
    once; operations for the (sub-)steps it really runs, per active thread
    and per row."""
    args = block_args(cols)
    prm = args[3:]
    B = xdes.DEFAULT_BLOCK_STEPS
    state = xdes._init_state(cols, T, open_loop)
    n = len(ref.BLOCK_STATE)
    opn = lambda st: st[n:] if open_loop else None
    warm = (n_steps // 2) // B * B
    for step0 in range(0, warm, B):        # reach the middle of the run
        state = K.lock_sim_block(*state[:n], step0, *args, n_sub_steps=B,
                                 limit=n_steps, ids_checked=True,
                                 open_state=opn(state))
    C = cols["policy"].shape[0]
    active = int(torch.clamp(cols["threads"], max=T).sum())
    shape = [C, T]
    out = {}
    out["block"] = time_pair(
        lambda: K.lock_sim_block(*state[:n], warm, *args, n_sub_steps=B,
                                 limit=n_steps, ids_checked=True,
                                 open_state=opn(state)),
        lambda: ref.lock_sim_block_ref(*state[:n], warm, *args,
                                       n_sub_steps=B, limit=n_steps,
                                       open_state=opn(state)),
        "timing shape", OPEN_NAMES if open_loop else STATE_NAMES, shape)
    live_steps = min(B, n_steps - warm)
    out["block"].update(n_sub_steps=B, active_threads=active, **roofline(
        2 * nbytes(state) + nbytes(args),
        live_steps * (active * ops_per_thread_step + C * ops_per_row_step)))

    st, rem = state[0], state[1]
    if not open_loop:
        adv = advance_args(cols)
        out["advance"] = time_pair(
            lambda: K.lock_sim_step(st, rem, *adv),
            lambda: ref.lock_sim_step_ref(st, rem, *adv),
            "lock_sim_step timing shape", ("rem", "burn"), shape)
        # in: st, rem and the four columns; out: rem' and burn (C,) f32
        out["advance"].update(active_threads=active, **roofline(
            nbytes((st, rem, *adv)) + nbytes((rem, cols["dt"])),
            active * OPS_PER_THREAD_ADVANCE))
    rem1, _, now2, i = step_inputs(cols, state, warm)
    tstate = (st, rem1, *state[2:16], *(state[17:] if open_loop else ()))
    out["transitions"] = time_pair(
        lambda: K.lock_transitions_step(st, rem1, *state[2:16], now2, i,
                                        *prm, open_state=opn(state),
                                        ids_checked=True),
        lambda: ref.lock_transitions_ref(st, rem1, *state[2:16], now2, i,
                                         *prm, open_state=opn(state)),
        "lock_transitions_step timing shape",
        TRANSITION_NAMES + (ref.OPEN_STATE if open_loop else ()), shape)
    extra = 10 if open_loop else 0      # free mask, its rank, busy mask
    out["transitions"].update(active_threads=active, **roofline(
        2 * nbytes(tstate) + nbytes(prm) + nbytes((now2, i)),
        active * (OPS_PER_THREAD_TRANSITION + extra)
        + C * ops_per_row_step))
    return out


def closed_entries(cfgs, steps, idx, launches, scan_launches, max_abs_err,
                   step_abs_err):
    """K1 closed, K2 and K3 closed at the largest bucket shape of the
    at-size sweep (65 536 x 32)."""
    bucket = [cfgs[i] for i in idx]
    C = xdes._pad_quantum(len(bucket))
    bucket = bucket + [bucket[-1]] * (C - len(bucket))
    arrs = P.encode_configs(bucket)
    arrs["dt"], _ = xdes.plan_schedule(bucket, AT_SIZE_TARGET_CS)
    n_steps = min(int(steps[idx].max()), xdes.MAX_STEPS)
    timing = time_launches(xdes.columns_from_numpy(arrs, DEV), 32, n_steps,
                           False, OPS_PER_THREAD_STEP)
    src = "src/repro_torch/kernels/csrc/"
    fig3, opened = scan_launches["fig3"], scan_launches["open_matrix"]
    return [
        {"name": "lock_sim_block", "route": "cuda",
         "source": src + "lock_sim_block.cu",
         "replaces": "src/repro/kernels/lock_sim.py:463",
         "launches": launches, "max_abs_err": max_abs_err,
         **timing["block"]},
        {"name": "lock_sim_step", "route": "cuda",
         "source": src + "lock_sim_step.cu",
         "replaces": "src/repro/kernels/lock_sim.py:106",
         "launches": fig3[0] + opened[0], "max_abs_err": step_abs_err,
         **timing["advance"]},
        {"name": "lock_transitions_step", "route": "cuda",
         "source": src + "lock_transitions_step.cu",
         "replaces": "src/repro/kernels/lock_sim.py:339",
         "launches": fig3[1], "max_abs_err": step_abs_err,
         **timing["transitions"]}]


def open_entries(arrs, res, launches, scan_launches, max_abs_err,
                 step_abs_err):
    """K1-open and K3-open at the largest chunk shape of the arrival
    at-size sweep (100 080 x 32)."""
    n = min(res.chunk_size, res.n_configs)
    part = {k: v[:n] for k, v in arrs.items()}
    timing = time_launches(xdes.columns_from_numpy(part, DEV), 32,
                           res.n_steps, True, OPS_PER_THREAD_STEP_OPEN,
                           OPS_PER_ROW_STEP_OPEN)
    src = "src/repro_torch/kernels/csrc/"
    return [
        {"name": "lock_sim_block_open", "route": "cuda",
         "source": src + "lock_sim_block.cu",
         "replaces": "src/repro/kernels/lock_sim.py:463 (open_run=True, "
                     "lock_sim.py:457-481)",
         "launches": launches, "max_abs_err": max_abs_err,
         **timing["block"]},
        {"name": "lock_transitions_step_open", "route": "cuda",
         "source": src + "lock_transitions_step.cu",
         "replaces": "src/repro/kernels/lock_sim.py:339 (open_state, "
                     "lock_sim.py:314-359)",
         "launches": scan_launches["open_matrix"][2],
         "max_abs_err": step_abs_err, **timing["transitions"]}]


def oracle_entry(args):
    """K4 at 10**6 configs; on no path of the system, so 0 launches."""
    timing = time_pair(lambda: K.oracle_step(*args, ids_checked=True),
                       lambda: ref.oracle_update_ref(*args),
                       "oracle_step timing shape", ("delta", "cnt", "ewma"),
                       [ORACLE_CONFIGS])
    return {"name": "oracle_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/oracle_step.cu",
            "replaces": "src/repro/kernels/lock_sim.py:173",
            "launches": 0, "max_abs_err": 0.0, **timing,
            **roofline(nbytes(args) + 3 * nbytes(args[:1]),
                       ORACLE_CONFIGS * OPS_PER_ROW_ORACLE)}


# --------------------------------------------------------------------------
# The language model's serving path: K5 flash_attention, K8 rmsnorm
# --------------------------------------------------------------------------
#: Dense bf16 tensor-core peak of the H100 SXM (data sheet, 700 W): the
#: floor of K5's products, whatever pipe the kernel uses.
BF16_TENSOR_OPS_PER_S = 989e12
FLASH_HDS = (16, 64, 80, 128, 256)
FLASH_SEQS = (1, 77, 1024, 2048)
FLASH_LIMIT = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMS_SHAPES = ((1, 64), (7, 80), (4, 2048), (4096, 2048), (3, 8192))
LM_VS_PLAIN_PROMPT = 300
LM_VS_PLAIN_STEPS = 8
SERVE_ARGV = ["--arch", "llama3.2-1b", "--requests", "16", "--slots", "4",
              "--max-seq", "2048", "--max-new", "32", "--prompt-min", "128",
              "--prompt-max", "1025", "--policy", "mutable", "--seed", "0"]


def flash_excess(got, want):
    """max over the outputs of |got - want| / limit: the limit is
    FLASH_LIMIT in f32; in bf16 it is the smaller of FLASH_LIMIT and two
    bf16 ulps of the plain output plus the f32 limit (the f32 math's own
    error, which the final rounding can turn into one ulp), so that it
    shrinks with the output.  At most 1 where the kernel agrees."""
    d = (got.float() - want.float()).abs()
    lim = FLASH_LIMIT[got.dtype]
    if got.dtype == torch.bfloat16:
        lim = torch.clamp(2.0 * bf16_ulp(want) + FLASH_LIMIT[torch.float32],
                          max=lim)
    return float((d / lim).max())


def flash_cases():
    """(dtype, hd, Sq, Sk, group, causal, window, softcap): the matrix
    dtype x hd x Sq = Sk x group x causal x window x softcap, then Sq != Sk
    (300 queries against 1024 keys) over the mask options."""
    masks = [(c, w, s) for c in (True, False) for w in (0, 64)
             for s in (0.0, 30.0)]
    for dtype in FLASH_LIMIT:
        for hd in FLASH_HDS:
            for S in FLASH_SEQS:
                for group in (1, 4):
                    for m in masks:
                        yield (dtype, hd, S, S, group, *m)
        for group in (1, 4):
            for m in masks:
                yield (dtype, 64, 300, 1024, group, *m)


def phase_flash_attention_vs_plain():
    """K5 against flash_attention_ref, both on the card."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {str(d).split(".")[1]: 0.0 for d in FLASH_LIMIT}
    excess = dict(worst)
    n = 0
    before = LMA.launches
    for dtype, hd, Sq, Sk, group, causal, window, softcap in flash_cases():
        BH = 4
        q = torch.randn((BH, Sq, hd), generator=gen, device=DEV).to(dtype)
        k, v = (torch.randn((BH // group, Sk, hd), generator=gen,
                            device=DEV).to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = LMA(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        where = (f"flash_attention {dtype} hd={hd} Sq={Sq} Sk={Sk} "
                 f"group={group} {kw}")
        if got.shape != want.shape or got.dtype != dtype:
            fail(f"{where}: {got.shape} {got.dtype}")
        err = float((got.float() - want.float()).abs().max())
        over = flash_excess(got, want)
        if not torch.isfinite(got).all() or not over <= 1.0:
            fail(f"{where}: max|d| {err}, {over} x its limit")
        name = str(dtype).split(".")[1]
        worst[name] = max(worst[name], err)
        excess[name] = max(excess[name], over)
        n += 1
    torch.cuda.synchronize()
    refused = []
    for hd in (12, 264):
        q = torch.zeros((4, 8, hd), device=DEV, dtype=torch.bfloat16)
        try:
            LMA(q, q, q)
        except ValueError:
            refused.append(hd)
    if refused != [12, 264]:
        fail(f"flash_attention: hd 12 / 264 not refused ({refused})")
    launches = LMA.launches - before
    if launches != n:
        fail(f"flash_attention: {launches} launches for {n} cases")
    emit({"phase": "flash_attention_vs_plain", "cases": n,
          "max_abs_err": worst, "limit": {str(d).split(".")[1]: l
                                          for d, l in FLASH_LIMIT.items()},
          "bf16_limit": "min(2e-2, 2 bf16 ulps of the plain output + 2e-5)",
          "max_err_over_limit": excess,
          "refused_hd": refused, "seconds": time.perf_counter() - t0})
    return max(worst.values())


def bf16_ulp(x):
    """One bf16 ulp at each value of x (f32), 2^-133 at 0."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def phase_rmsnorm_vs_plain():
    """K8 against rmsnorm_ref on the card: f32 within rtol 2e-6, bf16
    within one bf16 ulp of the plain output; w in x's dtype.  A D that is
    not a multiple of the 16-byte vector, a w in another dtype and a
    misaligned row are refused."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(1)
    out = {"phase": "rmsnorm_vs_plain", "cases": 0, "f32_max_rel": 0.0,
           "bf16_max_ulps": 0.0, "max_abs_err": 0.0}
    for rows, D in RMS_SHAPES:
        x32 = torch.randn((rows, D), generator=gen, device=DEV) * 3.0
        w32 = torch.randn((D,), generator=gen, device=DEV) * 0.1
        for xd in (torch.float32, torch.bfloat16):
            x, w = x32.to(xd), w32.to(xd)
            got, want = LMN(x, w), ref.rmsnorm_ref(x, w)
            where = f"rmsnorm {rows}x{D} {xd}"
            if got.dtype != xd or got.shape != x.shape:
                fail(f"{where}: {got.dtype} {got.shape}")
            d = (got.float() - want.float()).abs()
            if xd == torch.float32:
                rel = float((d / want.abs().clamp_min(1e-30)).max())
                if not rel <= 2e-6:
                    fail(f"{where}: rel {rel} over 2e-6")
                out["f32_max_rel"] = max(out["f32_max_rel"], rel)
            else:
                ulps = float((d / bf16_ulp(want)).max())
                if not ulps <= 1.0:
                    fail(f"{where}: {ulps} bf16 ulps")
                out["bf16_max_ulps"] = max(out["bf16_max_ulps"], ulps)
            out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
            out["cases"] += 1
    x = torch.zeros((5, 72), device=DEV, dtype=torch.bfloat16)
    w = torch.zeros((72,), device=DEV, dtype=torch.bfloat16)
    flat = torch.zeros((1 + 72,), device=DEV, dtype=torch.bfloat16)
    refused = []
    for name, args in (("D=70", (x[:, :70].contiguous(), w[:70])),
                       ("w f32", (x, w.float())),
                       ("misaligned", (flat[1:].view(1, 72), w))):
        n = LMN.launches
        try:
            LMN(*args)
        except (ValueError, TypeError):
            refused.append(name)
        if LMN.launches != n:
            fail(f"rmsnorm: launched on {name}")
    if len(refused) != 3:
        fail(f"rmsnorm: refused only {refused}")
    out["refused"] = refused
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out["max_abs_err"]


def lm_run(cfg, model, device, prompt, n_steps, forced=None):
    """Prefill ``prompt`` and take ``n_steps`` decode steps, feeding the
    tokens ``forced`` or, without them, the greedy token of the previous
    logits: (the logits of the prefill and of every step, f32 on the host;
    the tokens fed)."""
    from repro_torch import models
    from repro_torch.serve import DecodeEngine, Request
    eng = DecodeEngine(cfg, model, max_slots=1,
                       max_seq=len(prompt) + n_steps + 8, device=device)
    toks = torch.tensor([prompt], device=device)
    logits, cache1 = models.prefill(cfg, eng.params, {"tokens": toks})
    out, fed = [logits[0].float().cpu()], []
    eng.insert(0, cache1, len(prompt), 0, Request(0, prompt, n_steps + 1))
    for i in range(n_steps):
        tok = int(out[-1].argmax()) if forced is None else forced[i]
        fed.append(tok)
        logits, eng.cache = models.decode_step(
            cfg, eng.params, eng.cache, torch.tensor([[tok]], device=device))
        out.append(logits[0].float().cpu())
    return out, fed


def phase_lm_vs_plain():
    """llama3.2-1b at full width cut to 2 layers, f32, one seeded set of
    parameters: a 300-token prefill and 8 decode steps on the card (K5, K8)
    and on the CPU (plain versions), the card fed the CPU's greedy
    tokens."""
    import copy

    from repro_torch import models
    from repro_torch.configs import base as CB
    cfg = CB.get_config("llama3.2-1b").replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(2, cfg.vocab_size - 1,
                                           LM_VS_PLAIN_PROMPT)]
    cpu, forced = lm_run(cfg, cpu_model, "cpu", prompt, LM_VS_PLAIN_STEPS)
    k5, k8 = LMA.launches, LMN.launches
    gpu, _ = lm_run(cfg, gpu_model, DEV, prompt, LM_VS_PLAIN_STEPS, forced)
    k5, k8 = LMA.launches - k5, LMN.launches - k8
    if k5 != cfg.num_layers or k8 != (2 * cfg.num_layers + 1) * (
            LM_VS_PLAIN_STEPS + 1):
        fail(f"lm_vs_plain: {k5} K5 / {k8} K8 launches on the card")
    worst, clear, agree = 0.0, 0, 0
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        if not torch.isfinite(g).all():
            fail(f"lm_vs_plain: non-finite logits at step {i}")
        worst = max(worst, float((c - g).abs().max()))
        top2 = torch.topk(c, 2).values
        if float(top2[0] - top2[1]) > 1e-2:
            clear += 1
            if int(g.argmax()) != int(c.argmax()):
                fail(f"lm_vs_plain: greedy token differs at step {i} "
                     f"(CPU margin {float(top2[0] - top2[1])})")
            agree += 1
    if not worst <= 1e-3:
        fail(f"lm_vs_plain: logits max|d| {worst} over 1e-3")
    emit({"phase": "lm_vs_plain", "arch": "llama3.2-1b", "layers": 2,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": "float32",
          "prompt": LM_VS_PLAIN_PROMPT, "decode_steps": LM_VS_PLAIN_STEPS,
          "logits_max_abs_err": worst, "limit": 1e-3,
          "steps_compared": len(cpu), "steps_with_clear_margin": clear,
          "greedy_equal": agree, "k5_launches": k5, "k8_launches": k8,
          "seconds": time.perf_counter() - t0})


def phase_serve_at_size():
    """Full llama3.2-1b (16 layers, bf16, random weights from a seed)
    through ``repro_torch.launch.serve``'s code path: the mutable policy,
    4 slots, max_seq 2048, 16 requests of 128-1024 prompt tokens, 32 new
    tokens each."""
    from repro_torch.launch import serve
    args = serve.parse_args(SERVE_ARGV)
    t0 = time.perf_counter()
    cfg, engine = serve.build(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = serve.parse_args(SERVE_ARGV[:2] + ["--requests", "2", "--slots",
                                              "4", "--max-new", "2",
                                              "--seed", "1"])
    serve.run(warm, cfg, engine)               # cuBLAS handles, first calls
    k8_prefill = [0]
    real_prefill = engine.prefill

    def prefill(prompt):
        n = LMN.launches
        res = real_prefill(prompt)
        k8_prefill[0] += LMN.launches - n
        return res

    engine.prefill = prefill
    engine.prefill_seconds.clear()
    engine.step_seconds.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LMA.launches = LMN.launches = 0            # the main path, counted
    try:
        out = serve.run(args, cfg, engine)
        torch.cuda.synchronize()
    finally:
        engine.prefill = real_prefill
    k5, k8, k8_pre = LMA.launches, LMN.launches, k8_prefill[0]
    peak = torch.cuda.max_memory_allocated()
    reqs, s = out["requests"], out["summary"]
    if s["completed"] != args.requests:
        fail(f"serve_at_size: {s['completed']} of {args.requests} done")
    for r in reqs:
        if len(r.generated) != args.max_new or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"serve_at_size: request {r.rid} generated {r.generated}")
    prefill_ms = [t * 1e3 for t in engine.prefill_seconds]
    step_ms = [t * 1e3 for t in engine.step_seconds]
    per_forward = 2 * cfg.num_layers + 1
    if (len(prefill_ms) != args.requests
            or k5 != cfg.num_layers * args.requests
            or k8_pre != per_forward * args.requests
            or k8 - k8_pre != per_forward * len(step_ms)):
        fail(f"serve_at_size: {k5} K5 / {k8_pre} + {k8 - k8_pre} K8 "
             f"launches for {len(prefill_ms)} prefills and {len(step_ms)} "
             f"decode steps")
    seconds = out["seconds"]
    t_trace = time.perf_counter()
    res, busy, k5_s, k8_s = profiled(lambda: serve.run(args, cfg, engine),
                                     "flash_attention_kernel",
                                     "rmsnorm_kernel")
    trace_s = time.perf_counter() - t_trace
    traced = busy > 0.0
    tokens = sum(len(r.generated) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    emit({"phase": "serve_at_size", "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in engine.params.parameters()),
          "policy": args.policy, "slots": args.slots,
          "max_seq": args.max_seq, "requests": args.requests,
          "prompt_tokens": prompt_tokens, "generated_tokens": tokens,
          "seconds": seconds, "generated_tokens_per_s": tokens / seconds,
          "median_prefill_ms": float(np.median(prefill_ms)),
          "max_prefill_ms": float(np.max(prefill_ms)),
          "median_decode_step_ms": float(np.median(step_ms)),
          "decode_steps": len(step_ms),
          "k5_launches": k5, "k8_launches": k8,
          "k8_launches_prefill": k8_pre,
          "k8_launches_decode": k8 - k8_pre,
          "late_handoff_rate": s["late_handoff_rate"],
          "avg_standby": s["avg_standby"],
          "window_trace_tail": out["stats"].window_trace[-8:],
          "peak_bytes": peak, "build_seconds": build_s,
          "traced_seconds": res["seconds"],
          "trace_and_read_seconds": trace_s,
          "device_busy_seconds": busy if traced else None,
          "k5_device_seconds": k5_s if traced else None,
          "k8_device_seconds": k8_s if traced else None,
          "device_idle_share": 1.0 - busy / seconds if traced else None,
          "phase_seconds": time.perf_counter() - t0})
    return {"k5": k5, "k8_prefill": k8_pre, "k8_decode": k8 - k8_pre}


def lm_entries(serve_launches, flash_err, rms_err):
    """K5 at one prefill layer of llama3.2-1b (Sq = Sk = 1024, B*H = 32,
    B*KV = 8, hd 64, bf16, causal) and K8 at 1024 x 2048 (prefill) and
    4 x 2048 (a decode step of four slots), bf16: device ms, with-host ms,
    plain ms, the library call's ms, the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(2)
    BH, BKV, S, hd = 32, 8, 1024, 64
    bf = torch.bfloat16
    q = torch.randn((BH, S, hd), generator=gen, device=DEV).to(bf)
    k, v = (torch.randn((BKV, S, hd), generator=gen, device=DEV).to(bf)
            for _ in range(2))
    kern = lambda: LMA(q, k, v, causal=True)
    plain = lambda: ref.flash_attention_ref(q, k, v, causal=True)
    q4, k4, v4 = q[None], k[None], v[None]
    library = lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True)
    got, want = kern(), plain()
    err = float((got.float() - want.float()).abs().max())
    over = flash_excess(got, want)
    if not torch.isfinite(got).all() or not over <= 1.0:
        fail(f"flash_attention at the prefill layer: max|d| {err}, {over} "
             f"x its limit")
    lib_err = float((library()[0].float() - want.float()).abs().max())
    ops = 4 * BH * hd * (S * (S + 1) // 2)     # QK^T and PV, causal pairs
    n_bytes = nbytes((q, k, v)) + q.numel() * q.element_size()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    src = "src/repro_torch/kernels/csrc/"
    out = [{"name": "flash_attention", "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:140",
            "launches": serve_launches["k5"],
            "max_abs_err": max(flash_err, err),
            "ms": median_ms(kern, 20, hide_host=True),
            "with_host_ms": median_ms(kern, 20),
            "plain_ms": median_ms(plain, 5),
            "library_ms": median_ms(library, 20, hide_host=True),
            "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "shape": [BH, BKV, S, S, hd], "dtype": "bfloat16",
            "causal": True}]
    for rows, launches, tag in ((1024, serve_launches["k8_prefill"],
                                 "prefill"),
                                (4, serve_launches["k8_decode"], "decode")):
        D = 2048
        x = torch.randn((rows, D), generator=gen, device=DEV).to(bf)
        w = (torch.randn((D,), generator=gen, device=DEV) * 0.1).to(bf)
        w1 = (1.0 + w.float()).to(bf)
        kern = lambda: LMN(x, w)
        plain = lambda: ref.rmsnorm_ref(x, w)
        library = lambda: F.rms_norm(x, (D,), weight=w1, eps=1e-6)
        got, want = kern(), plain()
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        if not float((d / bf16_ulp(want)).max()) <= 1.0:
            fail(f"rmsnorm at {rows} x {D}: over one bf16 ulp")
        n_bytes = 2 * nbytes((x,)) + nbytes((w,))
        out.append({"name": "rmsnorm" if tag == "prefill"
                    else "rmsnorm_decode",
                    "route": "cuda", "source": src + "rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm.py:44",
                    "launches": launches,
                    "max_abs_err": max(rms_err, err),
                    "ms": median_ms(kern, 20, hide_host=True),
                    "with_host_ms": median_ms(kern, 20),
                    "plain_ms": median_ms(plain, 5),
                    "library_ms": median_ms(library, 20, hide_host=True),
                    **roofline(n_bytes, 4 * rows * D),
                    "shape": [rows, D], "dtype": "bfloat16",
                    "path": f"serve_at_size {tag}"})
    return out


#: Fig. 3's depth (and the scan rollout's horizon, which follows it): 18
#: critical sections per config, 7437 planned steps, early exit at 7072.
#: The eager plain version takes most of the script's time (270-335 s at
#: 25 CS); at 16 or fewer the planned horizon leaves a config short.
FIG3_TARGET_CS = 18
AT_SIZE_TARGET_CS = 50
AT_SIZE_SCENARIOS = 6667        # x 15 variants = 100 005 configs
#: The arrival diagram: 834 scenarios x (2 arrival rows x 4 loads = 8
#: cells) x 15 (discipline, oracle) variants = 100 080 configs.
ARRIVAL_SCENARIOS = 834
ARRIVAL_CELLS = 8
ARRIVAL_VARIANTS = 15
#: The quick arrival grid of stream_identity: 6 x 8 x 15 = 720 configs, a
#: budget that forces 345-config chunks (3 of them), a short horizon.
STREAM_SCENARIOS = 6
STREAM_MEM_MB = 1.5
STREAM_TARGET_CS = 20


def main():
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # both libraries at once: one nvcc per source of each
    sim_build, lm_build = KB.build_libraries([K.LIBRARY, lm_lib.LIBRARY])
    # one "Compiling entry function" line names each instantiation
    # (lock_sim_block_kernel<NS, OPEN>, flash_attention_kernel<T, NJ>,
    # rmsnorm_kernel<T, TW, VEC>), its registers and spills follow
    ptxas = lambda b: [ln.strip() for ln in b.log.splitlines()
                       if "entry function" in ln or "registers" in ln
                       or "spill" in ln]
    emit({"phase": "build",
          "seconds": max(sim_build.seconds, lm_build.seconds),
          "cached": sim_build.cached and lm_build.cached,
          "library": os.path.relpath(sim_build.path, HERE),
          "ptxas": ptxas(sim_build),
          "lm_library": os.path.relpath(lm_build.path, HERE),
          "lm_ptxas": ptxas(lm_build),
          # the pair whose device math libraries must agree for phase 3
          "nvcc": KB.nvcc_release(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})

    flash_err = phase_flash_attention_vs_plain()
    rms_err = phase_rmsnorm_vs_plain()
    phase_lm_vs_plain()
    serve_launches = phase_serve_at_size()
    max_abs_err = phase_kernel_vs_plain()
    open_abs_err = phase_open_kernel_vs_plain()
    step_abs_err = phase_step_kernels_vs_plain()
    oracle_args = phase_oracle_kernel_vs_plain()
    phase_fig3()
    scan_launches = phase_scan_equals_blocked()
    cfgs, steps, big, launches = phase_at_size(AT_SIZE_SCENARIOS)
    phase_stream_identity()
    arrs, _, ares, open_launches = phase_arrival_at_size()
    entries = (closed_entries(cfgs, steps, big, launches, scan_launches,
                              max_abs_err, step_abs_err)
               + open_entries(arrs, ares, open_launches, scan_launches,
                              open_abs_err, step_abs_err)
               + [oracle_entry(oracle_args)]
               + lm_entries(serve_launches, flash_err, rms_err))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

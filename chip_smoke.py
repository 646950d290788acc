#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and nothing else: the two kernel libraries
(the simulator's: the closed and open variants of ``lock_sim_block`` and
``lock_transitions_step``, ``lock_sim_step`` and ``oracle_step``; the
language model's: ``flash_attention`` (its SIMT kernel and its tensor-core
kernel), ``rwkv6_scan``, ``mamba_scan`` and ``rmsnorm``) are built from
``src/repro_torch/kernels/csrc`` by this run.  Exits non-zero, printing no
result line, when there is no CUDA device or when any phase fails.

Phases (each but the first prints one JSON line):

1. the card's name and power limit, the line ``nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`` prints
2. ``build``   nvcc build of both libraries at once (one compiler per
   source): seconds, and ptxas's registers / spills for each instantiation
   (the simulator's closed and open variants at 1, 2 and 4 thread slots per
   lane; ``flash_attention`` per dtype x head-dim class and its
   tensor-core kernel per head dim; ``rwkv6_scan`` per head dim;
   ``mamba_scan`` per state size; ``rmsnorm`` per dtype); fails unless
   ``cuobjdump -sass`` shows ``HGMMA`` in both instantiations of the
   tensor-core kernel, whose registers and spills it prints apart;
   ``k1_sass``: per ``lock_sim_block_kernel<NS, OPEN>`` instantiation its
   static SASS counts (total, VOTE, REDUX, SHFL, MUFU, CALL, BSSY, BRA,
   LDS, STS, integer, the most frequent opcodes), its registers and
   spills, and the blocks and warps resident on an SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); ``k6_sass`` the
   same per ``rwkv6_scan_kernel<n, cols>`` instantiation (FFMA, FMUL, SHFL,
   BAR among the classes), with the shared memory of one CTA at chunk 64
   and 128; fails if an instantiation is missing or spills
LM1. ``flash_attention_vs_plain``  ``flash_attention`` against
   ``flash_attention_ref``, both on the card, over dtype {f32, bf16} x hd
   {16, 64, 80, 128, 256} x Sq = Sk {1, 77, 1024, 2048} x GQA group {1, 4,
   8} on 8 query heads x causal x window {0, 64} x softcap {0, 30}, plus
   300 queries against 1024 keys, plus jamba's layer (64 query heads on 8
   KV heads, hd 128, causal) at S {1, 77, 1024, 2048}: 1016 cases,
   max|d| <= 2e-5 (f32) / the smaller of 2e-2 and two bf16 ulps of the
   plain output + 2e-5 (bf16); hd 12 and 264 refused.  Traced:
   the 220 bf16 cases with hd 64 or 128 must count in ``tc_launches`` and
   run ``flash_attention_kernel_sm90``, the other 796 the SIMT kernel.
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
   K8 2 * layers + 1 times and every prefill K5 once per layer, each K5
   launch on the tensor-core kernel (bf16, hd 64).
LM5. ``rwkv6_scan_vs_plain``  ``rwkv6_scan`` against ``rwkv6_scan_ref``,
   both on the card, f32, n = 64 over B*H {1, 32, 128} x T {1, 7, 64, 65,
   1024, 2048} x s0 {none, random} x w {the model's range exp(-exp(-6 +-
   1)), uniform (0.01, 1)} x chunk {1, 16, 64, 128}, plus n = 16 cases: y
   and S_T within RWKV6_LIMIT * max(1, max|plain|) each; every chunk bit
   for bit equal to chunk 1, and the first RWKV6_ROWS_ALONE rows of each
   larger case, run alone (the launcher then splits a head over more
   CTAs: 4 against 2 at B*H 128), bit for bit equal to the batch's; fails
   unless some n = 64 case ran two splits; bf16 inputs and n = 32
   refused.
LM6. ``rwkv6_lm_vs_plain``  rwkv6-1.6b at full width cut to 2 layers, f32,
   one seeded set of weights (the time-mix groupnorm drawn from the seed in
   place of the reference's zeros, so that the scan shows in the logits):
   a 300-token prefill and 8 decode steps on the card and on the CPU, the
   card fed the CPU's greedy tokens: logits max|d| <= 1e-3 and the last
   wkv states within 1e-3 * max(1, max|CPU|), greedy tokens equal wherever
   the CPU's top-2 margin exceeds 1e-2.
LM7. ``serve_rwkv6_at_size``  ``serve_at_size`` for the full rwkv6-1.6b
   (24 layers, bf16, random weights from a seed), the same traffic: every
   prefill and every decode step launching K6 once per layer and K8
   2 * layers + 1 times.
LM8. ``mamba_scan_vs_plain``  ``mamba_scan`` against ``mamba_scan_ref``,
   both on the card, f32, over B {1, 2} x T {1, 7, 64, 65, 1024} x d {48,
   128, 16 384} x N {4, 8, 16} x dt {the model's range, U(1e-3, 1)} x
   chunk {16, 64}: y and s_T within MAMBA_LIMIT * max(1, max|plain|) each,
   chunk 16 == chunk 64 bit for bit; bf16 inputs and N = 32 refused.
LM9. ``jamba_lm_vs_plain``  jamba-1.5-large at full width cut to two
   layers, (mamba, dense) then (attention, dense), f32 (2 844 696 576
   parameters, the card's copy filled tensor by tensor): the comparison of
   ``lm_vs_plain`` and the last mamba states within 1e-3 * max(1,
   max|CPU|).
LM10. ``moe_lm_vs_plain``  granite-moe-1b-a400m at full width cut to two
   layers, f32: the comparison of ``lm_vs_plain`` over its MoE FFNs, with
   the count of routings whose k-th and (k+1)-th router probabilities lie
   within 1e-5 on the CPU.
LM11. ``serve_jamba_at_size``  ``serve_at_size`` for jamba-1.5-large at
   full width, its first 5 layers (4 mamba, 1 attention; 2 MoE, 3 dense
   FFNs; 24 012 218 368 parameters, bf16), the same traffic: every prefill
   launching K5 once (on the tensor cores: bf16, hd 128), K7 4 times and
   K8 15 times (two a layer, the final norm, one inside each mamba mixer),
   every decode step K8 15 times and K7 never; the peak bytes of
   ``init_params`` and of the drain.
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
12. ``diagrams``  the sweep layer, ``repro_torch.bench``, through the
   kernel: each of the six diagram writers' ``main`` at the reference's
   one-device defaults (target_cs 150; oracle 200 scenarios x 23
   variants, discipline 200 x 15, workload 100 x 4 x 15, arrival 50 x 8 x
   15 through K1-open, fault 100 x 5 x 15, park 50 x 4 x 15), the
   discipline writer with its ``--refine`` lattice (16 x 12, factor 3),
   reports into a temporary directory; then the fault writer at 1334
   scenarios (100 050 configs) streamed, the phase cells' wins
   accumulated on the card.  Per grid: configs, ``n_steps``, seconds of
   the writer's ``main`` (the discipline writer's with its lattice) and
   of its sweep calls on the host clock ending in ``synchronize``,
   launches, chunks, config-steps a second over the sweep seconds, the
   winner of each phase cell; for the streamed grid its peak bytes and
   host plan + encode seconds.  Fails unless each grid launched its
   kernel variant and no other, every result validates, the wins of each
   row of cells hold every scenario once (each refine pass: every point
   once), every CSV has a line per cell and every Markdown report is
   non-empty, and the streamed grid's on-card wins equal the host fold of
   its own per-config completed / t_end in f32.
13. ``paper_figures``  the paper's own artifacts on the port
   (``repro_torch.bench.lockbench``, ``fidelity_study``, ``sched_bench``
   and the event-driven DES ``repro_torch.core.des``): Fig. 1 on the DES
   (fails unless C1 holds: ttas < 3.5 slots, sleep in (4.5, 5.5), mutable
   < 3.5 with less spin than ttas); Fig. 3 at target_cs 400, seeds (0, 1),
   through K1 on the card, then on the DES at target_cs 2000 (fails
   unless C2-C4 hold on both engines), with each engine's ratio_to_opt of
   mutable and pt-exp and the xdes / DES throughput of the 160
   seed-averaged cells (min, median, max); the six xdes-against-DES band
   families of the reference's tests (``test_xdes.py``'s three cells,
   fifo at 4 and 20 threads, fissile / hapax / ttas_backoff over three
   (threads, park_cost) points, the four workload rows, the five fault
   rows, the poisson and bursty arrival rows on K1-open with the mean
   sojourn too), each at its test's own cells, seeds, target_cs,
   ``n_steps`` and ``dt`` as one ``simulate_batch`` through the kernel
   against the DES on the host: every seed-averaged ratio in [0.7, 1.4];
   the dt-fidelity study at its defaults (90 configs in one call, 150 000
   steps, early exit), failing if an entry is not finite or the band at
   dt <= 3e-7 exceeds 0.3; ``sched_bench.run_policy`` for zero, max and
   mutable at 250 requests (fails unless C6 holds), then
   ``sched_bench.xdes_sweep(20)`` through K1.  Each part's seconds and
   launches, set to 0 just before it.
14. ``kernels`` the contract line: per kernel and variant, the time per
   launch at its largest main-path shape (CUDA events, median, with the
   card kept busy while the host enqueues the launch), the plain
   version's time at the same shape, the roofline bound (the simulator
   kernels' operations over 128 single f32 / i32 lane operations a clock
   and SM, as they issue no FMA; the LM kernels' over their own peaks),
   for the block kernel ``rows_per_sm_ms`` (its device ms at C = SMs x w
   rows for w = 4 ... 40 warps an SM: flat up to the occupancy limit means
   latency-bound, growing from small w issue-bound), and the launches
   its path made (the block kernel in the sweeps, the step pair in the
   scan rollouts, ``oracle_step`` on no path: 0; the block kernel's two
   entries also carry ``diagrams_launches`` and
   ``paper_figures_launches``, its launches in those phases); ``flash_attention`` at
   one prefill layer of llama3.2-1b and of jamba (hd 64 and 128, both on
   the tensor cores, each with its own bound and SDPA time) and
   ``rmsnorm`` at a prefill and a decode shape, with the PyTorch call that
   computes the same function (``library_ms``: ``scaled_dot_product_attention``, ``rms_norm``) and
   the launches of ``serve_at_size``; ``rwkv6_scan`` at one prefill layer
   (B*H = 32, T = 1024) and one decode step (B*H = 128, T = 1) of
   rwkv6-1.6b, with no library call (none computes the WKV recurrence),
   the launches of ``serve_rwkv6_at_size``, the CTAs a head its launch
   took and, at prefill, ``bh_ms`` (its device ms at T = 1024 for B*H in
   ``RWKV6_BH_MS``) with ``bh_ctas_per_head``, the split each point took:
   the launcher gives a head 4 CTAs up to B*H 33 and 2 from 34 on the
   H100's 132 SMs, so points of one split compare with each other;
   ``mamba_scan`` at one
   prefill layer of jamba (B 1, T 1024, d_in 16 384, N 16), bound by the
   larger of its bytes, its f32 operations and its exps on the
   special-function units, with no library call and the launches of
   ``serve_jamba_at_size``.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
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

from repro_torch.bench import fidelity_study as FS  # noqa: E402
from repro_torch.bench import lockbench as LB  # noqa: E402
from repro_torch.bench import sched_bench as SB  # noqa: E402
from repro_torch.bench import sweep as B  # noqa: E402
from repro_torch.configs import catalog  # noqa: E402
from repro_torch.core import policy as P  # noqa: E402
from repro_torch.core import stream as S  # noqa: E402
from repro_torch.core import des as DES  # noqa: E402
from repro_torch.core import xdes  # noqa: E402
from repro_torch.core.policy import SimConfig  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels import lm_lib  # noqa: E402
from repro_torch.kernels import lock_sim as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import mamba_scan as K7  # noqa: E402
from repro_torch.kernels import rmsnorm as K8  # noqa: E402
from repro_torch.kernels import rwkv6_scan as K6  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    LIMIT as FLASH_LIMIT, bf16_ulp, excess as flash_excess, tensor_core_path)
from repro_torch.kernels.flash_attention import \
    flash_attention as LMA  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as LMM  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as LMN  # noqa: E402
from repro_torch.kernels.rwkv6_scan import \
    rwkv6_scan as LMW  # noqa: E402

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
#: Single f32 / i32 lane operations a second outside the tensor cores: 128
#: lanes a clock per SM x 132 SMs x 1.98 GHz.  The simulator kernels issue
#: no FMA (-fmad=false), so their operations run at this rate, half the
#: data sheet's 67 TFLOP/s, which counts an FMA as two.
SIMT_LANE_OPS_PER_S = 128 * 132 * 1.98e9
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


class SweepCalls:
    """While entered, records every outermost ``simulate_batch`` and
    ``sweep_stream`` call the grids make: its result (per-config steps;
    a stream's wins, chunks and quarantine), its seconds on the host clock
    between two ``torch.cuda.synchronize()``, and the K1 / K1-open
    launches it made.  The grids' result dicts summarize these away."""

    def __enter__(self):
        self.calls, self._real = [], (xdes.simulate_batch, S.sweep_stream)
        depth = [0]

        def watched(fn):
            def run(*a, **k):
                outer = depth[0] == 0
                if outer:
                    torch.cuda.synchronize()
                    l0 = (K.lock_sim_block.launches,
                          K.lock_sim_block.open_launches)
                    t0 = time.perf_counter()
                depth[0] += 1
                try:
                    res = fn(*a, **k)
                finally:
                    depth[0] -= 1
                if outer:
                    torch.cuda.synchronize()
                    self.calls.append({
                        "result": res,
                        "seconds": time.perf_counter() - t0,
                        "launches": K.lock_sim_block.launches - l0[0],
                        "open_launches":
                            K.lock_sim_block.open_launches - l0[1]})
                return res
            return run

        xdes.simulate_batch = watched(self._real[0])
        S.sweep_stream = watched(self._real[1])
        return self

    def __exit__(self, *exc):
        xdes.simulate_batch, S.sweep_stream = self._real


def run_writer(name, argv, out_dir):
    """One diagram writer's ``main`` on the card (its tables to stdout
    kept out of this script's output): (result, seconds on the host
    clock ending in ``synchronize``, launches, open launches, the
    recorded calls), the launch counts set to 0 just before."""
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    torch.cuda.synchronize()
    K.lock_sim_block.launches = K.lock_sim_block.open_launches = 0
    with SweepCalls() as rec, contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        result = mod.main(argv + ["--out",
                                  os.path.join(out_dir, f"{name}.json")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return (result, seconds, K.lock_sim_block.launches,
            K.lock_sim_block.open_launches, rec.calls)


def call_summary(calls):
    """Launches, chunks and config-steps of recorded sweep calls."""
    steps = sum(int(c["result"].steps_run.astype(np.int64).sum())
                for c in calls)
    return {"launches": sum(c["launches"] + c["open_launches"]
                            for c in calls),
            "chunks": sum(getattr(c["result"], "n_chunks", 1)
                          for c in calls),
            "config_steps": steps,
            "sweep_seconds": sum(c["seconds"] for c in calls)}


def check_diagram(name, result, launches, open_launches, calls, out_dir,
                  configs=None, streamed=False):
    """The checks of one writer's run (at ``configs``, default its
    one-device size); returns its phase cells' winners."""
    stem, axes = DIAGRAMS[name]
    meta, phase = result["meta"], result["phase"]
    where = f"diagrams {name}" + (" streamed" if streamed else "")
    opened = name == "arrival_diagram"
    if (open_launches <= 0 or launches != 0) if opened else \
            (launches <= 0 or open_launches != 0):
        fail(f"{where}: {launches} closed / {open_launches} open launches")
    if meta["n_configs"] != (configs or DIAGRAM_CONFIGS[name]) or \
            meta["streamed"] is not streamed or len(calls) != 1:
        fail(f"{where}: {meta['n_configs']} configs, streamed "
             f"{meta['streamed']}, {len(calls)} sweep calls")
    for call in calls:
        call["result"].validate(where)
        if getattr(call["result"], "failures", None):
            fail(f"{where}: quarantined {call['result'].failures[:3]}")
    if sum(c["n"] for c in phase) != meta["n_configs"] // meta["n_variants"]:
        fail(f"{where}: the cells' wins miss a reduction group")
    per_row = {}
    for c in phase:
        row = tuple(c[a] for a in axes if a not in ("cs", "sub", "wake"))
        per_row[row] = per_row.get(row, 0) + c["n"]
    if set(per_row.values()) != {meta["n_scenarios"]}:
        fail(f"{where}: wins per row {per_row}, not "
             f"{meta['n_scenarios']} each")
    with open(os.path.join(out_dir, stem + ".csv")) as f:
        rows = f.read().count("\n")
    if rows != 1 + len(phase):
        fail(f"{where}: {rows} CSV lines for {len(phase)} cells")
    if os.path.getsize(os.path.join(out_dir, stem + ".md")) == 0:
        fail(f"{where}: empty Markdown report")
    key = lambda c: "/".join(str(c[a]) for a in axes)
    winners = {key(c): c["winner"] for c in phase}
    if opened:
        winners = {"throughput": winners,
                   "p95": {key(c): c["lat_winner"] for c in phase}}
    return winners


def phase_diagrams():
    """The sweep layer on the card: the six writers' CLIs at the
    reference's one-device defaults (the discipline writer with its
    ``--refine`` lattice), then the fault grid at 100 050 configs
    streamed with the phase cells' wins on the card."""
    t_phase = time.perf_counter()
    grids = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name in DIAGRAMS:
            argv = ["--refine"] if name == "discipline_diagram" else []
            result, seconds, launches, open_launches, calls = run_writer(
                name, argv, out_dir)
            # the discipline writer's later calls are its refine passes
            grid_calls = calls[:1] if name == "discipline_diagram" else calls
            winners = check_diagram(name, result, launches - sum(
                c["launches"] for c in calls[1:]), open_launches,
                grid_calls, out_dir)
            rec = {"configs": result["meta"]["n_configs"],
                   "n_steps": result["meta"]["n_steps"],
                   "seconds": seconds, **call_summary(grid_calls)}
            rec["config_steps_per_s"] = (rec["config_steps"]
                                         / rec["sweep_seconds"])
            rec["winners"] = winners
            grids[name] = rec
            if name == "discipline_diagram":
                grids["refine"] = refine_record(result["refine"], calls[1:])

        # (b) the fault grid at 100 050 configs, streamed
        t0 = time.perf_counter()
        cols = catalog.lock_fault_columns(n_scenarios=FAULT_STREAM_SCENARIOS)
        arrs = P.encode_columns(cols)
        arrs["dt"], _ = xdes.plan_schedule_columns(cols, 150)
        host_seconds = time.perf_counter() - t0    # what the sweep repeats
        torch.cuda.reset_peak_memory_stats()
        result, seconds, launches, open_launches, calls = run_writer(
            "fault_diagram", ["--scenarios", str(FAULT_STREAM_SCENARIOS),
                              "--stream", "on"], out_dir)
        peak = torch.cuda.max_memory_allocated()
        C = len(cols["lock"])
        winners = check_diagram("fault_diagram", result, launches,
                                open_launches, calls, out_dir,
                                configs=100_050, streamed=True)
        # the on-card wins against the host fold of this run's own
        # per-config completed / t_end, in the card's f32 arithmetic
        res, V = calls[0]["result"], result["meta"]["n_variants"]
        feats = B._scenario_feats(catalog.sample_scenario_columns(
            FAULT_STREAM_SCENARIOS))
        uniq, cell_ids = B._phase_cells(
            [(fl, ft["cs"], ft["sub"]) for ft in feats
             for fl in catalog.LOCK_FAULTS])
        thr = res.completed.astype(np.float32) / np.maximum(
            res.t_end, np.float32(1e-30))
        host = B._host_wins(thr, len(uniq), cell_ids, V)
        if not np.array_equal(res.wins, host):
            fail(f"diagrams fault streamed: on-card wins differ from the "
                 f"host fold in {int((res.wins != host).sum())} entries")
        rec = {"configs": C, "n_steps": result["meta"]["n_steps"],
               "seconds": seconds, **call_summary(calls),
               "chunk_size": res.chunk_size, "budget_mb": res.budget_mb,
               "peak_bytes": peak, "host_plan_encode_seconds": host_seconds,
               "wins_equal_host_fold": True}
        rec["config_steps_per_s"] = rec["config_steps"] / rec["sweep_seconds"]
        rec["winners"] = winners
        grids["fault_streamed"] = rec
    emit({"phase": "diagrams", "seconds": time.perf_counter() - t_phase,
          "target_cs": 150, "grids": grids})
    opened = grids["arrival_diagram"]["launches"]
    return sum(g["launches"] for g in grids.values()) - opened, opened


def refine_record(refine, calls):
    """The refine lattice's passes: each pass's wins hold every point of
    that pass once."""
    meta = refine["meta"]
    points = [meta["n_coarse"]] + ([meta["n_dense"]] if meta["n_dense"]
                                   else [])
    if len(calls) != len(points):
        fail(f"diagrams refine: {len(calls)} passes for {points} points")
    for call, n in zip(calls, points):
        call["result"].validate("diagrams refine")
        if call["result"].failures:
            fail(f"diagrams refine: quarantined "
                 f"{call['result'].failures[:3]}")
        if int(call["result"].wins.sum()) != n or \
                call["result"].wins.shape[0] != n:
            fail(f"diagrams refine: {int(call['result'].wins.sum())} wins "
                 f"for {n} points")
        if call["launches"] <= 0 or call["open_launches"] != 0:
            fail(f"diagrams refine: {call['launches']} launches")
    rec = {"configs": meta["n_configs"], "coarse_points": meta["n_coarse"],
           "dense_points": meta["n_dense"],
           "dense_dropped": meta["n_dense_dropped"], **call_summary(calls)}
    rec["config_steps_per_s"] = rec["config_steps"] / rec["sweep_seconds"]
    return rec

# --------------------------------------------------------------------------
# phase 13: the paper's figures on the port
# --------------------------------------------------------------------------
def launch_counts():
    """(closed, open) launches of ``lock_sim_block`` since the last reset."""
    return K.lock_sim_block.launches, K.lock_sim_block.open_launches


def reset_launches():
    torch.cuda.synchronize()
    K.lock_sim_block.launches = K.lock_sim_block.open_launches = 0


def band_families():
    """The reference's xdes-against-DES band tests, each with its own
    cells, seeds, target_cs, ``n_steps`` and ``dt``, as ``{family:
    (configs, simulate_batch keywords, cells)}``.  A cell is ``(label,
    the config rows its xdes side averages, the keywords of the DES runs
    its DES side averages)``; the open family's DES runs are ``LockSim``
    keywords, run to the xdes horizon."""
    SHORT, LONG, WAKE = catalog.LOCK_SHORT, catalog.LOCK_LONG, \
        catalog.LOCK_WAKE
    fams = {}

    # tests/test_xdes.py::test_agrees_with_event_driven_des_on_trends
    locks = ("ttas", "mcs", "sleep", "adaptive", "mutable")
    regimes = {"ss": (SHORT, SHORT), "ls": (LONG, SHORT),
               "sl": (SHORT, LONG)}
    keys = [(reg, lock, tc) for reg in regimes for lock in locks
            for tc in (4, 20)]
    cfgs = [SimConfig(lock, threads=tc, cores=20, cs=regimes[reg][0],
                      ncs=regimes[reg][1], wake_latency=WAKE, seed=0)
            for reg, lock, tc in keys]
    fams["xdes_trends"] = (cfgs, {"target_cs": 120}, [
        (f"{reg}/{lock}/{tc}", [keys.index((reg, lock, tc))],
         [dict(lock=lock, threads=tc, cores=20, cs=regimes[reg][0],
               ncs=regimes[reg][1], wake_latency=WAKE, target_cs=800,
               seed=0)])
        for reg, lock, tc in (("ss", "ttas", 20), ("ss", "sleep", 20),
                              ("ls", "mutable", 20))])

    # tests/test_disciplines.py::test_fifo_des_model_is_fifo_and_parity_...
    cfgs = [SimConfig("fifo", threads=tc, cores=20, cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=0) for tc in (4, 20)]
    fams["fifo"] = (cfgs, {"target_cs": 150}, [
        (f"fifo/{tc}", [i], [dict(lock="fifo", threads=tc, cores=20,
                                  cs=SHORT, ncs=SHORT, wake_latency=WAKE,
                                  target_cs=800, seed=0)])
        for i, tc in enumerate((4, 20))])

    # tests/test_disciplines.py::test_new_rows_des_parity_seed_averaged
    seeds = (0, 1, 2)
    points = [(lock, tc, pc) for lock in ("fissile", "hapax", "ttas_backoff")
              for tc, pc in ((4, 1.0), (12, 1.0), (12, 8.0))]
    cfgs = [SimConfig(lock, threads=tc, cores=8, cs=SHORT, ncs=SHORT,
                      wake_latency=WAKE, seed=s, park_cost=pc)
            for lock, tc, pc in points for s in seeds]
    fams["new_rows"] = (cfgs, {"target_cs": 150}, [
        (f"{lock}/{tc}/park{pc:g}", [i * 3 + j for j in range(3)],
         [dict(lock=lock, threads=tc, cores=8, cs=SHORT, ncs=SHORT,
               wake_latency=WAKE, target_cs=400, seed=s, park_cost=pc)
          for s in seeds])
        for i, (lock, tc, pc) in enumerate(points)])

    # tests/test_workloads.py::test_xdes_vs_des_parity_per_row
    cfgs, cells = [], []
    for w in ("constant", "bursty", "hetero", "jitter"):
        rng = np.random.default_rng(P.WORKLOAD_IDS[w])
        for lock in ("ttas", "mutable", "sleep"):
            tc, cores = int(rng.integers(4, 13)), int(rng.integers(4, 13))
            rows = list(range(len(cfgs), len(cfgs) + 3))
            cfgs += [SimConfig(lock, threads=tc, cores=cores, cs=SHORT,
                               ncs=SHORT, wake_latency=WAKE, seed=s,
                               workload=w, wl_period=8e-5) for s in seeds]
            cells.append((f"{w}/{lock}/{tc}t{cores}c", rows, [
                dict(lock=lock, threads=tc, cores=cores, cs=SHORT,
                     ncs=SHORT, wake_latency=WAKE, target_cs=800, seed=s,
                     **cfgs[rows[0]].workload_kwargs()) for s in seeds]))
    fams["workload"] = (cfgs, {"target_cs": 150}, cells)

    # tests/test_faults.py::test_xdes_vs_des_parity_per_row
    f_cs, f_ncs, f_wake, scale = (1e-6, 2e-6), (2e-6, 4e-6), 5e-6, 1e-5
    rates = {"none": 0.0, "preempt": 0.6, "oversub": 0.6, "lostwake": 0.5,
             "jitter": 0.5}
    cfgs, cells = [], []
    for fault, rate in rates.items():
        for lock in ("ttas", "sleep", "mutable"):
            rows = list(range(len(cfgs), len(cfgs) + 4))
            cfgs += [SimConfig(lock, threads=8, cores=4, cs=f_cs, ncs=f_ncs,
                               wake_latency=f_wake, seed=s, fault=fault,
                               fault_rate=rate, fault_scale=scale)
                     for s in range(4)]
            cells.append((f"{fault}/{lock}", rows, [
                dict(lock=lock, threads=8, cores=4, cs=f_cs, ncs=f_ncs,
                     wake_latency=f_wake, target_cs=800, seed=s,
                     **cfgs[rows[0]].fault_kwargs()) for s in range(4)]))
    fams["fault"] = (cfgs, {"target_cs": 150}, cells)

    # tests/test_open_loop.py::test_xdes_vs_des_open_loop_parity
    cfgs, cells = [], []
    for arrival in ("poisson", "bursty"):
        rows = list(range(len(cfgs), len(cfgs) + 3))
        cfgs += [SimConfig("ttas", threads=4, cores=4, cs=SHORT, ncs=SHORT,
                           wake_latency=WAKE, seed=s, arrival=arrival,
                           arrival_rate=2e5, wl_period=4e-4, wl_burst=4.0)
                 for s in seeds]
        cells.append((arrival, rows, [
            dict(lock="ttas", threads=4, cores=4, cs=SHORT, ncs=SHORT,
                 wake_latency=WAKE, seed=s, wl_period=4e-4, wl_burst=4.0,
                 **cfgs[rows[0]].arrival_kwargs()) for s in seeds]))
    fams["open_loop"] = (cfgs, {"n_steps": 40_000, "dt": 5e-8}, cells)
    return fams


def run_band_family(name, cfgs, kw, cells):
    """One family: one ``simulate_batch`` through the kernel, then the
    DES runs of each cell on the host; every seed-averaged ratio must lie
    in ``DES_BAND``."""
    opened = name == "open_loop"
    reset_launches()
    t0 = time.perf_counter()
    res = xdes.simulate_batch(cfgs, backend="kernel", **kw).validate(
        f"des_bands {name}")
    torch.cuda.synchronize()
    x_seconds = time.perf_counter() - t0
    launches, open_launches = launch_counts()
    if (open_launches <= 0 or launches != 0) if opened else \
            (launches <= 0 or open_launches != 0):
        fail(f"des_bands {name}: {launches} closed / {open_launches} open "
             f"launches")
    t0 = time.perf_counter()
    ratios = {}
    for label, rows, des_runs in cells:
        if opened:
            t_end = float(res.t_end[rows[0]])
            x_thr = float(np.asarray(res.departed)[rows].mean()) / t_end
            x_lat = float(np.nanmean(np.asarray(res.mean_latency)[rows]))
            d_thr, d_lat = [], []
            for des_kw in des_runs:
                r = DES.LockSim(**des_kw).run(target_cs=10**9,
                                              horizon=t_end)
                if len(r.latencies) <= 50:
                    fail(f"des_bands {name} {label}: {len(r.latencies)} "
                         f"DES departures")
                d_thr.append(len(r.latencies) / t_end)
                d_lat.append(r.mean_latency)
            ratios[label] = {"throughput": x_thr / float(np.mean(d_thr)),
                             "mean_sojourn": x_lat / float(np.mean(d_lat))}
        else:
            x = float(res.throughput[rows].mean())
            d = float(np.mean([DES.simulate(**des_kw).throughput
                               for des_kw in des_runs]))
            ratios[label] = {"throughput": x / d}
    out = {"configs": len(cfgs), "n_steps": res.n_steps,
           "steps_run": int(res.steps_run.max()),
           "launches": launches, "open_launches": open_launches,
           "xdes_seconds": x_seconds,
           "des_seconds": time.perf_counter() - t0, "ratios": ratios}
    bad = {k: v for k, v in ratios.items()
           if not all(DES_BAND[0] < r < DES_BAND[1] for r in v.values())}
    if bad:
        fail(f"des_bands {name}: outside {DES_BAND}: {bad}")
    return out


def fig3_side(f3, engine):
    """Claims C2-C4 and the ratio_to_opt of mutable and pt-exp of one
    engine's Fig. 3 grid; fails unless every claim holds."""
    claims = B._check_claims(f3)
    if not (claims["C2"] and claims["C3"] and claims["C4"]):
        fail(f"paper_figures fig3 ({engine}): claims {claims}")
    return {"claims": claims,
            "ratio_to_opt": {reg: {k: f3[reg]["summary"][k]["ratio_to_opt"]
                                   for k in ("mutable", "pt-exp")}
                             for reg in LB.REGIMES}}


def phase_paper_figures():
    """The paper's own artifacts on the port: Fig. 1 on the DES, Fig. 3 on
    both engines (xdes through K1 on the card, the DES on the host), the
    reference's xdes-against-DES band families, the dt-fidelity study and
    the serving-window benchmark; returns the phase's (closed, open)
    launches."""
    t_phase = time.perf_counter()

    # Fig. 1 (C1)
    f1 = LB.fig1(verbose=False)
    if not (f1["ttas"]["makespan_slots"] < 3.5
            and 4.5 < f1["sleep"]["makespan_slots"] < 5.5
            and f1["mutable"]["makespan_slots"] < 3.5
            and f1["mutable"]["spin_waste_slots"]
            < f1["ttas"]["spin_waste_slots"]
            and f1["mutable"]["wakes"] <= f1["sleep"]["wakes"]):
        fail(f"paper_figures fig1: C1 fails: {f1}")

    # Fig. 3 on both engines (C2-C4)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        f3x = LB.fig3(target_cs=PAPER_XDES_TARGET_CS, seeds=(0, 1),
                      engine="xdes", verbose=False)
    torch.cuda.synchronize()
    x_seconds = time.perf_counter() - t0
    x_launches = launch_counts()[0]
    if x_launches <= 0:
        fail("paper_figures fig3: the xdes grid launched no K1")
    t0 = time.perf_counter()
    f3d = LB.fig3(target_cs=PAPER_DES_TARGET_CS, seeds=(0, 1),
                  engine="des", verbose=False)
    d_seconds = time.perf_counter() - t0
    ratio = {reg: [f3x[reg]["rows"][lock][i]["throughput"]
                   / f3d[reg]["rows"][lock][i]["throughput"]
                   for lock in LB.LOCKS for i in range(len(LB.THREADS))]
             for reg in LB.REGIMES}
    spread = lambda r: {"min": min(r), "median": float(np.median(r)),
                        "max": max(r)}
    cells = [r for rs in ratio.values() for r in rs]
    fig3 = {"xdes": {"target_cs": PAPER_XDES_TARGET_CS, "seeds": [0, 1],
                     "seconds": x_seconds, "launches": x_launches,
                     **fig3_side(f3x, "xdes")},
            "des": {"target_cs": PAPER_DES_TARGET_CS, "seeds": [0, 1],
                    "seconds": d_seconds, **fig3_side(f3d, "des")},
            "cells": len(cells),
            "xdes_over_des_throughput": {
                **spread(cells),
                "by_regime": {reg: spread(r) for reg, r in ratio.items()}}}

    # the reference's band families, the port's engine against its DES
    bands = {}
    for name, (cfgs, kw, cells) in band_families().items():
        bands[name] = run_band_family(name, cfgs, kw, cells)

    # the dt-fidelity study at its defaults
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        study = FS.run_study(verbose=False)
    torch.cuda.synchronize()
    f_seconds = time.perf_counter() - t0
    f_launches = launch_counts()[0]
    band = study["throughput_err_band_by_dt"]
    by_dt = [band[f"{dt:g}"] for dt in FS.DTS]          # dt ascending
    fine = [band[f"{dt:g}"] for dt in FS.DTS if dt <= 3e-7]
    if f_launches <= 0 or not all(np.isfinite(v) for v in by_dt) or \
            not all(np.isfinite([g["throughput_rel_err"],
                                 g["spin_cpu_rel_err"]]).all()
                    for g in study["grid"]) or max(fine) > FIDELITY_LIMIT:
        fail(f"paper_figures fidelity: band {band}, {f_launches} launches")
    fidelity = {"throughput_err_band_by_dt": band,
                "band_shrinks_as_dt_drops": all(
                    a <= b for a, b in zip(by_dt, by_dt[1:])),
                "des_wall_s": study["meta"]["des_wall_s"],
                "xdes_wall_s": study["meta"]["xdes_wall_s"],
                "seconds": f_seconds, "configs": study["meta"]["n_configs"],
                "launches": f_launches}

    # the serving window: C6 on the step-level engine, then through xdes
    runs = {p: SB.run_policy(p, n_requests=SCHED_REQUESTS)
            for p in ("zero", "max", "mutable")}
    zero, mx, mut = runs["zero"], runs["max"], runs["mutable"]
    if not (mut["late_handoff_rate"] <= mx["late_handoff_rate"] * 1.1
            and mut["late_handoff_rate"] < zero["late_handoff_rate"]
            and mut["avg_standby"] < mx["avg_standby"]):
        fail(f"paper_figures sched: C6 fails: {runs}")
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sweep = SB.xdes_sweep(SCHED_SCENARIOS)
    torch.cuda.synchronize()
    s_seconds = time.perf_counter() - t0
    s_launches = launch_counts()[0]
    if s_launches <= 0:
        fail("paper_figures sched: the xdes sweep launched no K1")
    sched = {"requests": SCHED_REQUESTS,
             "late_handoff_rate": {p: r["late_handoff_rate"]
                                   for p, r in runs.items()},
             "avg_standby": {p: r["avg_standby"] for p, r in runs.items()},
             "xdes": {"scenarios": SCHED_SCENARIOS, "seconds": s_seconds,
                      "launches": s_launches,
                      "mean_ratio_to_best": {
                          p: v["mean_ratio_to_best"]
                          for p, v in sweep["policies"].items()}}}

    launches = (x_launches + f_launches + s_launches
                + sum(b["launches"] for b in bands.values()),
                sum(b["open_launches"] for b in bands.values()))
    emit({"phase": "paper_figures",
          "seconds": time.perf_counter() - t_phase, "fig1": f1,
          "fig3": fig3, "des_bands": bands, "fidelity": fidelity,
          "sched": sched, "launches": launches[0],
          "open_launches": launches[1]})
    return launches


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


def roofline(n_bytes, ops, ops_per_s=FP32_OPS_PER_S):
    """The least time of a launch: ``n_bytes`` over the memory rate against
    ``ops`` over ``ops_per_s`` (default the float32 rate), the larger
    wins."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
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


#: Warps per SM at which ``rows_per_sm_ms`` times the block kernel: C = SMs
#: x w rows, one warp a row, w a multiple of the block's 4 warps.
ROWS_PER_SM_WARPS = (4, 8, 12, 16, 20, 24, 32, 40)


def rows_per_sm_ms(state, args, step0, n_steps, open_loop):
    """The block kernel's device ms at C = SMs x w rows for each w of
    ``ROWS_PER_SM_WARPS``: the first C rows of the timing shape's state and
    columns, the same 32 sub-steps from ``step0``.  Flat up to the
    occupancy limit: each warp's chain of dependent instructions sets the
    time (latency-bound); growing from small w: the SM's issue slots do
    (issue-bound).  Points past the limit run a second wave."""
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    n = len(ref.BLOCK_STATE)
    out = {}
    for w in ROWS_PER_SM_WARPS:
        C = sms * w
        cut = lambda ts: [t[:C].contiguous() if isinstance(t, torch.Tensor)
                          and t.ndim >= 1 else t for t in ts]
        st, ar = cut(state), cut(args)
        out[str(w)] = median_ms(
            lambda: K.lock_sim_block(
                *st[:n], step0, *ar, n_sub_steps=xdes.DEFAULT_BLOCK_STEPS,
                limit=n_steps, ids_checked=True,
                open_state=st[n:] if open_loop else None), 20,
            hide_host=True)
    return out


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
        live_steps * (active * ops_per_thread_step + C * ops_per_row_step),
        SIMT_LANE_OPS_PER_S))
    out["block"]["rows_per_sm_ms"] = rows_per_sm_ms(state, args, warm,
                                                    n_steps, open_loop)

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
            active * OPS_PER_THREAD_ADVANCE, SIMT_LANE_OPS_PER_S))
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
        + C * ops_per_row_step, SIMT_LANE_OPS_PER_S))
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
                       ORACLE_CONFIGS * OPS_PER_ROW_ORACLE,
                       SIMT_LANE_OPS_PER_S)}


# --------------------------------------------------------------------------
# The language model's serving path: K5 flash_attention, K8 rmsnorm
# --------------------------------------------------------------------------
#: Dense bf16 tensor-core peak of the H100 SXM (data sheet, 700 W): the
#: floor of K5's products, whatever pipe the kernel uses.
BF16_TENSOR_OPS_PER_S = 989e12
FLASH_HDS = (16, 64, 80, 128, 256)
FLASH_SEQS = (1, 77, 1024, 2048)
#: Query heads per KV head: MHA, llama3.2-1b's 4, jamba's 8.
FLASH_GROUPS = (1, 4, 8)
#: K8's (rows, D): odd ones, llama3.2-1b's at decode (4 slots) and
#: prefill, and jamba's: D 8192 for its layer norms, 16384 for the norm
#: inside each mamba mixer, at decode and at a 1024-token prefill.  Then
#: both sides of each switch of the launcher's threads a row
#: (``csrc/rmsnorm.cu:plan_tpr``, on 132 SMs of 2048 threads): at D 2048
#: (256 vectors a row in bf16) 256 threads a row up to 528 rows, 128 up
#: to 1056, 64 up to 2112, then 32; D 16 384 / 16 392 (2048 / 2049 bf16
#: vectors: 256 / 512 threads, eight vectors a thread; in f32 4096 / 4098
#: vectors: 512 threads, and the kernel's loop over the vectors past 8 a
#: thread); D 32 768 / 32 776 (the same in bf16).
RMS_SHAPES = ((1, 64), (7, 80), (4, 2048), (4096, 2048), (3, 8192),
              (4, 16384), (1024, 16384), (528, 2048), (529, 2048),
              (1056, 2048), (1057, 2048), (2112, 2048), (2113, 2048),
              (2, 16392), (3, 32768), (3, 32776))
LM_VS_PLAIN_PROMPT = 300
LM_VS_PLAIN_STEPS = 8
SERVE_ARGV = ["--arch", "llama3.2-1b", "--requests", "16", "--slots", "4",
              "--max-seq", "2048", "--max-new", "32", "--prompt-min", "128",
              "--prompt-max", "1025", "--policy", "mutable", "--seed", "0"]
RWKV6_BHS = (1, 32, 128)
RWKV6_TS = (1, 7, 64, 65, 1024, 2048)
RWKV6_CHUNKS = (1, 16, 64, 128)
#: Rows of each larger case that K6 also runs alone: few enough that the
#: launcher splits a head over more CTAs than in the batch.
RWKV6_ROWS_ALONE = 8
#: B*H at which ``bh_ms`` times K6 at T 1024: one row alone up to two rows
#: an SM.  Within one split (``bh_ctas_per_head``), flat while the grid
#: fits the SMs: one CTA's chain sets the time; past them it grows with
#: the CTAs an SM takes in turn.
RWKV6_BH_MS = (1, 8, 32, 66, 132, 264)
#: K6 against its plain version: max|d| of y and of S_T each at most this
#: times max(1, max|plain|).  The sums of a step run in another order
#: (16 row segments added by a tree, the bonus apart, FMAs), and the state
#: carries each step's rounding into the next.
RWKV6_LIMIT = 1e-5
MAMBA_BS = (1, 2)
MAMBA_TS = (1, 7, 64, 65, 1024)
#: d 50 is not a multiple of 4: the kernel stages dt and x by 4-byte copies.
MAMBA_DS = (48, 50, 128, 16384)
MAMBA_NS = (4, 8, 16)
MAMBA_CHUNKS = (1, 16, 64, 128)
#: Channels of each larger case that K7 also runs alone: few enough that
#: the launcher gives a lane fewer channels than in the batch
#: (``csrc/mamba_scan.cu:plan_split``).
MAMBA_CHANNELS_ALONE = 128
#: d at which ``d_ms`` times K7 (B 1, T 1024, N 16): one block, a quarter
#: of the card, a jamba prefill layer, then about 2 and 4 times the
#: blocks the card holds at once.  Flat while the grid fits the SMs: one
#: block's chain sets the time; past them it grows with the work an SM
#: takes.
MAMBA_D_MS = (128, 4096, 16384, 33792, 67584)
#: K7 against its plain version: max|d| of y and of s_T each at most this
#: times max(1, max|plain|), K6's limit.  The kernel's exp is one ex2 of dt
#: times a * log2(e) (the scaled a rounded once to f32, the hardware ex2
#: within 2 ulps, subnormal results flushed to 0) where the plain version
#: takes expf(dt * a); the state update is an FMA, and the y sum runs in
#: another order (a tree over pairs of states).  The decay keeps each
#: step's rounding from growing.
MAMBA_LIMIT = 1e-5
#: Special-function-unit rate of the H100 SXM: 16 exp2 results a clock per
#: SM (CUDA C++ Programming Guide, arithmetic instruction throughput,
#: compute capability 9.0) x 132 SMs x 1.98 GHz, the boost clock behind the
#: data sheet's 67 TFLOP/s f32.  Each expf issues one.
SFU_EXPS_PER_S = 16 * 132 * 1.98e9
#: jamba-1.5-large at full width: the first JAMBA_LAYERS layers of its
#: period (4 mamba, 1 attention; 2 MoE and 3 dense FFNs) serve on the card.
JAMBA = "jamba-1.5-large-398b"
JAMBA_LAYERS = 5
#: jamba_lm_vs_plain: the card's scan outputs and states against the CPU's,
#: as max|d| over max|CPU| (the upstream activations already differ by f32
#: rounding), and the least max|CPU| that makes that comparison hold
#: anything: the states of this init lie near 5e-4 and y near 5e-5.
JAMBA_SCAN_LIMIT = 1e-3
JAMBA_SCAN_FLOOR = 1e-6
#: Router-probability gap under which the card and the CPU may route a
#: token to different experts in f32.
MOE_MARGIN = 1e-5


def flash_cases():
    """(dtype, hd, Sq, Sk, BH, group, causal, window, softcap): the matrix
    dtype x hd x Sq = Sk x group x causal x window x softcap on 8 query
    heads, then Sq != Sk (300 queries against 1024 keys) over the mask
    options, then jamba's attention layer as it serves (64 query heads on
    8 KV heads, hd 128, causal, no window, no softcap)."""
    masks = [(c, w, s) for c in (True, False) for w in (0, 64)
             for s in (0.0, 30.0)]
    for dtype in FLASH_LIMIT:
        for hd in FLASH_HDS:
            for S in FLASH_SEQS:
                for group in FLASH_GROUPS:
                    for m in masks:
                        yield (dtype, hd, S, S, 8, group, *m)
        for group in FLASH_GROUPS:
            for m in masks:
                yield (dtype, 64, 300, 1024, 8, group, *m)
        for S in FLASH_SEQS:
            yield (dtype, 128, S, S, 64, 8, True, 0, 0.0)


def phase_flash_attention_vs_plain():
    """K5 against flash_attention_ref, both on the card, traced: every bf16
    case with hd 64 or 128 must count in ``tc_launches`` and run the
    tensor-core kernel, every other case the SIMT kernel (the kernels'
    names in the trace)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    worst = {str(d).split(".")[1]: 0.0 for d in FLASH_LIMIT}
    excess = dict(worst)
    n = n_tc = 0
    before, tc_before = LMA.launches, LMA.tc_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for dtype, hd, Sq, Sk, BH, group, causal, window, softcap in \
                flash_cases():
            q = torch.randn((BH, Sq, hd), generator=gen,
                            device=DEV).to(dtype)
            k, v = (torch.randn((BH // group, Sk, hd), generator=gen,
                                device=DEV).to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap)
            tc = LMA.tc_launches
            got = LMA(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            where = (f"flash_attention {dtype} hd={hd} Sq={Sq} Sk={Sk} "
                     f"BH={BH} group={group} {kw}")
            if LMA.tc_launches - tc != tensor_core_path(dtype, hd):
                fail(f"{where}: {LMA.tc_launches - tc} tensor-core "
                     f"launches")
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
            n_tc += tensor_core_path(dtype, hd)
        torch.cuda.synchronize()
    # the device's own account of which kernel each launch ran
    ran = {"tensor_core": 0, "simt": 0}
    for e in prof.key_averages():
        if "flash_attention_kernel_sm90" in e.key:
            ran["tensor_core"] += e.count
        elif "flash_attention_kernel" in e.key:
            ran["simt"] += e.count
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
    tc_launches = LMA.tc_launches - tc_before
    if (launches != n or tc_launches != n_tc
            or ran != {"tensor_core": n_tc, "simt": n - n_tc}):
        fail(f"flash_attention: {launches} launches ({tc_launches} "
             f"tensor-core; the trace: {ran}) for {n} cases ({n_tc} bf16 "
             f"with hd 64 or 128)")
    emit({"phase": "flash_attention_vs_plain", "cases": n,
          "tensor_core_cases": n_tc, "kernels_traced": ran,
          "max_abs_err": worst, "limit": {str(d).split(".")[1]: l
                                          for d, l in FLASH_LIMIT.items()},
          "bf16_limit": "min(2e-2, 2 bf16 ulps of the plain output + 2e-5)",
          "max_err_over_limit": excess,
          "refused_hd": refused, "seconds": time.perf_counter() - t0})
    return max(worst.values())


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
    the tokens fed; the engine's cache after the last step)."""
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
    return out, fed, eng.cache


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
    out, _, _ = compare_lm("lm_vs_plain", cfg, cpu_model, gpu_model)
    if out["k5_launches"] != cfg.num_layers or out["k6_launches"] != 0:
        fail(f"lm_vs_plain: {out} launches on the card")
    emit({"phase": "lm_vs_plain", "arch": "llama3.2-1b", **out,
          "seconds": time.perf_counter() - t0})


def compare_lm(phase, cfg, cpu_model, gpu_model):
    """A ``LM_VS_PLAIN_PROMPT``-token prefill and ``LM_VS_PLAIN_STEPS``
    decode steps of ``cfg`` on the CPU and on the card, the card fed the
    CPU's greedy tokens: logits within 1e-3, greedy tokens equal where the
    CPU's top-2 margin exceeds 1e-2, K8 launched :func:`k8_per_forward`
    times a forward, K7 once per mamba layer in the prefill and every K5
    launch on the tensor cores where :func:`tc_attention` says so.  Returns
    what it read and the last caches of the CPU and the card."""
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(2, cfg.vocab_size - 1,
                                           LM_VS_PLAIN_PROMPT)]
    cpu, forced, cpu_cache = lm_run(cfg, cpu_model, "cpu", prompt,
                                    LM_VS_PLAIN_STEPS)
    k5, k5_tc, k6, k7, k8 = (LMA.launches, LMA.tc_launches, LMW.launches,
                             LMM.launches, LMN.launches)
    gpu, _, gpu_cache = lm_run(cfg, gpu_model, DEV, prompt,
                               LM_VS_PLAIN_STEPS, forced)
    k5, k5_tc, k6, k7, k8 = (LMA.launches - k5, LMA.tc_launches - k5_tc,
                             LMW.launches - k6, LMM.launches - k7,
                             LMN.launches - k8)
    if (k8 != k8_per_forward(cfg) * (LM_VS_PLAIN_STEPS + 1)
            or k7 != mixer_counts(cfg)["mamba"]
            or k5_tc != (k5 if tc_attention(cfg) else 0)):
        fail(f"{phase}: {k5_tc} of {k5} K5 on the tensor cores / {k7} K7 / "
             f"{k8} K8 launches on the card")
    worst, clear, agree = 0.0, 0, 0
    for i, (c, g) in enumerate(zip(cpu, gpu)):
        if not torch.isfinite(g).all():
            fail(f"{phase}: non-finite logits at step {i}")
        worst = max(worst, float((c - g).abs().max()))
        top2 = torch.topk(c, 2).values
        if float(top2[0] - top2[1]) > 1e-2:
            clear += 1
            if int(g.argmax()) != int(c.argmax()):
                fail(f"{phase}: greedy token differs at step {i} "
                     f"(CPU margin {float(top2[0] - top2[1])})")
            agree += 1
    if not worst <= 1e-3:
        fail(f"{phase}: logits max|d| {worst} over 1e-3")
    return {"layers": cfg.num_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32",
            "prompt": LM_VS_PLAIN_PROMPT, "decode_steps": LM_VS_PLAIN_STEPS,
            "logits_max_abs_err": worst, "limit": 1e-3,
            "steps_compared": len(cpu), "steps_with_clear_margin": clear,
            "greedy_equal": agree, "k5_launches": k5,
            "k5_tc_launches": k5_tc, "k6_launches": k6,
            "k7_launches": k7, "k8_launches": k8}, cpu_cache, gpu_cache


def mixer_counts(cfg):
    """Layers per mixer kind of ``cfg``."""
    from repro_torch.models.transformer import layer_spec
    mixers = [layer_spec(cfg, l).mixer for l in range(cfg.num_layers)]
    return {m: mixers.count(m) for m in ("attention", "rwkv6", "mamba")}


def tc_attention(cfg):
    """Whether ``cfg``'s attention layers run K5 on the tensor cores."""
    return cfg.attention is not None and tensor_core_path(
        getattr(torch, cfg.dtype), cfg.attention.head_dim)


def k8_per_forward(cfg):
    """K8 launches of one forward: two norms a layer, the final norm, and
    the norm inside each mamba mixer (at d_in)."""
    return 2 * cfg.num_layers + 1 + mixer_counts(cfg)["mamba"]


def phase_serve_at_size(phase="serve_at_size", arch="llama3.2-1b",
                        layers=None):
    """Full-width ``arch`` (bf16, random weights from a seed; its first
    ``layers`` layers when given, else all) through
    ``repro_torch.launch.serve``'s code path: the mutable policy, 4 slots,
    max_seq 2048, 16 requests of 128-1024 prompt tokens, 32 new tokens
    each.  Each prefill must launch K5 once per attention layer, K6 once
    per rwkv6 layer, K7 once per mamba layer and K8 :func:`k8_per_forward`
    times, and each decode step K6 and K8 alike and K7 never."""
    from repro_torch.configs import base as CB
    from repro_torch.launch import serve
    argv = ["--arch", arch] + SERVE_ARGV[2:]
    args = serve.parse_args(argv)
    cut = None
    if layers is not None:
        full = CB.get_config(arch)
        cut = full.replace(num_layers=layers, pattern=full.pattern[:layers])
    gc.collect()                # what earlier phases left: not these peaks
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, engine = serve.build(args, cut)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    warm = serve.parse_args(argv[:2] + ["--requests", "2", "--slots", "4",
                                        "--max-new", "2", "--seed", "1"])
    serve.run(warm, cfg, engine)               # cuBLAS handles, first calls
    at_prefill = {"k6": 0, "k7": 0, "k8": 0}
    real_prefill = engine.prefill

    def prefill(prompt):
        n6, n7, n8 = LMW.launches, LMM.launches, LMN.launches
        res = real_prefill(prompt)
        at_prefill["k6"] += LMW.launches - n6
        at_prefill["k7"] += LMM.launches - n7
        at_prefill["k8"] += LMN.launches - n8
        return res

    engine.prefill = prefill
    engine.prefill_seconds.clear()
    engine.step_seconds.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted
    LMA.launches = LMA.tc_launches = 0
    LMW.launches = LMM.launches = LMN.launches = 0
    try:
        out = serve.run(args, cfg, engine)
        torch.cuda.synchronize()
    finally:
        del engine.prefill      # the class's method again, and no cycle
    k5, k6, k7, k8 = LMA.launches, LMW.launches, LMM.launches, LMN.launches
    k5_tc = LMA.tc_launches
    k6_pre, k7_pre, k8_pre = (at_prefill[k] for k in ("k6", "k7", "k8"))
    peak = torch.cuda.max_memory_allocated()
    reqs, s = out["requests"], out["summary"]
    if s["completed"] != args.requests:
        fail(f"{phase}: {s['completed']} of {args.requests} done")
    for r in reqs:
        if len(r.generated) != args.max_new or not all(
                0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"{phase}: request {r.rid} generated {r.generated}")
    prefill_ms = [t * 1e3 for t in engine.prefill_seconds]
    step_ms = [t * 1e3 for t in engine.step_seconds]
    n = mixer_counts(cfg)
    per_forward = k8_per_forward(cfg)
    if (len(prefill_ms) != args.requests
            or k5 != n["attention"] * args.requests
            or k5_tc != (k5 if tc_attention(cfg) else 0)
            or k6_pre != n["rwkv6"] * args.requests
            or k6 - k6_pre != n["rwkv6"] * len(step_ms)
            or k7_pre != n["mamba"] * args.requests or k7 != k7_pre
            or k8_pre != per_forward * args.requests
            or k8 - k8_pre != per_forward * len(step_ms)):
        fail(f"{phase}: {k5} K5 ({k5_tc} tensor-core) / {k6_pre} + "
             f"{k6 - k6_pre} K6 / {k7_pre} + "
             f"{k7 - k7_pre} K7 / {k8_pre} + {k8 - k8_pre} K8 launches for "
             f"{len(prefill_ms)} prefills and {len(step_ms)} decode steps")
    seconds = out["seconds"]
    t_trace = time.perf_counter()
    res, busy, k5_s, k6_s, k7_s, k8_s = profiled(
        lambda: serve.run(args, cfg, engine), "flash_attention_kernel",
        "rwkv6_scan_kernel", "mamba_scan_kernel", "rmsnorm_kernel")
    trace_s = time.perf_counter() - t_trace
    traced = busy > 0.0
    tokens = sum(len(r.generated) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    emit({"phase": phase, "arch": cfg.name,
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
          "k5_launches": k5, "k5_tc_launches": k5_tc, "k6_launches": k6,
          "k6_launches_prefill": k6_pre, "k6_launches_decode": k6 - k6_pre,
          "k7_launches": k7, "k7_launches_prefill": k7_pre,
          "k7_launches_decode": k7 - k7_pre,
          "k8_launches": k8, "k8_launches_prefill": k8_pre,
          "k8_launches_decode": k8 - k8_pre, "k8_per_forward": per_forward,
          "late_handoff_rate": s["late_handoff_rate"],
          "avg_standby": s["avg_standby"],
          "window_trace_tail": out["stats"].window_trace[-8:],
          "init_peak_bytes": init_peak, "peak_bytes": peak,
          "build_seconds": build_s,
          "traced_seconds": res["seconds"],
          "trace_and_read_seconds": trace_s,
          "device_busy_seconds": busy if traced else None,
          "k5_device_seconds": k5_s if traced else None,
          "k6_device_seconds": k6_s if traced else None,
          "k7_device_seconds": k7_s if traced else None,
          "k8_device_seconds": k8_s if traced else None,
          "device_idle_share": 1.0 - busy / seconds if traced else None,
          "phase_seconds": time.perf_counter() - t0})
    return {"k5": k5, "k5_tc": k5_tc,
            "k6_prefill": k6_pre, "k6_decode": k6 - k6_pre,
            "k7_prefill": k7_pre, "k7_decode": k7 - k7_pre,
            "k8_prefill": k8_pre, "k8_decode": k8 - k8_pre,
            "mamba_layers": n["mamba"], "forwards_prefill": args.requests,
            "forwards_decode": len(step_ms)}


def rwkv6_inputs(gen, BH, T, n, w_range, with_s0):
    """Seeded f32 operands of K6 on the card.  ``w_range`` "model": the
    decay of an rwkv6-1.6b layer at init, exp(-exp(-6 + U(-1, 1)));
    "wide": U(0.01, 1)."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    uni = lambda *shape: torch.rand(shape, generator=gen, device=DEV)
    r, k, v = rnd(BH, T, n), rnd(BH, T, n), rnd(BH, T, n)
    if w_range == "model":
        w = torch.exp(-torch.exp(-6.0 + 2.0 * uni(BH, T, n) - 1.0))
    else:
        w = 0.01 + 0.99 * uni(BH, T, n)
    u = 0.5 * rnd(BH, n)
    return r, k, v, w, u, rnd(BH, n, n) if with_s0 else None


def rwkv6_excess(got, want):
    """max|got - want| over RWKV6_LIMIT * max(1, max|want|): at most 1
    where the kernel agrees."""
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / (RWKV6_LIMIT * scale)


def phase_rwkv6_scan_vs_plain():
    """K6 against rwkv6_scan_ref, both on the card."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(3)
    cases = [(64, BH, T, s0, wr) for BH in RWKV6_BHS for T in RWKV6_TS
             for s0 in (False, True) for wr in ("model", "wide")]
    cases += [(16, 8, T, s0, wr) for T in (1, 7, 130)
              for s0 in (False, True) for wr in ("model", "wide")]
    worst = {"y": 0.0, "S_T": 0.0}
    excess = 0.0
    n_launch = 0
    split_pairs = set()      # (n, CTAs a head alone, in the batch)
    before = LMW.launches
    for n, BH, T, with_s0, wr in cases:
        args = rwkv6_inputs(gen, BH, T, n, wr, with_s0)
        want = ref.rwkv6_scan_ref(*args)
        outs = []
        for c in RWKV6_CHUNKS:
            outs.append(LMW(*args, chunk=c))
            if c == 64:
                batch_split = LMW.ctas_per_head
        n_launch += len(outs)
        # the first rows alone, at the default chunk: the launcher splits
        # a head over more CTAs for fewer rows (4 against 2 at BH 128)
        alone = None
        if BH > RWKV6_ROWS_ALONE:
            alone = LMW(*(None if a is None else a[:RWKV6_ROWS_ALONE]
                          for a in args))
            split_pairs.add((n, LMW.ctas_per_head, batch_split))
            n_launch += 1
        where = f"rwkv6_scan n={n} BH={BH} T={T} s0={with_s0} w={wr}"
        for (y, sT), c in zip(outs, RWKV6_CHUNKS):
            if (y.shape != want[0].shape or sT.shape != want[1].shape
                    or y.dtype != torch.float32 or sT.dtype != torch.float32):
                fail(f"{where} chunk={c}: {y.shape} {sT.shape} {y.dtype}")
            for name, g, wv in (("y", y, want[0]), ("S_T", sT, want[1])):
                over = rwkv6_excess(g, wv)
                if not torch.isfinite(g).all() or not over <= 1.0:
                    fail(f"{where} chunk={c}: {name} {over} x its limit")
                worst[name] = max(worst[name],
                                  float((g - wv).abs().max()))
                excess = max(excess, over)
        if not all(torch.equal(a, b) for o in outs
                   for a, b in zip(outs[0], o)):
            fail(f"{where}: chunk {RWKV6_CHUNKS} results differ")
        if alone is not None and not all(
                torch.equal(a, b[:RWKV6_ROWS_ALONE])
                for a, b in zip(alone, outs[0])):
            fail(f"{where}: the first {RWKV6_ROWS_ALONE} rows alone differ "
                 f"from the batch's")
    torch.cuda.synchronize()
    refused = []
    for name, dtype, n in (("bf16", torch.bfloat16, 64),
                           ("n=32", torch.float32, 32)):
        r = torch.zeros((4, 8, n), device=DEV, dtype=dtype)
        u = torch.zeros((4, n), device=DEV, dtype=dtype)
        try:
            LMW(r, r, r, r, u)
        except (TypeError, ValueError) as e:
            refused.append(f"{name}: {type(e).__name__}")
    if refused != ["bf16: TypeError", "n=32: ValueError"]:
        fail(f"rwkv6_scan: bf16 / n=32 not refused as expected ({refused})")
    if LMW.launches - before != n_launch:
        fail(f"rwkv6_scan: {LMW.launches - before} launches for {n_launch}")
    if not any(n == 64 and a != b for n, a, b in split_pairs):
        fail(f"rwkv6_scan: no case ran two splits of a head, CTAs a head "
             f"(n, rows alone, batch): {sorted(split_pairs)}")
    emit({"phase": "rwkv6_scan_vs_plain", "cases": len(cases),
          "launches": n_launch, "chunks": list(RWKV6_CHUNKS),
          "rows_alone": RWKV6_ROWS_ALONE,
          "ctas_per_head_alone_vs_batch": sorted(split_pairs),
          "rows_alone_bit_equal": True,
          "max_abs_err": worst, "limit": f"{RWKV6_LIMIT} * max(1, "
          f"max|plain|)", "max_err_over_limit": excess,
          "chunks_bit_equal": True, "refused": refused,
          "seconds": time.perf_counter() - t0})
    return max(worst.values())


def live_time_mix(model, gen):
    """Draw every rwkv6 layer's groupnorm weight and bias from ``gen`` in
    place of the reference's zeros, with which the time-mix output, and so
    the logits, would not depend on the WKV scan."""
    for layer in model.layers:
        D = layer.rwkv["ln_w"].shape[0]
        layer.rwkv["ln_w"].copy_(1.0 + 0.2 * torch.randn(D, generator=gen))
        layer.rwkv["ln_b"].copy_(0.1 * torch.randn(D, generator=gen))


def phase_rwkv6_lm_vs_plain():
    """rwkv6-1.6b at full width cut to 2 layers, f32, one seeded set of
    parameters (time-mix made live): the comparison of ``lm_vs_plain``
    (K6, K8 on the card, plain versions on the CPU), plus the last wkv
    states."""
    import copy

    from repro_torch import models
    from repro_torch.configs import base as CB
    cfg = CB.get_config("rwkv6-1.6b").replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    cpu_model = models.init_params(cfg, gen, "cpu")
    live_time_mix(cpu_model, gen)
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    out, cpu_cache, gpu_cache = compare_lm("rwkv6_lm_vs_plain", cfg,
                                           cpu_model, gpu_model)
    per_run = cfg.num_layers * (LM_VS_PLAIN_STEPS + 1)
    if out["k5_launches"] != 0 or out["k6_launches"] != per_run:
        fail(f"rwkv6_lm_vs_plain: {out['k6_launches']} K6 launches for "
             f"{per_run}")
    wkv = 0.0
    for c, g in zip(cpu_cache["layers"], gpu_cache["layers"]):
        want = c["wkv"]
        scale = max(1.0, float(want.abs().max()))
        wkv = max(wkv, float((g["wkv"].cpu() - want).abs().max()) / scale)
    if not wkv <= 1e-3:
        fail(f"rwkv6_lm_vs_plain: wkv states {wkv} x max(1, max|CPU|)")
    emit({"phase": "rwkv6_lm_vs_plain", "arch": "rwkv6-1.6b", **out,
          "wkv_max_err_over_scale": wkv, "wkv_limit": 1e-3,
          "seconds": time.perf_counter() - t0})


def rwkv6_entries(serve_launches, scan_err):
    """K6 at one prefill layer of rwkv6-1.6b (B*H = 32, T = 1024, n = 64,
    no initial state) and one decode step of four slots (B*H = 128, T = 1,
    the cached state), f32: device ms, with-host ms, plain ms, the bound;
    no PyTorch call computes the recurrence, so no library ms."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    out = []
    for BH, T, with_s0, tag in ((32, 1024, False, "prefill"),
                                (128, 1, True, "decode")):
        n = 64
        args = rwkv6_inputs(gen, BH, T, n, "model", with_s0)
        kern = lambda: LMW(*args)
        plain = lambda: ref.rwkv6_scan_ref(*args)
        (y, sT), want = kern(), plain()
        over = max(rwkv6_excess(y, want[0]), rwkv6_excess(sT, want[1]))
        if not over <= 1.0:
            fail(f"rwkv6_scan at the {tag} shape: {over} x its limit")
        err = max(float((y - want[0]).abs().max()),
                  float((sT - want[1]).abs().max()))
        # r, k, v, w, u (and s0) read once; y and S_T written once; per
        # row and step n^2 products of r S, n^2 of k v, n^2 FMAs of the
        # decay (5 n^2), and the bonus r.(u k) and its v (5 n)
        n_bytes = nbytes(args) + nbytes((y, sT))
        ops = BH * T * (5 * n * n + 5 * n)
        ctas = LMW.ctas_per_head
        extra = {}
        if tag == "prefill":
            # each point with the CTAs a head its launches took
            extra["bh_ms"], extra["bh_ctas_per_head"] = {}, {}
            for b in RWKV6_BH_MS:
                a = rwkv6_inputs(gen, b, T, n, "model", False)
                extra["bh_ms"][str(b)] = median_ms(lambda: LMW(*a), 20,
                                                   hide_host=True)
                extra["bh_ctas_per_head"][str(b)] = LMW.ctas_per_head
        out.append({"name": "rwkv6_scan" if tag == "prefill"
                    else "rwkv6_scan_decode", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                    "replaces": "src/repro/kernels/rwkv6_scan.py:83",
                    "launches": serve_launches[f"k6_{tag}"],
                    "max_abs_err": max(scan_err, err),
                    "ms": median_ms(kern, 20, hide_host=True),
                    "with_host_ms": median_ms(kern, 20),
                    "plain_ms": median_ms(plain, 3), "library_ms": None,
                    **roofline(n_bytes, ops),
                    "shape": [BH, T, n], "dtype": "float32",
                    "initial_state": with_s0, "ctas_per_head": ctas,
                    "path": f"serve_rwkv6_at_size {tag}", **extra})
    return out


def mamba_inputs(gen, B, T, d, N, dt_range):
    """Seeded f32 operands of K7 on the card.  ``dt_range`` "model": the
    softplus of a projection around the mamba init's bias (dt log-uniform
    in [1e-3, 0.1]); "wide": U(1e-3, 1).  a = -(1..N) scaled by U(0.5, 2),
    about the S4D-real init."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    uni = lambda *shape: torch.rand(shape, generator=gen, device=DEV)
    if dt_range == "model":
        dt0 = torch.exp(np.log(1e-3) + np.log(100.0) * uni(B, T, d))
        dt = torch.nn.functional.softplus(
            torch.log(torch.expm1(dt0)) + 0.1 * rnd(B, T, d))
    else:
        dt = 1e-3 + (1.0 - 1e-3) * uni(B, T, d)
    a = -torch.arange(1, N + 1, device=DEV, dtype=torch.float32) \
        * (0.5 + 1.5 * uni(d, N))
    return dt, rnd(B, T, d), rnd(B, T, N), rnd(B, T, N), a


def mamba_excess(got, want):
    """max|got - want| over MAMBA_LIMIT * max(1, max|want|): at most 1
    where the kernel agrees."""
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / (MAMBA_LIMIT * scale)


def phase_mamba_scan_vs_plain():
    """K7 against mamba_scan_ref, both on the card: y and s_T within
    MAMBA_LIMIT of the scale, every chunk of MAMBA_CHUNKS bit for bit, and
    the first MAMBA_CHANNELS_ALONE channels of each larger case alone (the
    launcher then takes another split: (lanes a channel, channels a
    lane)) bit for bit equal to the batch's; fails unless some case ran
    two splits."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(5)
    cases = [(B, T, d, N, dr) for B in MAMBA_BS for T in MAMBA_TS
             for d in MAMBA_DS for N in MAMBA_NS for dr in ("model", "wide")]
    worst = {"y": 0.0, "s_T": 0.0}
    excess = 0.0
    n_launch = 0
    splits = set()
    before = LMM.launches
    for B, T, d, N, dr in cases:
        args = mamba_inputs(gen, B, T, d, N, dr)
        want = ref.mamba_scan_ref(*args)
        outs = []
        for c in MAMBA_CHUNKS:
            outs.append(LMM(*args, chunk=c))
            split = (LMM.lanes_per_channel, LMM.channels_per_lane)
        n_launch += len(outs)
        where = f"mamba_scan B={B} T={T} d={d} N={N} dt={dr}"
        for (y, sT), c in zip(outs, MAMBA_CHUNKS):
            if (y.shape != want[0].shape or sT.shape != want[1].shape
                    or y.dtype != torch.float32 or sT.dtype != torch.float32):
                fail(f"{where} chunk={c}: {y.shape} {sT.shape} {y.dtype}")
            for name, g, wv in (("y", y, want[0]), ("s_T", sT, want[1])):
                over = mamba_excess(g, wv)
                if not torch.isfinite(g).all() or not over <= 1.0:
                    fail(f"{where} chunk={c}: {name} {over} x its limit")
                worst[name] = max(worst[name],
                                  float((g - wv).abs().max()))
                excess = max(excess, over)
        if not all(torch.equal(a, b) for o in outs[1:]
                   for a, b in zip(outs[0], o)):
            fail(f"{where}: chunk {MAMBA_CHUNKS} results differ")
        if d > MAMBA_CHANNELS_ALONE:
            k = MAMBA_CHANNELS_ALONE
            dt, x, Bm, Cm, a = args
            y, sT = LMM(dt[..., :k].contiguous(), x[..., :k].contiguous(),
                        Bm, Cm, a[:k].contiguous(), chunk=MAMBA_CHUNKS[-1])
            n_launch += 1
            alone = (LMM.lanes_per_channel, LMM.channels_per_lane)
            splits.add((split, alone))
            if not (torch.equal(y, outs[-1][0][..., :k])
                    and torch.equal(sT, outs[-1][1][:, :k])):
                fail(f"{where}: its first {k} channels alone (split "
                     f"{alone}) differ from the batch's ({split})")
    if not any(a != b for a, b in splits):
        fail(f"mamba_scan: no case ran two splits ({sorted(splits)})")
    torch.cuda.synchronize()
    refused = []
    for name, dtype, N in (("bf16", torch.bfloat16, 16),
                           ("N=32", torch.float32, 32)):
        x = torch.zeros((1, 8, 128), device=DEV, dtype=dtype)
        bc = torch.zeros((1, 8, N), device=DEV, dtype=dtype)
        a = torch.zeros((128, N), device=DEV, dtype=dtype)
        try:
            LMM(x, x, bc, bc, a)
        except (TypeError, ValueError) as e:
            refused.append(f"{name}: {type(e).__name__}")
    if refused != ["bf16: TypeError", "N=32: ValueError"]:
        fail(f"mamba_scan: bf16 / N=32 not refused as expected ({refused})")
    if LMM.launches - before != n_launch:
        fail(f"mamba_scan: {LMM.launches - before} launches for {n_launch}")
    emit({"phase": "mamba_scan_vs_plain", "cases": len(cases),
          "launches": n_launch, "chunks": list(MAMBA_CHUNKS),
          "max_abs_err": worst, "limit": f"{MAMBA_LIMIT} * max(1, "
          f"max|plain|)", "max_err_over_limit": excess,
          "chunks_bit_equal": True,
          "channels_alone": MAMBA_CHANNELS_ALONE,
          "splits_batch_alone": sorted(splits), "splits_bit_equal": True,
          "refused": refused, "seconds": time.perf_counter() - t0})
    return max(worst.values())


def card_copy(cfg, cpu_model):
    """The card's copy of ``cpu_model``, allocated on the card from the
    shapes and filled tensor by tensor: host memory holds the model once."""
    from repro_torch.models import transformer
    model = transformer.init_params(cfg, None, "meta").to_empty(device=DEV)
    src = dict(cpu_model.named_parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(src[name])
    return model


def phase_jamba_lm_vs_plain():
    """jamba-1.5-large at full width cut to two layers, (mamba, dense) then
    (attention, dense), f32, one seeded set of parameters: the comparison
    of ``lm_vs_plain`` (K5, K7, K8 on the card, plain versions on the CPU),
    plus the mamba layer's own scan.  At the reference's init the scan's
    share of the mixer's output is about 1e-4 (y = s . C beside the skip
    x d), so the logits cannot see K7: y and s_T of every prefill scan and
    the last ssm state are held, each within JAMBA_SCAN_LIMIT of the CPU's
    own magnitude, which must exceed JAMBA_SCAN_FLOOR.  (An MoE layer at
    this width is 9.66 B parameters, 38.6 GB in f32: MoE is held at
    granite's width.)"""
    from repro_torch import models
    from repro_torch.configs import base as CB
    from repro_torch.kernels import ops as KO
    full = CB.get_config(JAMBA)
    cfg = full.replace(num_layers=2, pattern=(full.pattern[0],
                                              full.pattern[4]),
                       dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    gpu_model = card_copy(cfg, cpu_model)
    scans = {"cpu": [], "cuda": []}
    real = KO.selective_scan

    def selective_scan(dt, x, Bm, Cm, a):
        y, sT = real(dt, x, Bm, Cm, a)
        scans[x.device.type].append((y.cpu(), sT.cpu(),
                                     float(x.abs().max())))
        return y, sT

    KO.selective_scan = selective_scan
    try:
        out, cpu_cache, gpu_cache = compare_lm("jamba_lm_vs_plain", cfg,
                                               cpu_model, gpu_model)
    finally:
        KO.selective_scan = real
    if out["k5_launches"] != 1 or out["k6_launches"] != 0:
        fail(f"jamba_lm_vs_plain: {out} launches on the card")
    pairs = [(f"scan {i} {name}", g, c)
             for i, (cs, gs) in enumerate(zip(scans["cpu"], scans["cuda"]))
             for name, c, g in (("y", cs[0], gs[0]), ("s_T", cs[1], gs[1]))]
    pairs += [("last ssm state", g["ssm"].cpu(), c["ssm"])
              for c, g in zip(cpu_cache["layers"], gpu_cache["layers"])
              if "ssm" in c]
    if (len(scans["cpu"]) != mixer_counts(cfg)["mamba"]
            or len(scans["cuda"]) != len(scans["cpu"]) or len(pairs) < 3):
        fail(f"jamba_lm_vs_plain: {len(scans['cpu'])} / "
             f"{len(scans['cuda'])} scans on the CPU / card")
    rel, least = 0.0, float("inf")
    for what, g, c in pairs:
        mag = float(c.abs().max())
        err = float((g - c).abs().max()) / max(mag, 1e-30)
        if not mag >= JAMBA_SCAN_FLOOR or not err <= JAMBA_SCAN_LIMIT:
            fail(f"jamba_lm_vs_plain: {what}: max|d| {err} x max|CPU| "
                 f"{mag}")
        rel, least = max(rel, err), min(least, mag)
    share = max(float(c[0].abs().max()) / c[2] for c in scans["cpu"])
    emit({"phase": "jamba_lm_vs_plain", "arch": JAMBA,
          "pattern": [[p.mixer, p.ffn] for p in cfg.pattern],
          "params": models.param_count(cfg), **out,
          "scan_share_of_mixer": share,
          "scan_max_err_over_magnitude": rel,
          "scan_limit": JAMBA_SCAN_LIMIT, "scan_least_magnitude": least,
          "scan_magnitude_floor": JAMBA_SCAN_FLOOR,
          "seconds": time.perf_counter() - t0})


def phase_moe_lm_vs_plain():
    """granite-moe-1b-a400m at full width cut to two layers, f32, one seeded
    set of parameters: the comparison of ``lm_vs_plain`` for the MoE FFN
    (routing and every expert on the card against the CPU), with the count
    of routings whose k-th and (k+1)-th probabilities lie within
    MOE_MARGIN on the CPU (there the two may pick differently)."""
    import copy

    from repro_torch import models
    from repro_torch.configs import base as CB
    from repro_torch.models import moe
    cfg = CB.get_config("granite-moe-1b-a400m").replace(
        num_layers=2, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(DEV)
    gaps = []
    real = moe.route

    def route(mcfg, router_w, tokens):
        res = real(mcfg, router_w, tokens)
        if tokens.device.type == "cpu":
            top = torch.topk(res[2], mcfg.top_k + 1, dim=-1).values
            gaps.append(top[:, -2] - top[:, -1])
        return res

    moe.route = route
    try:
        out, _, _ = compare_lm("moe_lm_vs_plain", cfg, cpu_model, gpu_model)
    finally:
        moe.route = real
    gaps = torch.cat(gaps)
    if out["k5_launches"] != cfg.num_layers or out["k7_launches"] != 0:
        fail(f"moe_lm_vs_plain: {out} launches on the card")
    emit({"phase": "moe_lm_vs_plain", "arch": "granite-moe-1b-a400m",
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k, **out,
          "routings": gaps.numel(), "router_margin": MOE_MARGIN,
          "routings_within_margin": int((gaps < MOE_MARGIN).sum()),
          "min_router_gap": float(gaps.min()),
          "seconds": time.perf_counter() - t0})


def mamba_entries(serve_launches, scan_err):
    """K7 at one prefill layer of jamba-1.5-large (B 1, T 1024, d_in
    16 384, N 16), f32: device ms, with-host ms, plain ms, the bound, the
    split the launcher took; ``d_ms`` at MAMBA_D_MS (B 1, T 1024) with the
    channels a lane each point took, and T 128 (the shortest prompt the
    serving phases send); no PyTorch call computes the selective scan, so
    no library ms."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    B, T, d, N = 1, 1024, 16384, 16
    args = mamba_inputs(gen, B, T, d, N, "model")
    kern = lambda: LMM(*args)
    plain = lambda: ref.mamba_scan_ref(*args)
    (y, sT), want = kern(), plain()
    lanes, cpl = LMM.lanes_per_channel, LMM.channels_per_lane
    over = max(mamba_excess(y, want[0]), mamba_excess(sT, want[1]))
    if not over <= 1.0:
        fail(f"mamba_scan at the prefill shape: {over} x its limit")
    err = max(float((y - want[0]).abs().max()),
              float((sT - want[1]).abs().max()))
    # dt, x, Bm, Cm, a read once; y and s_T written once.  Per (t, c, n):
    # dt * a, s * da, (dt x) * B and its add, s * C and its add: six f32
    # operations, and one exp on the special-function units
    n_bytes = nbytes(args) + nbytes((y, sT))
    exps = B * T * d * N
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = 6 * exps / FP32_OPS_PER_S * 1e3
    sfu_ms = exps / SFU_EXPS_PER_S * 1e3
    ops_ms = max(flops_ms, sfu_ms)
    entry = {"name": "mamba_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
             "replaces": "src/repro/kernels/mamba_scan.py:79",
             "launches": serve_launches["k7_prefill"],
             "max_abs_err": max(scan_err, err),
             "ms": median_ms(kern, 20, hide_host=True),
             "with_host_ms": median_ms(kern, 20),
             "plain_ms": median_ms(plain, 3), "library_ms": None,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "bytes_ms": bytes_ms, "operations_ms": ops_ms,
             "fp32_ops_ms": flops_ms, "sfu_exp_ms": sfu_ms, "exps": exps,
             "sfu_exps_per_s": SFU_EXPS_PER_S, "bytes": n_bytes,
             "lanes_per_channel": lanes, "channels_per_lane": cpl,
             "shape": [B, T, d, N], "dtype": "float32",
             "path": "serve_jamba_at_size prefill"}
    del args, y, sT, want
    d_ms, d_cpl = [], []
    for dd in MAMBA_D_MS:
        args = mamba_inputs(gen, B, T, dd, N, "model")
        d_ms.append(median_ms(lambda: LMM(*args), 20, hide_host=True))
        d_cpl.append(LMM.channels_per_lane)
        del args
    args = mamba_inputs(gen, B, 128, d, N, "model")
    entry.update({"d_ms_d": list(MAMBA_D_MS), "d_ms": d_ms,
                  "d_channels_per_lane": d_cpl,
                  "t128_ms": median_ms(lambda: LMM(*args), 20,
                                       hide_host=True)})
    return [entry]


def flash_entry(name, path, launches, tc_launches, flash_err, BH, BKV, S,
                hd, gen):
    """K5 at one causal bf16 prefill layer (Sq = Sk = S): device ms,
    with-host ms, plain ms, SDPA's ms (``enable_gqa``, ``is_causal``), the
    bound: QK^T and PV over the causal pairs at the dense bf16 tensor-core
    peak against q, k, v and the output moved once."""
    import torch.nn.functional as F
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
        fail(f"flash_attention at {path}: max|d| {err}, {over} x its limit")
    lib_err = float((library()[0].float() - want.float()).abs().max())
    ops = 4 * BH * hd * (S * (S + 1) // 2)     # QK^T and PV, causal pairs
    n_bytes = nbytes((q, k, v)) + q.numel() * q.element_size()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    source = ("flash_attention_sm90.cu" if tensor_core_path(bf, hd)
              else "flash_attention.cu")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": "src/repro/kernels/flash_attention.py:140",
            "launches": launches, "tc_launches": tc_launches,
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
            "causal": True, "path": path}


def lm_entries(serve_launches, jamba_launches, flash_err, rms_err):
    """K5 at one prefill layer of llama3.2-1b (Sq = Sk = 1024, B*H = 32,
    B*KV = 8, hd 64) and of jamba (B*H = 64, B*KV = 8, hd 128), bf16,
    causal; K8 in bf16 at llama's 1024 x 2048 (prefill) and 4 x 2048 (a
    decode step of four slots), and jamba's at D 8192 (its layer norms)
    and 16 384 (the norm inside each mamba mixer), 1024 rows and 4: device
    ms, with-host ms, plain ms, the library call's ms, the bound."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(2)
    bf = torch.bfloat16
    out = [flash_entry("flash_attention", "serve_at_size prefill",
                       serve_launches["k5"], serve_launches["k5_tc"],
                       flash_err, 32, 8, 1024, 64, gen),
           flash_entry("flash_attention_jamba", "serve_jamba_at_size prefill",
                       jamba_launches["k5"], jamba_launches["k5_tc"],
                       flash_err, 64, 8, 1024, 128, gen)]
    src = "src/repro_torch/kernels/csrc/"
    # jamba's norms a forward: at D 8192 two a layer and the final one, at
    # D 16 384 one a mamba mixer
    inner_pre, inner_dec = (jamba_launches["mamba_layers"] * jamba_launches[k]
                            for k in ("forwards_prefill", "forwards_decode"))
    shapes = (("rmsnorm", "serve_at_size prefill", 1024, 2048,
               serve_launches["k8_prefill"]),
              ("rmsnorm_decode", "serve_at_size decode", 4, 2048,
               serve_launches["k8_decode"]),
              ("rmsnorm_jamba", "serve_jamba_at_size prefill", 1024, 8192,
               jamba_launches["k8_prefill"] - inner_pre),
              ("rmsnorm_jamba_decode", "serve_jamba_at_size decode", 4, 8192,
               jamba_launches["k8_decode"] - inner_dec),
              ("rmsnorm_jamba_mamba", "serve_jamba_at_size prefill", 1024,
               16384, inner_pre),
              ("rmsnorm_jamba_mamba_decode", "serve_jamba_at_size decode", 4,
               16384, inner_dec))
    for name, path, rows, D, launches in shapes:
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
        out.append({"name": name,
                    "route": "cuda", "source": src + "rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm.py:44",
                    "launches": launches,
                    "max_abs_err": max(rms_err, err),
                    "ms": median_ms(kern, 20, hide_host=True),
                    "with_host_ms": median_ms(kern, 20),
                    "plain_ms": median_ms(plain, 5),
                    "library_ms": median_ms(library, 20, hide_host=True),
                    **roofline(n_bytes, 4 * rows * D),
                    "shape": [rows, D], "dtype": "bfloat16", "path": path})
    return out


def floor_ms():
    """The floor of a launch timed by ``median_ms(..., hide_host=True)``:
    an empty kernel of the LM library (``lm_empty_launch``)."""
    return median_ms(lambda: lm_lib.launch("lm_empty", DEV), 20,
                     hide_host=True)


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
#: The six diagram writers of ``repro_torch.bench`` the ``diagrams`` phase
#: runs at the reference's one-device defaults (target_cs 150), each with
#: the stem of its CSV / Markdown report and the axes of its phase cells
#: (a cell is one value of each; the cells of one value of the axes
#: outside (cs, sub, wake) hold every scenario once).
DIAGRAMS = {
    "oracle_ablation": ("oracle_phase_diagram", ("cs", "sub", "wake")),
    "discipline_diagram": ("discipline_phase_diagram",
                           ("cs", "sub", "wake")),
    "workload_diagram": ("workload_phase_diagram", ("workload", "cs", "sub")),
    "arrival_diagram": ("arrival_phase_diagram", ("arrival", "rho")),
    "fault_diagram": ("fault_phase_diagram", ("fault", "cs", "sub")),
    "park_diagram": ("park_phase_diagram", ("park_cost", "cs", "sub")),
}
#: Configs of each at those defaults: 200 x 23, 200 x 15, 100 x 4 x 15,
#: 50 x 8 x 15, 100 x 5 x 15, 50 x 4 x 15.
DIAGRAM_CONFIGS = {"oracle_ablation": 4600, "discipline_diagram": 3000,
                   "workload_diagram": 6000, "arrival_diagram": 6000,
                   "fault_diagram": 7500, "park_diagram": 3000}
#: The streamed fault grid: 1334 scenarios x 5 fault rows x 15 variants =
#: 100 050 configs, the phase cells' wins accumulated on the card.
FAULT_STREAM_SCENARIOS = 1334
#: ``paper_figures``: Fig. 3 at lockbench's defaults (xdes 400, the DES
#: 2000 CS a cell), the reference's parity band for every seed-averaged
#: xdes / DES ratio, the fidelity band allowed at dt <= 3e-7 (the lower
#: side of the parity band), and the serving-window sizes of
#: ``tests/test_paper_claims.py`` (C6) and ``sched_bench --xdes``.
PAPER_XDES_TARGET_CS = 400
PAPER_DES_TARGET_CS = 2000
DES_BAND = (0.7, 1.4)
FIDELITY_LIMIT = 0.3
SCHED_REQUESTS = 250
SCHED_SCENARIOS = 20


#: Instruction classes of ``kernel_sass`` (``k1_sass``, ``k6_sass``,
#: ``k7_sass``, ``k8_sass``): a class counts the
#: SASS instructions whose opcode (before the first ".") is in its set, or,
#: for "int", starts with "I" (IMAD, IADD3, ISETP, IMNMX, IABS, I2F...).
SASS_CLASSES = {"vote": ("VOTE", "VOTEU"), "redux": ("REDUX",),
                "shfl": ("SHFL",), "mufu": ("MUFU",), "call": ("CALL",),
                "bssy": ("BSSY",), "bra": ("BRA",), "lds": ("LDS",),
                "sts": ("STS",), "ffma": ("FFMA",), "fmul": ("FMUL",),
                "bar": ("BAR",), "ldg": ("LDG",), "stg": ("STG",),
                "ldgsts": ("LDGSTS",)}


def sass_functions(path):
    """``{function name: [opcode, ...]}`` of a library's ``cuobjdump -sass``,
    opcodes without their predicate and modifiers, NOPs left out."""
    tool = os.path.join(os.path.dirname(KB.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        ops = []
        for ln in chunk.splitlines()[1:]:
            code = ln.split("*/", 1)[1] if ln.lstrip().startswith("/*") \
                and "*/" in ln else ""
            words = code.replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words and words[0][0].isalpha():
                op = words[0].split(".")[0]
                if op != "NOP":
                    ops.append(op)
        out[chunk.split(None, 1)[0]] = ops
    return out


def sass_classes(ops):
    """Static counts of ``ops`` in total, by ``SASS_CLASSES``, integer, and
    the eight most frequent opcodes."""
    out = {"total": len(ops)}
    for cls, names in SASS_CLASSES.items():
        out[cls] = sum(op in names for op in ops)
    out["int"] = sum(op.startswith("I") for op in ops)
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    out["top"] = dict(sorted(counts.items(), key=lambda kv: -kv[1])[:8])
    return out


def ptxas_by_entry(log):
    """``{mangled entry name: [registers line, spill line]}`` of ptxas -v."""
    out, name = {}, None
    for ln in log.splitlines():
        if "entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.strip())
    return out


def kernel_sass(lib_build, kernel, tags, occupancy):
    """Per instantiation of ``kernel`` in a built library: static SASS
    counts by class (``sass_classes``), ptxas's registers and spills, and
    the blocks and warps resident on an SM (``occupancy``, by name).
    ``tags`` maps each instantiation's name to the part of its mangled name
    that tells it apart.  Fails unless every instantiation is there once,
    or if ptxas spilled in one."""
    funcs = sass_functions(lib_build.path)
    regs = ptxas_by_entry(lib_build.log)
    out = {}
    for name, tag in tags.items():
        hit = [f for f in funcs if tag in f]
        if len(hit) != 1:
            fail(f"build: {kernel}{name} not in the SASS")
        ptxas = regs.get(hit[0], [])
        if any("spill" in ln and ", 0 bytes spill stores" not in ln
               for ln in ptxas):
            fail(f"build: {kernel}{name} spills: {ptxas}")
        out[name] = {**sass_classes(funcs[hit[0]]), "ptxas": ptxas,
                     **occupancy[name]}
    return out


def k1_sass(sim_build):
    """K1 in the simulator library: ``kernel_sass`` of the six
    ``lock_sim_block_kernel<NS, OPEN>`` instantiations, resident blocks
    from ``lock_sim.block_occupancy``."""
    tags = {f"<{ns}, {'true' if opn else 'false'}>":
            f"lock_sim_block_kernelILi{ns}ELb{int(opn)}E"
            for ns in (1, 2, 4) for opn in (False, True)}
    return kernel_sass(sim_build, "lock_sim_block_kernel", tags,
                       K.block_occupancy(DEV))


def k6_sass(lm_build):
    """K6 in the LM library: ``kernel_sass`` of every ``rwkv6_scan_kernel<n,
    cols>`` instantiation the library lists, with the blocks and warps
    resident on an SM and the shared memory of one CTA at chunk 64 (the
    default) and 128 (``rwkv6_scan.occupancy``; 0 blocks where a block
    cannot hold it)."""
    per = {}
    for chunk in (64, 128):
        for name, o in K6.occupancy(DEV, chunk).items():
            per.setdefault(name, {}).update({
                "threads": o["threads"],
                f"blocks_per_sm_chunk{chunk}": o["blocks_per_sm"],
                f"warps_per_sm_chunk{chunk}": o["warps_per_sm"],
                f"smem_bytes_chunk{chunk}": o["smem_bytes"]})
    tags = {name: "rwkv6_scan_kernelILi{}ELi{}E".format(
        *name.strip("<>").split(", ")) for name in per}
    return kernel_sass(lm_build, "rwkv6_scan_kernel", tags, per)


def k7_sass(lm_build):
    """K7 in the LM library: ``kernel_sass`` of every ``mamba_scan_kernel<N,
    channels a lane>`` instantiation the library lists (named ``<N, lanes a
    channel, channels a lane>``), with the blocks and warps resident on an
    SM and the shared memory of one block at chunk 64 (the default) and 128
    (``mamba_scan.occupancy``)."""
    per = {}
    for chunk in (64, 128):
        for name, o in K7.occupancy(DEV, chunk).items():
            per.setdefault(name, {}).update({
                "threads": o["threads"],
                f"blocks_per_sm_chunk{chunk}": o["blocks_per_sm"],
                f"warps_per_sm_chunk{chunk}": o["warps_per_sm"],
                f"smem_bytes_chunk{chunk}": o["smem_bytes"]})
    tags = {}
    for name in per:
        n, _, cpl = name.strip("<>").split(", ")
        tags[name] = f"mamba_scan_kernelILi{n}ELi{cpl}EE"
    return kernel_sass(lm_build, "mamba_scan_kernel", tags, per)


def k8_sass(lm_build):
    """K8 in the LM library: ``kernel_sass`` of every ``rmsnorm_kernel<T,
    V>`` instantiation, with the blocks and warps resident on an SM at 256
    threads a block and at its most (``rmsnorm.occupancy``)."""
    occ = K8.occupancy(DEV)
    mangled = {"float32": "f", "bfloat16": "13__nv_bfloat16"}
    tags = {}
    for name in occ:
        dtype, v = name.strip("<>").split(", ")
        tags[name] = f"rmsnorm_kernelI{mangled[dtype]}Li{v}EE"
    return kernel_sass(lm_build, "rmsnorm_kernel", tags, occ)


def tensor_core_sass(lm_build):
    """K5's tensor-core kernel in the LM library: per instantiation
    (``flash_attention_kernel_sm90<64>``, ``<128>``), its ``HGMMA``
    instructions in ``cuobjdump -sass`` and ptxas's registers and spills.
    Fails unless both instantiations are there and each issues HGMMA."""
    regs = ptxas_by_entry(lm_build.log)
    out = {name: {"hgmma": ops.count("HGMMA"), "ptxas": regs.get(name, [])}
           for name, ops in sass_functions(lm_build.path).items()
           if "flash_attention_kernel_sm90" in name}
    if len(out) != 2 or not all(v["hgmma"] > 0 for v in out.values()):
        fail(f"build: flash_attention_kernel_sm90 without HGMMA in its SASS: "
             f"{out}")
    return out


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
    # flash_attention_kernel_sm90<HD>, rwkv6_scan_kernel<N, COLS>,
    # mamba_scan_kernel<N, CPL>, rmsnorm_kernel<T, V>), its registers and
    # spills follow
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
          "k5_tensor_core_sass": tensor_core_sass(lm_build),
          "k1_sass": k1_sass(sim_build),
          "k6_sass": k6_sass(lm_build),
          "k7_sass": k7_sass(lm_build),
          "k8_sass": k8_sass(lm_build),
          # the pair whose device math libraries must agree for phase 3
          "nvcc": KB.nvcc_release(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})

    flash_err = phase_flash_attention_vs_plain()
    rms_err = phase_rmsnorm_vs_plain()
    phase_lm_vs_plain()
    serve_launches = phase_serve_at_size()
    scan_err = phase_rwkv6_scan_vs_plain()
    phase_rwkv6_lm_vs_plain()
    rwkv6_launches = phase_serve_at_size("serve_rwkv6_at_size", "rwkv6-1.6b")
    mamba_err = phase_mamba_scan_vs_plain()
    phase_jamba_lm_vs_plain()
    phase_moe_lm_vs_plain()
    jamba_launches = phase_serve_at_size("serve_jamba_at_size", JAMBA,
                                         JAMBA_LAYERS)
    max_abs_err = phase_kernel_vs_plain()
    open_abs_err = phase_open_kernel_vs_plain()
    step_abs_err = phase_step_kernels_vs_plain()
    oracle_args = phase_oracle_kernel_vs_plain()
    phase_fig3()
    scan_launches = phase_scan_equals_blocked()
    cfgs, steps, big, launches = phase_at_size(AT_SIZE_SCENARIOS)
    phase_stream_identity()
    arrs, _, ares, open_launches = phase_arrival_at_size()
    diagram_launches = phase_diagrams()
    paper_launches = phase_paper_figures()
    floor = floor_ms()
    entries = (closed_entries(cfgs, steps, big, launches, scan_launches,
                              max_abs_err, step_abs_err)
               + open_entries(arrs, ares, open_launches, scan_launches,
                              open_abs_err, step_abs_err)
               + [oracle_entry(oracle_args)]
               + lm_entries(serve_launches, jamba_launches, flash_err,
                            rms_err)
               + rwkv6_entries(rwkv6_launches, scan_err)
               + mamba_entries(jamba_launches, mamba_err))
    for entry in entries:
        entry["floor_ms"] = floor
        # the sweep layer's path: K1 in the closed grids, K1-open in the
        # arrival grid (phase diagrams, its own counts)
        if entry["name"] in ("lock_sim_block", "lock_sim_block_open"):
            opened = entry["name"] == "lock_sim_block_open"
            entry["diagrams_launches"] = diagram_launches[opened]
            # the paper's figures: Fig. 3, the DES bands, the fidelity
            # study, the scheduler sweep
            entry["paper_figures_launches"] = paper_launches[opened]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

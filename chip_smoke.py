#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and nothing else: the kernel library (the
closed and open variants of ``lock_sim_block``) is built from
``src/repro_torch/kernels/csrc`` by this run.  Exits non-zero, printing no
result line, when there is no CUDA device or when any phase fails.

Phases (each but the first prints one JSON line):

1. the card's name and power limit, the line ``nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`` prints
2. ``build``   nvcc build of the kernel library: seconds, and ptxas's
   registers / spills for each instantiation (closed and open variants
   at 1, 2 and 4 thread slots per lane)
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
5. ``fig3``    ``simulate_batch`` on the 320-config Fig. 3 grid, auto
   horizon for target_cs=25 with early exit, ``backend="kernel"`` against
   ``backend="ref"`` on the card; equal under the same rule;
   ``validate()`` passes.
6. ``at_size`` the 100 005-config discipline x oracle sweep (T=32,
   target_cs=50, step-count buckets, no per-thread output) through the
   kernel: configs, buckets, launches, seconds, config-steps/s, peak bytes;
   then the same sweep without the early-exit flag, to price the one
   device-to-host read per launch, and once under ``torch.profiler`` for
   the device's busy seconds and idle share.
7. ``stream_identity``  the 720-config arrival grid through the kernel
   without early exit: one-shot ``simulate_batch`` == ``sweep_stream`` in
   at least 3 chunks, and a sweep cut after its first committed chunk then
   resumed from its checkpoint == the uninterrupted one, bit for bit.
8. ``arrival_at_size``  ``sweep_stream`` over the 100 080-config arrival
   diagram (834 scenarios x 2 arrival rows x 4 loads x 15 variants, T=32,
   target_cs=50, CellReduce over the 8 (arrival, load) cells) through the
   open kernel: seconds, config-steps/s, chunks, launches, host and device
   seconds, peak bytes, the device's busy share, the cells' winners.
9. ``kernels`` the contract line: per variant, the time per launch at its
   sweep's largest shape (CUDA events, median), the plain version's time at
   the same shape, the roofline bound, and the launches its sweep made.

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
from repro_torch.kernels import lock_sim as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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


def compare_results(a, b, where, fields=("completed", "completed_per_thread",
                                          "wake_count", "final_sws", "t_end",
                                          "steps_run", "spin_cpu")):
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
# phases 4-6
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


def profiled(run):
    """One more pass of ``run`` (which returns its seconds second) under
    ``torch.profiler``: (seconds of the traced pass, device seconds summed
    over every kernel and copy, device seconds of ``lock_sim_block_kernel``
    alone).  All work is on one stream, so the sum is the time the device
    was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seconds = run()[1]
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) * 1e-6
    kernel = sum(e.self_device_time_total for e in on_device
                 if "lock_sim_block_kernel" in e.key) * 1e-6
    return seconds, busy, kernel


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
    traced_s, busy, kernel_busy = profiled(sweep)
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
    s_traced, busy, kernel_busy = profiled(lambda: timed_sweep(cfgs))
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


def median_ms(fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_launch(cols, T, n_steps, open_loop, ops_per_thread_step,
                ops_per_row_step=0):
    """Time one launch of the kernel (CUDA events, median of 20) and of its
    plain version (median of 3) at ``cols``' shape, from the state halfway
    through an ``n_steps`` run, and compute the roofline bound of that
    launch: every input read once, every output written once; operations
    for the sub-steps it really runs, per active thread and per row."""
    args = block_args(cols)
    B = xdes.DEFAULT_BLOCK_STEPS
    state = xdes._init_state(cols, T, open_loop)
    n = len(ref.BLOCK_STATE)
    opn = lambda st: st[n:] if open_loop else None
    warm = (n_steps // 2) // B * B
    for step0 in range(0, warm, B):        # reach the middle of the run
        state = K.lock_sim_block(*state[:n], step0, *args, n_sub_steps=B,
                                 limit=n_steps, ids_checked=True,
                                 open_state=opn(state))
    kern = lambda: K.lock_sim_block(*state[:n], warm, *args, n_sub_steps=B,
                                    limit=n_steps, ids_checked=True,
                                    open_state=opn(state))
    plain = lambda: ref.lock_sim_block_ref(*state[:n], warm, *args,
                                           n_sub_steps=B, limit=n_steps,
                                           open_state=opn(state))
    compare_states(kern(), plain(), "timing shape",
                   OPEN_NAMES if open_loop else STATE_NAMES)
    ms = median_ms(kern, 20)
    plain_ms = median_ms(plain, 3)
    C = cols["policy"].shape[0]
    live_steps = min(B, n_steps - warm)
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    ctx_bytes = sum(t.numel() * t.element_size() for t in args
                    if isinstance(t, torch.Tensor))
    bytes_ms = (2 * state_bytes + ctx_bytes) / HBM_BYTES_PER_S * 1e3
    active = int(torch.clamp(cols["threads"], max=T).sum())
    ops = live_steps * (active * ops_per_thread_step + C * ops_per_row_step)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "shape": [C, T], "active_threads": active,
            "n_sub_steps": B, "bytes_ms": bytes_ms, "operations_ms": ops_ms}


def closed_entry(cfgs, steps, idx, launches, max_abs_err):
    """K1 closed at the largest bucket shape of the at-size sweep."""
    bucket = [cfgs[i] for i in idx]
    C = xdes._pad_quantum(len(bucket))
    bucket = bucket + [bucket[-1]] * (C - len(bucket))
    arrs = P.encode_configs(bucket)
    arrs["dt"], _ = xdes.plan_schedule(bucket, AT_SIZE_TARGET_CS)
    n_steps = min(int(steps[idx].max()), xdes.MAX_STEPS)
    timing = time_launch(xdes.columns_from_numpy(arrs, DEV), 32, n_steps,
                         False, OPS_PER_THREAD_STEP)
    return {"name": "lock_sim_block", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lock_sim_block.cu",
            "replaces": "src/repro/kernels/lock_sim.py:463",
            "launches": launches, "max_abs_err": max_abs_err, **timing}


def open_entry(arrs, res, launches, max_abs_err):
    """K1-open at the largest chunk shape of the arrival at-size sweep."""
    n = min(res.chunk_size, res.n_configs)
    part = {k: v[:n] for k, v in arrs.items()}
    timing = time_launch(xdes.columns_from_numpy(part, DEV), 32,
                         res.n_steps, True, OPS_PER_THREAD_STEP_OPEN,
                         OPS_PER_ROW_STEP_OPEN)
    return {"name": "lock_sim_block_open", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lock_sim_block.cu",
            "replaces": "src/repro/kernels/lock_sim.py:463 (open_run=True, "
                        "lock_sim.py:457-481)",
            "launches": launches, "max_abs_err": max_abs_err, **timing}


FIG3_TARGET_CS = 25
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

    build = K.build_library()
    # one "Compiling entry function" line names each instantiation
    # (lock_sim_block_kernel<NS, OPEN>), its registers and spills follow
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build.seconds, "cached": build.cached,
          "library": os.path.relpath(build.path, HERE), "ptxas": ptxas,
          # the pair whose device math libraries must agree for phase 3
          "nvcc": K.nvcc_release(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})

    max_abs_err = phase_kernel_vs_plain()
    open_abs_err = phase_open_kernel_vs_plain()
    phase_fig3()
    cfgs, steps, big, launches = phase_at_size(AT_SIZE_SCENARIOS)
    phase_stream_identity()
    arrs, _, ares, open_launches = phase_arrival_at_size()
    entries = [closed_entry(cfgs, steps, big, launches, max_abs_err),
               open_entry(arrs, ares, open_launches, open_abs_err)]
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

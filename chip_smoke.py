#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and nothing else: the kernel is built from
``src/repro_torch/kernels/csrc`` by this run.  Exits non-zero, printing no
result line, when there is no CUDA device or when any phase fails.

Phases (each but the first prints one JSON line):

1. the card's name and power limit, the line ``nvidia-smi
   --query-gpu=name,power.limit --format=csv,noheader`` prints
2. ``build``   nvcc build of the kernel library: seconds, ptxas registers
3. ``kernel_vs_plain``  ``lock_sim_block`` against ``lock_sim_block_ref``,
   both on the card, chained from the engine's initial state for 256 steps
   over the closed conformance matrix (every policy id x workload x fault,
   park_cost in {0.25, 1, 16}), ``tie_break="random"`` rows, a T=64 and a
   T=128 batch (2 and 4 thread slots per lane), for ``n_sub_steps`` in {1, 32}, with a (C,) ``limit`` that cuts
   rows mid-block.  Every int field, ``rem`` and ``wake_at`` must be
   exactly equal; ``spin_cpu`` (a float row sum) within rtol=1e-6.
4. ``fig3``    ``simulate_batch`` on the 320-config Fig. 3 grid, auto
   horizon for target_cs=25 with early exit, ``backend="kernel"`` against ``backend="ref"``
   on the card; equal under the same rule; ``validate()`` passes.
5. ``at_size`` the 100 005-config discipline x oracle sweep (T=32,
   target_cs=50, step-count buckets, no per-thread output) through the
   kernel: configs, buckets, launches, seconds, config-steps/s, peak bytes;
   then the same sweep without the early-exit flag, to price the one
   device-to-host read per launch, and once under ``torch.profiler`` for
   the device's busy seconds and idle share.
6. ``kernels`` the contract line: time per launch at phase 5's largest
   bucket shape (CUDA events, median), the plain version's time at the same
   shape, the roofline bound, and the launches phase 5 made.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
from repro_torch.core import xdes  # noqa: E402
from repro_torch.core.policy import SimConfig  # noqa: E402
from repro_torch.kernels import lock_sim as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DEV = torch.device("cuda")
STATE_NAMES = ref.BLOCK_STATE
#: Fields that must agree bit for bit between kernel and plain version;
#: ``spin_cpu`` is an order-dependent float row sum and takes SPIN_RTOL.
EXACT_FIELDS = tuple(n for n in STATE_NAMES if n != "spin_cpu")
SPIN_RTOL = 1e-6

# H100 SXM data-sheet peaks used for the bound (dense, 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: Arithmetic / compare / ballot operations one simulated thread needs for
#: one sub-step in which nothing happens (no wake, release, poll or
#: arrival), counted on the unconditional path of csrc/lock_sim_block.cu:
#: step setup 6, GPS advance 19, wake/gate context 4, wake-completion test
#: 4, release test 4, arrival test 5, ticket retire 4.  Events add to it,
#: so operations x this is a lower bound on the work.
OPS_PER_THREAD_STEP = 46


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------
def compare_states(got, want, where):
    """Kernel state vs plain state; returns the largest absolute
    difference over finite floats.  Fails on the first violated field."""
    worst = 0.0
    for name, g, w in zip(STATE_NAMES, got, want):
        if name in EXACT_FIELDS:
            if not torch.equal(g, w):
                bad = int((g != w).sum())
                fail(f"{where}: {name} differs in {bad}/{g.numel()} entries")
        else:
            if not torch.allclose(g, w, rtol=SPIN_RTOL, atol=0.0):
                rel = ((g - w).abs() / w.abs().clamp_min(1e-30)).max()
                fail(f"{where}: {name} off by rel {float(rel):.3g} "
                     f"(rtol {SPIN_RTOL})")
        if g.dtype.is_floating_point:
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                worst = max(worst, float((g[fin] - w[fin]).abs().max()))
    return worst


def compare_results(a, b, where):
    for f in ("completed", "completed_per_thread", "wake_count",
              "final_sws", "t_end", "steps_run"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            fail(f"{where}: BatchResult.{f} differs between backends")
    if not np.allclose(a.spin_cpu, b.spin_cpu, rtol=SPIN_RTOL, atol=0.0):
        fail(f"{where}: BatchResult.spin_cpu beyond rtol {SPIN_RTOL}")


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
          "exact_fields": len(EXACT_FIELDS), "spin_cpu_rtol": SPIN_RTOL,
          "max_abs_err": worst})
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


def traced_sweep(cfgs):
    """One more at-size sweep under ``torch.profiler``: (seconds of the
    traced pass, device seconds summed over every kernel and copy, device
    seconds of ``lock_sim_block_kernel`` alone).  All work is on one
    stream, so the sum is the time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, seconds, _ = timed_sweep(cfgs)
    on_device = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) * 1e-6
    kernel = sum(e.self_device_time_total for e in on_device
                 if "lock_sim_block_kernel" in e.key) * 1e-6
    return seconds, busy, kernel


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
    s_traced, busy, kernel_busy = traced_sweep(cfgs)
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


def phase_kernels(cfgs, steps, idx, launches, max_abs_err, t_start):
    """Time one launch at the largest bucket's padded shape, from a
    mid-trajectory state of that bucket."""
    bucket = [cfgs[i] for i in idx]
    C = xdes._pad_quantum(len(bucket))
    bucket = bucket + [bucket[-1]] * (C - len(bucket))
    T, B = 32, xdes.DEFAULT_BLOCK_STEPS
    arrs = P.encode_configs(bucket)
    arrs["dt"], _ = xdes.plan_schedule(bucket, AT_SIZE_TARGET_CS)
    cols = xdes.columns_from_numpy(arrs, DEV)
    args = block_args(cols)
    n_steps = min(int(steps[idx].max()), xdes.MAX_STEPS)
    state = xdes._init_state(cols, T)
    warm = (n_steps // 2) // B * B
    for step0 in range(0, warm, B):        # reach the middle of the run
        state = K.lock_sim_block(*state, step0, *args, n_sub_steps=B,
                                 limit=n_steps, ids_checked=True)
    kern = lambda: K.lock_sim_block(*state, warm, *args, n_sub_steps=B,
                                    limit=n_steps, ids_checked=True)
    plain = lambda: ref.lock_sim_block_ref(*state, warm, *args,
                                           n_sub_steps=B, limit=n_steps)
    compare_states(kern(), plain(), "timing shape")
    ms = median_ms(kern, 20)
    plain_ms = median_ms(plain, 3)
    # bound: every input read once, every output written once; operations
    # for the sub-steps this launch really runs (limit cuts none here)
    live_steps = min(B, n_steps - warm)
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    ctx_bytes = sum(t.numel() * t.element_size() for t in args
                    if isinstance(t, torch.Tensor))
    bytes_ms = (2 * state_bytes + ctx_bytes) / HBM_BYTES_PER_S * 1e3
    ops = C * T * live_steps * OPS_PER_THREAD_STEP
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "lock_sim_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lock_sim_block.cu",
        "replaces": "src/repro/kernels/lock_sim.py:463",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": [C, T], "n_sub_steps": B, "bytes_ms": bytes_ms,
        "operations_ms": ops_ms}]})


FIG3_TARGET_CS = 25
AT_SIZE_TARGET_CS = 50
AT_SIZE_SCENARIOS = 6667        # x 15 variants = 100 005 configs


def main():
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    build = K.build_library()
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build.seconds, "cached": build.cached,
          "library": os.path.relpath(build.path, HERE), "ptxas": ptxas,
          # the pair whose device math libraries must agree for phase 3
          "nvcc": K.nvcc_release(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda})

    max_abs_err = phase_kernel_vs_plain()
    phase_fig3()
    cfgs, steps, big, launches = phase_at_size(AT_SIZE_SCENARIOS)
    phase_kernels(cfgs, steps, big, launches, max_abs_err, t_start)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

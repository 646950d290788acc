"""The hand-written Hopper kernels of the lock simulator and their wrappers.

Four kernels, each the port of a Pallas TPU kernel of
``repro/kernels/lock_sim.py`` of the same name, with its plain PyTorch
version in :mod:`repro_torch.kernels.ref`:

* :func:`lock_sim_block` — ``n_sub_steps`` fused timesteps (GPS advance,
  fault rewind, the whole discipline / oracle / workload / arrival / fault
  state machine) per launch, closed-loop, or open-loop when ``open_state``
  is given (``csrc/lock_sim_block.cu``; plain version
  :func:`~repro_torch.kernels.ref.lock_sim_block_ref`).  The blocked
  rollout's kernel.
* :func:`lock_sim_step` — the GPS advance of one step
  (``csrc/lock_sim_step.cu``; :func:`~repro_torch.kernels.ref.lock_sim_step_ref`).
* :func:`lock_transitions_step` — one transition stage, closed or open
  (``csrc/lock_transitions_step.cu``;
  :func:`~repro_torch.kernels.ref.lock_transitions_ref`).  With
  :func:`lock_sim_step` the per-step scan rollout's pair.
* :func:`oracle_step` — one oracle observation per config
  (``csrc/oracle_step.cu``; :func:`~repro_torch.kernels.ref.oracle_update_ref`).

The three simulator kernels share their device code
(``csrc/lock_sim_stages.cuh``): one warp per config row, the stages of a
step as inlined device functions.  All four are bound by the bytes they
move, not by operations (the notes at the top of each source; ``PERF.md``).

The wrappers take the plain version **only** for CPU tensors.  For CUDA
tensors they launch the kernel or raise; there is no fallback.  The
library (:data:`LIBRARY`) is built at first use by ``nvcc`` from the
sources under ``csrc/`` (:mod:`repro_torch.kernels.build`: one compiler
process per source, all at once) into a shared object with a plain C
interface and loaded with ``ctypes``; nothing is compiled or loaded when
this module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import policy as P

from . import build, ref

CSRC = build.CSRC
KERNEL_SOURCES = ("lock_sim_block.cu", "lock_sim_step.cu",
                  "lock_transitions_step.cu", "oracle_step.cu")
KERNEL_HEADERS = ("lock_sim_consts.cuh", "lock_sim_stages.cuh")
#: Compiler flags of every source.  -fmad=false: a contracted FMA differs
#: by one ulp from the plain version's separate multiply and add, which
#: forks the trajectory.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Widest thread axis the kernels carry (4 slots per lane of one warp).
MAX_THREADS = 128

#: Id sets the kernels implement, per id column of the context.
KERNEL_IDS = {
    "policy": frozenset(range(10)),
    "oracle": frozenset(range(4)),
    "workload": frozenset(range(4)),
    "fault": frozenset(range(5)),
    "tb": frozenset(range(2)),
    "arrival": frozenset(range(3)),
}

_STATE_DTYPES = (torch.int32, torch.float32, torch.float32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32) \
    + (torch.int32,) * 8 + (torch.float32,)

#: Context columns the block kernel reads, in the order of the C struct
#: (BLOCK_CONTEXT minus the four open-loop columns), with their dtypes.
#: The transition kernel reads the same columns from ``policy`` on.
_KERNEL_CTX = (
    ("step0", torch.int32), ("limit", torch.int32),
    ("alpha", torch.float32), ("cores", torch.float32),
    ("has_budget", torch.bool), ("policy", torch.int32),
    ("threads", torch.int32), ("dt", torch.float32),
    ("wake", torch.float32), ("cs_lo", torch.float32),
    ("cs_hi", torch.float32), ("ncs_lo", torch.float32),
    ("ncs_hi", torch.float32), ("k", torch.int32),
    ("sws_max", torch.int32), ("spin_budget", torch.float32),
    ("seed", torch.int32), ("oracle", torch.int32),
    ("workload", torch.int32), ("wl_period", torch.float32),
    ("wl_duty", torch.float32), ("wl_burst", torch.float32),
    ("wl_spread", torch.float32), ("tb", torch.int32),
    ("fault", torch.int32), ("flt_rate", torch.float32),
    ("flt_scale", torch.float32), ("park_cost", torch.float32),
)
#: The four open-loop context columns, after ``_KERNEL_CTX`` in the struct
#: (passed to both variants; only the open one reads them).
_OPEN_CTX = (("arrival", torch.int32), ("arr_rate", torch.float32),
             ("q_cap", torch.int32), ("slo", torch.float32))
#: The transition kernel's 27 context columns, in the order it takes them.
_TRANSITION_CTX = _KERNEL_CTX[5:] + _OPEN_CTX

#: dtypes of the 11 OPEN_STATE arrays: ``req_t`` (C, T) f32, ``qbuf``
#: (C, QUEUE_MAX) f32, ``hist`` (C, LAT_NBINS) i32, then the (C,) columns
#: qhead, qlen, arrived, shed, departed, slo_viol (i32), lat_sum, occ_int
#: (f32).
_OPEN_DTYPES = (torch.float32, torch.float32, torch.int32) \
    + (torch.int32,) * 6 + (torch.float32,) * 2


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------
#: The simulator's kernel library (``build/repro_torch/liblock_sim_<hash>.so``).
LIBRARY = build.Library("lock_sim", KERNEL_SOURCES, KERNEL_HEADERS,
                        NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _library():
    """Build (if needed) and load the kernel library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return build.load(LIBRARY, {
        "lock_sim_block_launch": [ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                  i32],
        "lock_sim_step_launch": [ptr, i32, i32],
        "lock_transitions_step_launch": [ptr, ptr, ptr, ptr, i32,
                                         ctypes.c_float, ptr, i32, i32, i32,
                                         i32, i32],
        "oracle_step_launch": [ptr, i32]})


def _launch(name, device, *args):
    """``<name>_launch`` of the library on the current stream of
    ``device`` (:func:`repro_torch.kernels.build.launch`)."""
    build.launch(_library(), name, device, *args)


# --------------------------------------------------------------------------
# Argument checks
# --------------------------------------------------------------------------
def check_id_columns(policy, oracle, workload, fault, tb, arrival, *,
                     open_loop: bool = False) -> None:
    """Raise ``ValueError`` unless every id column lies inside the set the
    kernels implement (:data:`KERNEL_IDS`); a closed launch
    (``open_loop=False``) takes only the closed arrival row.  Reads the
    columns' extremes back to the host — one synchronisation — so a
    rollout calls it once and then passes ``ids_checked=True`` to
    :func:`lock_sim_block` / :func:`lock_transitions_step`."""
    names = ("policy", "oracle", "workload", "fault", "tb", "arrival")
    cols = torch.stack([c.to(torch.int32) for c in
                        (policy, oracle, workload, fault, tb, arrival)])
    lo = cols.min(dim=1).values.tolist()
    hi = cols.max(dim=1).values.tolist()
    for name, a, b in zip(names, lo, hi):
        if name == "arrival" and not open_loop:
            if not a == b == P.AR_CLOSED:
                raise ValueError(f"arrival ids span [{a}, {b}]: the closed "
                                 f"launch takes only the closed row "
                                 f"{P.AR_CLOSED}; open-arrival rows need "
                                 f"open_state")
        _check_id_span(name, a, b)


def check_oracle_ids(oracle_id) -> None:
    """Raise ``ValueError`` unless every oracle id lies in
    ``KERNEL_IDS["oracle"]`` (one synchronisation)."""
    a, b = torch.stack([oracle_id.min(), oracle_id.max()]).tolist()
    _check_id_span("oracle", a, b)


def _check_id_span(name, a, b):
    ok = KERNEL_IDS[name]
    if a < min(ok) or b > max(ok):
        raise ValueError(f"{name} ids span [{a}, {b}]: the kernel "
                         f"implements {sorted(ok)}")


def _check_tensor(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, state is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _thread_axis(name, t):
    """(C, T) of a (C, T) state array, ``T <=`` :data:`MAX_THREADS`."""
    if t.ndim != 2:
        raise ValueError(f"{name}: expected (C, T), got {tuple(t.shape)}")
    C, T = t.shape
    if T > MAX_THREADS:
        raise ValueError(f"T={T} exceeds the kernels' thread axis "
                         f"(MAX_THREADS={MAX_THREADS})")
    return C, T


def _check_state(state, C, T, device, n):
    """The first ``n`` arrays of the canonical carry: (C, T) then (C,)."""
    for i, (name, t, dtype) in enumerate(zip(ref.BLOCK_STATE[:n], state,
                                             _STATE_DTYPES)):
        _check_tensor(name, t, dtype, (C, T) if i < 8 else (C,), device)


def _check_open_state(open_state, C, T, device):
    if len(open_state) != len(ref.OPEN_STATE):
        raise ValueError(f"open_state holds the {len(ref.OPEN_STATE)} "
                         f"OPEN_STATE arrays, got {len(open_state)}")
    shapes = ((C, T), (C, P.QUEUE_MAX), (C, P.LAT_NBINS)) + ((C,),) * 8
    for name, t, dtype, shape in zip(ref.OPEN_STATE, open_state,
                                     _OPEN_DTYPES, shapes):
        _check_tensor(name, t, dtype, shape, device)
    return tuple(open_state)


def _context_ptrs(ctx, names, C, device, scalars=()):
    """Checked data pointers of the context columns ``names`` (``(name,
    dtype)`` pairs); the names in ``scalars`` may be ints (pointer None)."""
    ptrs = []
    for name, dtype in names:
        v = ctx[name]
        if name in scalars and not isinstance(v, torch.Tensor):
            ptrs.append(None)
            continue
        _check_tensor(name, v, dtype, (C,), device)
        ptrs.append(v.data_ptr())
    return ptrs


def _step_operand(name, v, dtype, C, device):
    """``now2`` / ``stepi`` of the transition kernel: a (C,) column, a 0-d
    tensor read by every row, or a Python number.  Returns ``(pointer,
    stride, scalar)``."""
    if not isinstance(v, torch.Tensor):
        return None, 0, v
    if v.ndim == 0:
        _check_tensor(name, v, dtype, (), device)
        return v.data_ptr(), 0, 0
    _check_tensor(name, v, dtype, (C,), device)
    return v.data_ptr(), 1, 0


def _require_cuda(name, device):
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {device}")


def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------
def lock_sim_block(st, rem, wake_at, slept, spun, ctr, ticket,
                   completed_pt, sws, cnt, ewma, wuc, permits, nticket,
                   completed, wake_count, spin_cpu,
                   step0, alpha, cores, has_budget,
                   policy, threads, dt, wake, cs_lo, cs_hi, ncs_lo, ncs_hi,
                   k, sws_max, spin_budget, seed, oracle, workload,
                   wl_period, wl_duty, wl_burst, wl_spread, arrival,
                   arr_rate, q_cap, slo, tb, fault, flt_rate, flt_scale,
                   park_cost, *,
                   n_sub_steps: int, limit=None, open_state=None,
                   ids_checked: bool = False):
    """Time-blocked rollout kernel; signature and results mirror
    :func:`repro_torch.kernels.ref.lock_sim_block_ref`: the 17 updated
    state arrays after ``n_sub_steps`` fused timesteps, and the 11
    OPEN_STATE arrays after them (28 in all) when ``open_state`` is given
    (the open variant of the kernel).

    ``step0`` / ``limit`` are ints or (C,) int32 tensors; ``limit=None``
    masks nothing.  ``ctr`` and ``seed`` are int32 bit patterns of the
    reference's uint32 values.  The state is **not** updated in place:
    outputs are fresh ``torch.empty`` tensors.

    CPU tensors go through the plain version.  CUDA tensors launch the
    kernel on the current stream (no synchronisation) after checking
    device, dtype, shape and contiguity of every operand, ``T <=``
    :data:`MAX_THREADS` (``ValueError`` beyond) and — unless the caller
    vouches with ``ids_checked=True`` after :func:`check_id_columns` —
    that every id column lies in :data:`KERNEL_IDS` (the closed launch
    takes only the closed arrival row).  Each launch adds one to
    ``lock_sim_block.launches`` (closed variant) or
    ``lock_sim_block.open_launches`` (open variant)."""
    state = (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
             sws, cnt, ewma, wuc, permits, nticket, completed, wake_count,
             spin_cpu)
    open_run = open_state is not None
    device = st.device
    if device.type == "cpu":
        return ref.lock_sim_block_ref(
            *state, step0, alpha, cores, has_budget, policy, threads, dt,
            wake, cs_lo, cs_hi, ncs_lo, ncs_hi, k, sws_max, spin_budget,
            seed, oracle, workload, wl_period, wl_duty, wl_burst, wl_spread,
            arrival, arr_rate, q_cap, slo, tb, fault, flt_rate, flt_scale,
            park_cost, n_sub_steps=n_sub_steps, limit=limit,
            open_state=open_state)
    C, T = _thread_axis("st", st)
    _check_state(state, C, T, device, len(state))
    if open_run:
        state = state + _check_open_state(open_state, C, T, device)
    ctx = dict(step0=step0, limit=limit, alpha=alpha, cores=cores,
               has_budget=has_budget, policy=policy, threads=threads, dt=dt,
               wake=wake, cs_lo=cs_lo, cs_hi=cs_hi, ncs_lo=ncs_lo,
               ncs_hi=ncs_hi, k=k, sws_max=sws_max, spin_budget=spin_budget,
               seed=seed, oracle=oracle, workload=workload,
               wl_period=wl_period, wl_duty=wl_duty, wl_burst=wl_burst,
               wl_spread=wl_spread, tb=tb, fault=fault, flt_rate=flt_rate,
               flt_scale=flt_scale, park_cost=park_cost, arrival=arrival,
               arr_rate=arr_rate, q_cap=q_cap, slo=slo)
    ctx_ptrs = _context_ptrs(ctx, _KERNEL_CTX + _OPEN_CTX, C, device,
                             scalars=("step0", "limit"))
    _require_cuda("lock_sim_block", device)
    if not ids_checked:
        check_id_columns(policy, oracle, workload, fault, tb, arrival,
                         open_loop=open_run)

    out = tuple(torch.empty_like(t) for t in state)
    step0_s = 0 if isinstance(step0, torch.Tensor) else int(step0)
    limit_s = (2**31 - 1 if limit is None or isinstance(limit, torch.Tensor)
               else int(limit))
    _launch("lock_sim_block", device,
            _ptr_array([t.data_ptr() for t in state]),
            _ptr_array([t.data_ptr() for t in out]), _ptr_array(ctx_ptrs),
            step0_s, limit_s, C, T, int(n_sub_steps), int(open_run))
    if open_run:
        lock_sim_block.open_launches += 1
    else:
        lock_sim_block.launches += 1
    return out


def lock_sim_step(tstate, rem, alpha, cores, dt, has_budget):
    """GPS advance kernel; signature and results mirror
    :func:`repro_torch.kernels.ref.lock_sim_step_ref`: ``(rem', burn)``,
    ``burn`` the (C,) CPU-seconds spun this step.

    ``tstate`` (C, T) int32, ``rem`` (C, T) f32, ``alpha`` / ``cores`` /
    ``dt`` (C,) f32, ``has_budget`` (C,) bool.  CPU tensors go through the
    plain version; CUDA tensors launch the kernel after the same checks as
    :func:`lock_sim_block`, and each launch adds one to
    ``lock_sim_step.launches``."""
    device = tstate.device
    if device.type == "cpu":
        return ref.lock_sim_step_ref(tstate, rem, alpha, cores, dt,
                                     has_budget)
    C, T = _thread_axis("tstate", tstate)
    _check_state((tstate, rem), C, T, device, 2)
    for name, t, dtype in (("alpha", alpha, torch.float32),
                           ("cores", cores, torch.float32),
                           ("dt", dt, torch.float32),
                           ("has_budget", has_budget, torch.bool)):
        _check_tensor(name, t, dtype, (C,), device)
    _require_cuda("lock_sim_step", device)
    rem_out = torch.empty_like(rem)
    burn = torch.empty_like(dt)
    _launch("lock_sim_step", device,
            _ptr_array([t.data_ptr() for t in (tstate, rem, alpha, cores,
                                               dt, has_budget, rem_out,
                                               burn)]), C, T)
    lock_sim_step.launches += 1
    return rem_out, burn


def lock_transitions_step(st, rem, wake_at, slept, spun, ctr, ticket,
                          completed_pt, sws, cnt, ewma, wuc, permits,
                          nticket, completed, wake_count,
                          now2, stepi, policy, threads, dt, wake, cs_lo,
                          cs_hi, ncs_lo, ncs_hi, k, sws_max, spin_budget,
                          seed, oracle, workload, wl_period, wl_duty,
                          wl_burst, wl_spread, arrival, arr_rate, q_cap,
                          slo, tb, fault, flt_rate, flt_scale, park_cost, *,
                          open_state=None, ids_checked: bool = False):
    """Transition-stage kernel; signature and results mirror
    :func:`repro_torch.kernels.ref.lock_transitions_ref`: the 16 updated
    state arrays, plus the 11 OPEN_STATE arrays (27 in all) when
    ``open_state`` is given (the open variant of the kernel).

    ``now2`` (f32) and ``stepi`` (int32) are each a (C,) column, a 0-d
    tensor or a Python number.  CPU tensors go through the plain version;
    CUDA tensors launch the kernel after the checks of
    :func:`lock_sim_block` (``ids_checked=True`` skips the id check, as
    there).  Each launch adds one to ``lock_transitions_step.launches``
    (closed variant) or ``lock_transitions_step.open_launches`` (open
    variant)."""
    state = (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
             sws, cnt, ewma, wuc, permits, nticket, completed, wake_count)
    open_run = open_state is not None
    device = st.device
    ctx = dict(policy=policy, threads=threads, dt=dt, wake=wake,
               cs_lo=cs_lo, cs_hi=cs_hi, ncs_lo=ncs_lo, ncs_hi=ncs_hi, k=k,
               sws_max=sws_max, spin_budget=spin_budget, seed=seed,
               oracle=oracle, workload=workload, wl_period=wl_period,
               wl_duty=wl_duty, wl_burst=wl_burst, wl_spread=wl_spread,
               arrival=arrival, arr_rate=arr_rate, q_cap=q_cap, slo=slo,
               tb=tb, fault=fault, flt_rate=flt_rate, flt_scale=flt_scale,
               park_cost=park_cost)
    if device.type == "cpu":
        if not isinstance(now2, torch.Tensor) or now2.ndim == 0:
            now2 = torch.as_tensor(now2, dtype=torch.float32).expand(
                st.shape[0])
        return ref.lock_transitions_ref(
            *state, now2, stepi, *(ctx[f] for f in ref.TRANSITION_CONTEXT[2:]),
            open_state=open_state)
    C, T = _thread_axis("st", st)
    _check_state(state, C, T, device, len(state))
    if open_run:
        state = state + _check_open_state(open_state, C, T, device)
    ctx_ptrs = _context_ptrs(ctx, _TRANSITION_CTX, C, device)
    now2_op = _step_operand("now2", now2, torch.float32, C, device)
    stepi_op = _step_operand("stepi", stepi, torch.int32, C, device)
    _require_cuda("lock_transitions_step", device)
    if not ids_checked:
        check_id_columns(policy, oracle, workload, fault, tb, arrival,
                         open_loop=open_run)

    out = tuple(torch.empty_like(t) for t in state)
    _launch("lock_transitions_step", device,
            _ptr_array([t.data_ptr() for t in state]),
            _ptr_array([t.data_ptr() for t in out]), _ptr_array(ctx_ptrs),
            now2_op[0], now2_op[1], float(now2_op[2]), stepi_op[0],
            stepi_op[1], int(stepi_op[2]), C, T, int(open_run))
    if open_run:
        lock_transitions_step.open_launches += 1
    else:
        lock_transitions_step.launches += 1
    return out


def oracle_step(oracle_id, spun, slept, sws, cnt, ewma, k, sws_max, *,
                ids_checked: bool = False):
    """Oracle-observation kernel; signature and results mirror
    :func:`repro_torch.kernels.ref.oracle_update_ref`: ``(delta, cnt',
    ewma')`` int32 with the A16-A17 clamp applied to ``delta``.

    All inputs (C,): int32, ``spun`` / ``slept`` bool or 0/1 int32.  CPU
    tensors go through the plain version; CUDA tensors launch the kernel
    after checking every operand and — unless ``ids_checked=True`` — that
    every oracle id lies in ``KERNEL_IDS["oracle"]`` (the kernel has no
    arm for others).  Each launch adds one to ``oracle_step.launches``."""
    device = oracle_id.device
    if device.type == "cpu":
        return ref.oracle_update_ref(oracle_id, spun, slept, sws, cnt, ewma,
                                     k, sws_max)
    if oracle_id.ndim != 1:
        raise ValueError(f"oracle_id: expected (C,), got "
                         f"{tuple(oracle_id.shape)}")
    C = oracle_id.shape[0]
    ins = []
    for name, t in (("oracle_id", oracle_id), ("spun", spun),
                    ("slept", slept), ("sws", sws), ("cnt", cnt),
                    ("ewma", ewma), ("k", k), ("sws_max", sws_max)):
        if name in ("spun", "slept") and isinstance(t, torch.Tensor) \
                and t.dtype == torch.bool:
            t = t.to(torch.int32)
        _check_tensor(name, t, torch.int32, (C,), device)
        ins.append(t)
    _require_cuda("oracle_step", device)
    if not ids_checked:
        check_oracle_ids(oracle_id)
    out = tuple(torch.empty_like(sws) for _ in range(3))
    _launch("oracle_step", device,
            _ptr_array([t.data_ptr() for t in ins + list(out)]), C)
    oracle_step.launches += 1
    return out


#: Kernel launches made so far, per kernel and variant (CUDA path only; the
#: plain version on CPU tensors does not count).
lock_sim_block.launches = 0
lock_sim_block.open_launches = 0
lock_sim_step.launches = 0
lock_transitions_step.launches = 0
lock_transitions_step.open_launches = 0
oracle_step.launches = 0

"""The hand-written Hopper kernel of the lock simulator and its wrapper.

:func:`lock_sim_block` is the port of the Pallas TPU kernel
``repro/kernels/lock_sim.py:lock_sim_block``: ``n_sub_steps`` fused
timesteps (GPS advance, fault rewind, the whole discipline / oracle /
workload / arrival / fault state machine) per launch, closed-loop, or
open-loop when ``open_state`` is given.  The CUDA C++ source is
``csrc/lock_sim_block.cu`` (one warp per config row, state in registers
across the sub-step loop, the open variant's request ring and latency
histogram in shared memory; bound by operations, not bytes — see the note
at the top of that file).  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.lock_sim_block_ref`.

The wrapper takes the plain version **only** for CPU tensors.  For CUDA
tensors it launches the kernel or raises; there is no fallback.  The
library is built at first use by ``nvcc`` from the sources under ``csrc/``
into a shared object with a plain C interface and loaded with ``ctypes``;
nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.core import policy as P

from . import ref

CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL_SOURCES = ("lock_sim_block.cu",)
KERNEL_HEADERS = ("lock_sim_consts.cuh",)
#: -fmad=false: a contracted FMA differs by one ulp from the plain
#: version's separate multiply and add, which forks the trajectory.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: Widest thread axis the kernel carries (4 slots per lane of one warp).
MAX_THREADS = 128

#: Id sets the kernel implements, per id column of the block context.
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

#: Context columns both variants read, in the order of the C struct
#: (BLOCK_CONTEXT minus the four open-loop columns), with their dtypes.
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

#: dtypes of the 11 OPEN_STATE arrays: ``req_t`` (C, T) f32, ``qbuf``
#: (C, QUEUE_MAX) f32, ``hist`` (C, LAT_NBINS) i32, then the (C,) columns
#: qhead, qlen, arrived, shed, departed, slo_viol (i32), lat_sum, occ_int
#: (f32).
_OPEN_DTYPES = (torch.float32, torch.float32, torch.int32) \
    + (torch.int32,) * 6 + (torch.float32,) * 2


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class BuildResult:
    path: Path            # the shared library
    seconds: float        # 0.0 when an up-to-date library was found
    cached: bool
    log: str              # nvcc / ptxas -v output (registers, spills)


#: Where the library is built: ``build/repro_torch`` at the root of the
#: checkout (``build/`` is git-ignored).
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the lock_sim_block kernel is built "
                       "from csrc/ at first use and needs the CUDA toolkit")


def nvcc_release() -> str:
    """The ``release X.Y, VX.Y.Z`` part of ``nvcc --version``."""
    out = subprocess.run([_find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return next((ln.split("release", 1)[1].strip()
                 for ln in out.splitlines() if "release" in ln), "unknown")


def build_library() -> BuildResult:
    """Compile ``csrc/*.cu`` for sm_90a into one shared library.  The file
    name carries a hash of sources and flags, so a stale build is never
    picked up; an existing up-to-date library is returned as is."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in KERNEL_SOURCES + KERNEL_HEADERS:
        h.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"liblock_sim_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return BuildResult(lib, 0.0, True,
                           log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in KERNEL_SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, False, text)


@functools.lru_cache(maxsize=None)
def _library():
    """Build (if needed) and load the kernel library; argtypes set so
    ctypes passes pointers at full width."""
    lib = ctypes.CDLL(str(build_library().path))
    fn = lib.lock_sim_block_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# Argument checks
# --------------------------------------------------------------------------
def check_id_columns(policy, oracle, workload, fault, tb, arrival, *,
                     open_loop: bool = False) -> None:
    """Raise ``ValueError`` unless every id column lies inside the set the
    kernel implements (:data:`KERNEL_IDS`); a closed launch
    (``open_loop=False``) takes only the closed arrival row.  Reads the
    columns' extremes back to the host — one synchronisation — so a
    rollout calls it once and then passes ``ids_checked=True`` to
    :func:`lock_sim_block`."""
    names = ("policy", "oracle", "workload", "fault", "tb", "arrival")
    cols = torch.stack([c.to(torch.int32) for c in
                        (policy, oracle, workload, fault, tb, arrival)])
    lo = cols.min(dim=1).values.tolist()
    hi = cols.max(dim=1).values.tolist()
    for name, a, b in zip(names, lo, hi):
        ok = KERNEL_IDS[name]
        if name == "arrival" and not open_loop:
            if not a == b == P.AR_CLOSED:
                raise ValueError(f"arrival ids span [{a}, {b}]: the closed "
                                 f"launch takes only the closed row "
                                 f"{P.AR_CLOSED}; open-arrival rows need "
                                 f"open_state")
        if a >= min(ok) and b <= max(ok):
            continue
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


def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


# --------------------------------------------------------------------------
# The wrapper
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
    if device.type != "cuda":
        raise ValueError(f"lock_sim_block runs on cuda or cpu tensors, "
                         f"not {device}")
    if st.ndim != 2:
        raise ValueError(f"st: expected (C, T), got {tuple(st.shape)}")
    C, T = st.shape
    if T > MAX_THREADS:
        raise ValueError(f"T={T} exceeds the kernel's thread axis "
                         f"(MAX_THREADS={MAX_THREADS})")
    for i, (name, t, dtype) in enumerate(zip(ref.BLOCK_STATE, state,
                                             _STATE_DTYPES)):
        _check_tensor(name, t, dtype, (C, T) if i < 8 else (C,), device)
    if open_run:
        if len(open_state) != len(ref.OPEN_STATE):
            raise ValueError(f"open_state holds the {len(ref.OPEN_STATE)} "
                             f"OPEN_STATE arrays, got {len(open_state)}")
        shapes = ((C, T), (C, P.QUEUE_MAX), (C, P.LAT_NBINS)) + ((C,),) * 8
        for name, t, dtype, shape in zip(ref.OPEN_STATE, open_state,
                                         _OPEN_DTYPES, shapes):
            _check_tensor(name, t, dtype, shape, device)
        state = state + tuple(open_state)
    ctx = dict(step0=step0, limit=limit, alpha=alpha, cores=cores,
               has_budget=has_budget, policy=policy, threads=threads, dt=dt,
               wake=wake, cs_lo=cs_lo, cs_hi=cs_hi, ncs_lo=ncs_lo,
               ncs_hi=ncs_hi, k=k, sws_max=sws_max, spin_budget=spin_budget,
               seed=seed, oracle=oracle, workload=workload,
               wl_period=wl_period, wl_duty=wl_duty, wl_burst=wl_burst,
               wl_spread=wl_spread, tb=tb, fault=fault, flt_rate=flt_rate,
               flt_scale=flt_scale, park_cost=park_cost, arrival=arrival,
               arr_rate=arr_rate, q_cap=q_cap, slo=slo)
    scalars = {"step0": 0, "limit": 2**31 - 1}
    ctx_ptrs = []
    for name, dtype in _KERNEL_CTX + _OPEN_CTX:
        v = ctx[name]
        if name in scalars and not isinstance(v, torch.Tensor):
            if v is not None:
                scalars[name] = int(v)
            ctx_ptrs.append(None)
            continue
        _check_tensor(name, v, dtype, (C,), device)
        ctx_ptrs.append(v.data_ptr())
    if not ids_checked:
        check_id_columns(policy, oracle, workload, fault, tb, arrival,
                         open_loop=open_run)

    out = tuple(torch.empty_like(t) for t in state)
    fn = _library().lock_sim_block_launch
    with torch.cuda.device(device):
        err = fn(_ptr_array([t.data_ptr() for t in state]),
                 _ptr_array([t.data_ptr() for t in out]),
                 _ptr_array(ctx_ptrs), scalars["step0"], scalars["limit"],
                 C, T, int(n_sub_steps), int(open_run),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lock_sim_block launch failed: CUDA error {err}")
    if open_run:
        lock_sim_block.open_launches += 1
    else:
        lock_sim_block.launches += 1
    return out


#: Kernel launches made so far, per variant (CUDA path only; the plain
#: version on CPU tensors does not count).
lock_sim_block.launches = 0
lock_sim_block.open_launches = 0

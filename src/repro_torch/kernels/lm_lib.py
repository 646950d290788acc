"""The language model's kernel library: ``csrc/flash_attention.cu`` and
``csrc/flash_attention_sm90.cu`` (K5's SIMT and tensor-core kernels behind
one entry point), ``csrc/rwkv6_scan.cu`` (K6), ``csrc/mamba_scan.cu`` (K7)
and ``csrc/rmsnorm.cu`` (K8, and the empty kernel that times the launch
floor), built into
``build/repro_torch/liblm_<hash>.so`` at the first launch of any of their
wrappers
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rwkv6_scan`, :mod:`repro_torch.kernels.mamba_scan`,
:mod:`repro_torch.kernels.rmsnorm`) by :mod:`repro_torch.kernels.build`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCES = ("flash_attention.cu", "flash_attention_sm90.cu", "rwkv6_scan.cu",
           "mamba_scan.cu", "rmsnorm.cu")
#: Headers the sources share: the Hopper staging rings' barriers and
#: asynchronous copies (K5's tensor-core kernel, K6, K7).
HEADERS = ("sm90_barrier.cuh",)
#: Compiler flags of the sources.  FMA contraction stays on: the kernels
#: are held to their plain versions by a tolerance, not bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARY = build.Library("lm", SOURCES, HEADERS, NVCC_FLAGS)

#: dtype codes of the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Argument types of the entry points that launch, the stream (last) left
#: out: ``lm_empty_launch`` launches an empty kernel, the floor of a launch
#: timed by CUDA events.
SIGNATURES = {
    "flash_attention_launch": [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                               _I32, _I32, _I32, _F32, _F32, _I32],
    "rwkv6_scan_launch": [_PTR] * 8 + [_I32] * 4 + [ctypes.POINTER(_I32)],
    "mamba_scan_launch": [_PTR] * 7 + [_I32] * 5 + [ctypes.POINTER(_I32)],
    "rmsnorm_launch": [_PTR, _PTR, _PTR, _I32, _I32, _F32, _I32],
    "lm_empty_launch": []}
#: Argument types of the entry points that launch nothing (no stream):
#: each kernel's blocks resident on an SM.
QUERIES = {"rwkv6_scan_occupancy": [_I32, _PTR],
           "mamba_scan_occupancy": [_I32, _PTR],
           "rmsnorm_occupancy": [_PTR]}


@functools.lru_cache(maxsize=None)
def library():
    cdll = build.load(LIBRARY, SIGNATURES)
    for name, argtypes in QUERIES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cdll


def query(name, device, *args):
    """The launch-free entry point ``name`` of the library on ``device``;
    raise on the CUDA error it returns."""
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def launch(name, device, *args):
    """``<name>_launch`` of the library on the current stream of
    ``device`` (:func:`repro_torch.kernels.build.launch`)."""
    build.launch(library(), name, device, *args)

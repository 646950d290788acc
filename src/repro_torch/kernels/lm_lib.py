"""The language model's kernel library: ``csrc/flash_attention.cu`` and
``csrc/flash_attention_sm90.cu`` (K5's SIMT and tensor-core kernels behind
one entry point), ``csrc/rwkv6_scan.cu`` (K6), ``csrc/mamba_scan.cu`` (K7)
and ``csrc/rmsnorm.cu`` (K8), built into
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
#: Headers the sources share: the Hopper staging ring's barriers and bulk
#: copies (K5's tensor-core kernel, K6).
HEADERS = ("sm90_barrier.cuh",)
#: Compiler flags of the sources.  FMA contraction stays on: the kernels
#: are held to their plain versions by a tolerance, not bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARY = build.Library("lm", SOURCES, HEADERS, NVCC_FLAGS)

#: dtype codes of the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library():
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cdll = build.load(LIBRARY, {
        "flash_attention_launch": [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   i32, i32, i32, f32, f32, i32],
        "rwkv6_scan_launch": [ptr] * 8 + [i32] * 4 + [ctypes.POINTER(i32)],
        "mamba_scan_launch": [ptr] * 7 + [i32] * 5,
        "rmsnorm_launch": [ptr, ptr, ptr, i32, i32, f32, i32]})
    cdll.rwkv6_scan_occupancy.argtypes = [i32, ptr]  # no stream: no launch
    cdll.rwkv6_scan_occupancy.restype = i32
    return cdll


def launch(name, device, *args):
    """``<name>_launch`` of the library on the current stream of
    ``device`` (:func:`repro_torch.kernels.build.launch`)."""
    build.launch(library(), name, device, *args)

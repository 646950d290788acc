"""The language model's kernel library: ``csrc/flash_attention.cu`` (K5)
and ``csrc/rmsnorm.cu`` (K8), built into ``build/repro_torch/liblm_<hash>.so``
at the first launch of either wrapper
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.rmsnorm`) by :mod:`repro_torch.kernels.build`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCES = ("flash_attention.cu", "rmsnorm.cu")
#: Compiler flags of both sources.  FMA contraction stays on: both kernels
#: are held to their plain versions by a tolerance, not bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARY = build.Library("lm", SOURCES, (), NVCC_FLAGS)

#: dtype codes of the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def library():
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.load(LIBRARY, {
        "flash_attention_launch": [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   i32, i32, i32, f32, f32, i32],
        "rmsnorm_launch": [ptr, ptr, ptr, i32, i32, f32, i32]})


def launch(name, device, *args):
    """``<name>_launch`` of the library on the current stream of
    ``device`` (:func:`repro_torch.kernels.build.launch`)."""
    build.launch(library(), name, device, *args)

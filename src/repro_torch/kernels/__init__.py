"""Kernels of the PyTorch port: plain PyTorch versions (:mod:`.ref`), the
hand-written CUDA kernels with their wrappers (:mod:`.lock_sim`,
:mod:`.flash_attention`, :mod:`.rmsnorm`; sources under ``csrc/``, built by
:mod:`.build` into two libraries) and the model-layout dispatch
(:mod:`.ops`).  Importing this package compiles and loads nothing; a
library is built at the first launch of one of its kernels."""

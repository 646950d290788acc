"""Kernels of the PyTorch port: plain PyTorch versions (:mod:`.ref`) and
the hand-written CUDA kernels with their wrappers (:mod:`.lock_sim`,
sources under ``csrc/``).  Importing this package compiles and loads
nothing; a kernel is built at its first launch."""

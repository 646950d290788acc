"""PyTorch/CUDA port of the mutable-locks simulator (NVIDIA H100).

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only, and nothing of ``repro``.  Ported so far: the batched
simulator, closed and open loop (``repro_torch.core.xdes.simulate_batch``),
through the hand-written CUDA kernel
``repro_torch.kernels.lock_sim.lock_sim_block``, and the memory-budgeted
streamed sweep on top of it (``repro_torch.core.stream.sweep_stream``).
"""

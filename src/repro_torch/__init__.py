"""PyTorch/CUDA port of the mutable-locks system (NVIDIA H100).

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only, and nothing of ``repro``.  Ported so far:

* the batched lock simulator, closed and open loop, blocked and per-step
  rollouts (``repro_torch.core.xdes.simulate_batch``) and its streamed
  sweep (``repro_torch.core.stream.sweep_stream``), through the
  hand-written CUDA kernels of ``repro_torch.kernels.lock_sim``;
* serving a dense decoder (``repro_torch.launch.serve``:
  ``repro_torch.serve.ContinuousBatcher`` over
  ``repro_torch.serve.DecodeEngine`` over ``repro_torch.models``), its
  prefill attention and every RMSNorm through the hand-written CUDA kernels
  ``repro_torch.kernels.flash_attention`` and ``repro_torch.kernels.rmsnorm``.

Entry points run on the card (``device=None``) and raise without one; pass
``device="cpu"`` for the plain PyTorch versions.
"""

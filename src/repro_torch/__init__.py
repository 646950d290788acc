"""PyTorch/CUDA port of the mutable-locks system (NVIDIA H100).

A second package beside the JAX reference ``repro``: it imports ``torch``
and ``numpy`` only, and nothing of ``repro``.  Ported so far:

* the batched lock simulator, closed and open loop, blocked and per-step
  rollouts (``repro_torch.core.xdes.simulate_batch``) and its streamed
  sweep (``repro_torch.core.stream.sweep_stream``), through the
  hand-written CUDA kernels of ``repro_torch.kernels.lock_sim``;
* the sweep layer on top of it: the grids and the six phase-diagram
  writers with their CLIs (``repro_torch.bench``), and the
  scheduler-policy sweep (``repro_torch.serve.xdes_policy_sweep``);
* serving (``repro_torch.launch.serve``: ``repro_torch.serve.
  ContinuousBatcher`` over ``repro_torch.serve.DecodeEngine`` over
  ``repro_torch.models``) of the dense decoders, rwkv6, jamba (mamba,
  attention and MoE layers) and the MoE decoders, through the
  hand-written CUDA kernels ``repro_torch.kernels.flash_attention``,
  ``rwkv6_scan``, ``mamba_scan`` and ``rmsnorm``;
* training (``repro_torch.launch.train``: ``repro_torch.data.
  PrefetchLoader`` and ``repro_torch.runtime.HeartbeatBoard`` around
  ``repro_torch.train.make_train_step`` over ``repro_torch.models.
  loss_fn``), through the same kernels as autograd functions whose
  backwards are tensor code beside them;
* the mesh path over ``torch.distributed`` (``repro_torch.sharding``: the
  reference's specs and profiles, each rank's blocks, the collectives;
  ``repro_torch.launch.mesh``): the decoder-only attention stacks with
  dense or expert-parallel MoE FFNs trained sharded (TP, FSDP, DP; the
  int8-compressed cross-pod step) and decoded context-parallel.

Entry points run on the card (``device=None``) and raise without one; pass
``device="cpu"`` for the plain PyTorch versions.
"""

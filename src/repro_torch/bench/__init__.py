"""The sweep layer of the port: the grids (:mod:`repro_torch.bench.sweep`)
and the six phase-diagram writers that turn a grid's result into CSV and
Markdown (``oracle_ablation``, ``discipline_diagram``, ``workload_diagram``,
``arrival_diagram``, ``fault_diagram``, ``park_diagram``), each with its
CLI.

The grids run :func:`repro_torch.core.xdes.simulate_batch` or
:func:`repro_torch.core.stream.sweep_stream` on the card through the
``lock_sim_block`` kernels (``device="cpu"`` for the plain versions), and
return the reference's result dicts, so one writer reads the results of
either package.  Reports go under ``reports/torch/`` by default.
"""

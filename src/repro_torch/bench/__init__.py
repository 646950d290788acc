"""The sweep layer of the port: the grids (:mod:`repro_torch.bench.sweep`)
and the six phase-diagram writers that turn a grid's result into CSV and
Markdown (``oracle_ablation``, ``discipline_diagram``, ``workload_diagram``,
``arrival_diagram``, ``fault_diagram``, ``park_diagram``), each with its
CLI; and the paper's other artifacts: Fig. 1 and Fig. 3
(``lockbench``), the dt-fidelity study (``fidelity_study``), PHOLD with
real locks (``phold``, host threads only) and the serving-window benchmark
(``sched_bench``), on the port's event-driven DES
(:mod:`repro_torch.core.des`) and its batched engine.

The grids run :func:`repro_torch.core.xdes.simulate_batch` or
:func:`repro_torch.core.stream.sweep_stream` on the card through the
``lock_sim_block`` kernels (``device="cpu"`` for the plain versions), and
return the reference's result dicts, so one writer reads the results of
either package.  Reports go under ``reports/torch/`` by default.
"""

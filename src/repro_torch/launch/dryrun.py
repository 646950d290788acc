"""Multi-pod dry-run: one rank's step of every (arch x shape x mesh) cell,
on the meta device under a fake world.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell on 512 forced host devices; the port has no compiler to ask.
Each cell sets up a ``torch.distributed`` world of the ``fake`` backend
(256 ranks for one pod, 512 for two; no card, no network), plays **rank
0** of it, builds the production mesh (:func:`repro_torch.launch.mesh.
make_production_mesh`) and the rules (:func:`repro_torch.sharding.
profiles.rules_for`), holds rank 0's blocks of the train state, or of the
parameters and the cache, on ``device="meta"`` (shapes, no bytes), and
runs one train step, prefill or decode step of the port's mesh code under
:class:`repro_torch.launch.costanalysis.CostCounter`.  The record is rank
0's, as the reference's is one device's program.  The world is torn down
after each cell.  Nothing here touches a card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # one pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    ... --set seqcarry=model --set fsdp=data,model --tag sp_v2

Records land in ``reports/torch/dryrun/<mesh>/<arch>__<shape>[__tag].json``
with the reference's fields, except that ``lower_s``, ``compile_s``,
``xla_cost`` and ``hlo_bytes`` have no counterpart: ``build_s`` (setting
up the world, the mesh and the rank's blocks), ``step_s`` (the step on
meta) and ``n_ops`` (the kernels the step launches: dispatched ops and
K5–K8) stand in their place.  ``memory`` follows the reference's formula,
``peak = argument + output + temp - alias``: arguments are the rank's
state or parameters, cache and batch rows; ``alias_bytes`` the outputs
that share the arguments' storage (the state the train step updates in
place, the cache a decode step writes); ``temp_bytes`` the most bytes the
step allocates and holds at once, less its new outputs.  A cell whose
step raises is ``failed`` and the sweep goes on; ``--all`` exits 1 if any
cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import contextlib
from contextlib import contextmanager

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs import base as cbase
from repro_torch.launch import costanalysis as ca
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import comm, layout, profiles
from repro_torch.sharding import specs as sh
from repro_torch.train import TrainConfig, init_state

ARCHS = ["gemma3-4b", "llama3.2-1b", "qwen2.5-14b", "stablelm-3b",
         "granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
         "jamba-1.5-large-398b", "chameleon-34b", "rwkv6-1.6b",
         "whisper-large-v3"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: The rank whose step a record describes.
RANK = 0
META = torch.device("meta")


def default_tcfg(cfg) -> TrainConfig:
    n = models.param_count(cfg)
    # grad-accum defaults follow the reference: activation memory scales
    # with the microbatch, and (B/accum) must stay divisible by the 32-way
    # pod2 batch sharding, so 8 is the deepest safe default.
    dl = cfg.d_model * cfg.num_layers
    if n >= 100e9:        # jamba-398b, qwen3-moe-235b: factored states
        return TrainConfig(optimizer="adafactor", master_weights=False,
                           grad_accum=8, accum_dtype="bfloat16")
    if dl >= 200_000:                      # qwen2.5-14b, chameleon-34b
        accum = 8
    elif (dl >= 80_000                     # gemma3, stablelm
          or cfg.family in ("ssm", "hybrid")   # scan-state memory (rwkv6)
          or cfg.is_encoder_decoder):      # two stacks (whisper)
        accum = 4
    else:
        accum = 1
    return TrainConfig(optimizer="adamw", grad_accum=accum)


def model_flops(cfg, shape) -> float:
    """Assignment formula: 6*N_active*D train, 2*N_active*D inference."""
    n_active = models.active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.step != "decode"
                                   else 1)
    mult = 6.0 if shape.step == "train" else 2.0
    return mult * n_active * tokens


@contextmanager
def fake_world(size: int):
    """A ``fake``-backend world of ``size`` ranks in which this process is
    rank :data:`RANK`: collectives return at once and move nothing.  Torn
    down on exit; refuses to start inside another world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=RANK,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def leaves(obj) -> list:
    """Every tensor of a step's arguments or outputs (a module's
    parameters and buffers, dicts, lists)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in leaves(v)]
    return []


def storages(tensors) -> dict:
    """Storage key -> bytes of the distinct storages under ``tensors``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


def _batch(spec: dict, device) -> dict:
    """Zero tensors of ``(shape, dtype)`` pairs (token 0 is valid on a
    real device too)."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in spec.items()}


def build_cell(cfg, shape, mesh, rules, tcfg: TrainConfig, device=META):
    """(step, args, batch, rows) of the cell: ``step(*args)`` runs this
    rank's train step, prefill or decode step of the port on ``device``
    (meta: shapes only), on the mesh under ``rules``, or on one device
    where ``mesh`` is None; the rank's blocks are built and cut before it.
    ``batch`` holds the batch tensors among ``args``, ``rows`` the bytes
    of the rank's rows of them."""
    from repro_torch.configs import inputs as cinputs
    from repro_torch.launch.train import build
    B = shape.global_batch
    scope = (lambda: sh.use_mesh(mesh, rules)) if mesh is not None \
        else contextlib.nullcontext
    if shape.step == "train":
        state = init_state(cfg, tcfg, None, device)
        with scope():
            if mesh is not None:
                state = layout.shard_state(cfg, state, mesh, rules)
            split = comm.batch_axes_for(B) if mesh is not None else ()
        batch = _batch(cinputs.train_inputs(cfg, shape), device)
        rows = ca.tensor_bytes(batch.values()) // comm.axes_size(split, mesh)
        return build(cfg, tcfg, mesh, rules), (state, batch), batch, rows

    model = models.init_params(cfg, None, device)
    with scope():
        split = ()
        if mesh is not None:
            layout.shard_model(cfg, model, mesh, rules)
            split = comm.batch_axes_for(B)
        if shape.step == "prefill":
            batch = {k: comm.local_rows(v, split) for k, v in _batch(
                cinputs.prefill_inputs(cfg, shape), device).items()}
            args = (model, batch)
            fn = lambda m, b: models.prefill(cfg, m, b)
        else:
            cache = models.init_cache(cfg, B, shape.seq_len, device)
            batch = {"tokens": comm.local_rows(torch.zeros(
                (B, 1), dtype=torch.int32, device=device), split)}
            args = (model, cache, batch["tokens"])
            fn = lambda m, c, t: models.decode_step(cfg, m, c, t)

    def step(*a):
        with scope(), torch.no_grad(), comm.batch(split):
            return fn(*a)

    return step, args, batch, ca.tensor_bytes(batch.values())


def measure(step, args, batch: dict, rows: int) -> dict:
    """Run ``step(*args)`` once under a cost counter (:func:`build_cell`'s
    four values): ``{"cost", "memory", "step_s"}``.  ``args`` hold the
    rank's state (parameters, optimizer state, cache) and the ``batch``
    tensors, whose argument bytes are ``rows`` (the rank's rows of
    them)."""
    batch_st = storages(batch.values())
    all_st = storages(leaves(args))
    t0 = time.perf_counter()
    with ca.CostCounter() as counter:
        out = step(*args)
    step_s = time.perf_counter() - t0
    out_st = storages(leaves(out))
    alias = sum(n for k, n in out_st.items() if k in all_st)
    output = sum(out_st.values())
    argument = sum(n for k, n in all_st.items() if k not in batch_st) \
        + rows
    peak = counter.cost.peak_bytes
    temp = max(0, peak - (output - alias))
    return {"cost": counter.cost, "step_s": step_s,
            "memory": {"argument_bytes": argument, "output_bytes": output,
                       "temp_bytes": temp, "alias_bytes": alias,
                       "peak_bytes_per_device": argument + output + temp
                       - alias}}


def cell_record(cfg, shape, world: int, make_mesh, overrides=None,
                tcfg_kw: dict | None = None,
                tcfg: TrainConfig | None = None) -> dict:
    """One cell at rank 0 of a fake world of ``world`` ranks, on the mesh
    ``make_mesh()`` builds in it: the record's status and, where ``ok``,
    its measured fields."""
    rec: dict = {}
    ok, reason = cbase.shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    tcfg = tcfg or default_tcfg(cfg)
    if tcfg_kw:
        tcfg = dataclasses.replace(tcfg, **tcfg_kw)
    t0 = time.perf_counter()
    try:
        with fake_world(world):
            mesh = make_mesh()
            rules = profiles.rules_for(cfg, mesh, shape.step, overrides)
            step, args, batch, rows = build_cell(cfg, shape, mesh, rules,
                                                 tcfg)
            t_build = time.perf_counter() - t0
            got = measure(step, args, batch, rows)
            del step, args, batch
        cost = got["cost"]
        terms = ca.roofline_terms(cost, cost.traffic_bytes)
        mf = model_flops(cfg, shape)
        total = cost.flops * world
        terms["model_flops"] = mf
        terms["useful_ratio"] = mf / total if total else 0.0
        # useful model flops per second at the bound set by the slowest
        # term, against the pure-compute ideal
        t_bound = max(terms["compute_s"], terms["memory_s"],
                      terms["collective_s"])
        ideal = mf / (world * ca.PEAK_FLOPS_BF16)
        terms["roofline_fraction"] = ideal / t_bound if t_bound else 0.0
        rec.update(
            status="ok", rank=RANK, n_chips=world,
            rules={k: rules.resolve(k) for k in rules.__dataclass_fields__},
            optimizer=tcfg.optimizer if shape.step == "train" else None,
            grad_accum=tcfg.grad_accum if shape.step == "train" else None,
            build_s=t_build, step_s=got["step_s"], n_ops=cost.n_ops,
            kernels=cost.kernels, memory=got["memory"], roofline=terms)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             overrides=None, tag: str = "", force: bool = False,
             tcfg_kw: dict | None = None) -> dict:
    mesh_name = "pod2" if multi_pod else "pod1"
    cell_dir = os.path.join(out_dir, mesh_name)
    os.makedirs(cell_dir, exist_ok=True)
    stem = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "")
    path = os.path.join(cell_dir, stem + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "tag": tag, "overrides": dict(overrides or {}),
           "tcfg_kw": dict(tcfg_kw or {})}
    rec.update(cell_record(
        cbase.get_config(arch), cbase.SHAPES[shape_name],
        512 if multi_pod else 256,
        lambda: make_production_mesh(multi_pod=multi_pod), overrides,
        tcfg_kw))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=SHAPES)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) for the chosen mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    help="MeshRules override, e.g. --set seqcarry=model")
    ap.add_argument("--accum", type=int, default=None,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--optimizer", default=None,
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--compress", default=None, choices=["none", "int8"],
                    help="cross-pod gradient compression (needs --multi-pod)")
    ap.add_argument("--accum-dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default="reports/torch/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    overrides = profiles.parse_rule_overrides(args.sets) or None
    tcfg_kw = {}
    if args.accum is not None:
        tcfg_kw["grad_accum"] = args.accum
    if args.optimizer is not None:
        tcfg_kw["optimizer"] = args.optimizer
    if args.compress is not None:
        tcfg_kw["dp_compression"] = args.compress
    if args.accum_dtype is not None:
        tcfg_kw["accum_dtype"] = args.accum_dtype
    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    results = []
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multi_pod, args.out,
                       overrides, args.tag, args.force, tcfg_kw or None)
        r = rec.get("roofline", {})
        print(f"[{rec['status']:>7}] {arch:>24} {shape:<12} "
              f"mesh={rec['mesh']} wall={rec.get('wall_s', 0):>7.1f}s "
              f"dom={r.get('dominant', '-'):<10} "
              f"frac={r.get('roofline_fraction', 0):.3f}"
              + (f"  ({rec.get('reason', rec.get('error', ''))[:60]})"
                 if rec["status"] != "ok" else ""),
              flush=True)
        results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "failed" for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"of {len(results)} cells")
    if n_fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()

"""One rank of the port's mesh checks on the CPU (gloo).

    python tests/torch_mesh_worker.py JOB_DIR RANK WORLD

``JOB_DIR`` holds ``job.json`` (the mesh and the tasks) and
``inputs.npz`` (parameters by the reference's leaf paths, batches); the
ranks meet through a file store in ``JOB_DIR`` (no port), each with one
thread, and rank 0 writes ``out.npz``: global tensors gathered from the
ranks' blocks, or a cost task's log of collectives.  The tests
(``test_torch_mesh.py``, ``test_torch_moe_ep.py``, ``test_torch_dryrun.py``)
start the ranks and hold the results against the JAX package, the port's
one-device runs and the dry-run; ``test_torch_mesh_mixers.py`` too, with
the ``serve`` task (prefill, then decode on from the prefill's cache) and
Adafactor's moments.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs import base as cbase
from repro_torch.configs.catalog import tiny
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import build
from repro_torch.models import convert, moe
from repro_torch.sharding import comm, layout, profiles
from repro_torch.sharding import specs as sh
from repro_torch.train import TrainConfig, state_of
from repro_torch.train import train_step as ts


HERE = os.path.dirname(os.path.abspath(__file__))
#: The scale of the residual an int8 task carries into its step.
EF_PREV = 1e-3
SRC = os.path.join(os.path.dirname(HERE), "src")


def start_ranks(job_dir: str, world: int):
    """Start the ranks of a job (one thread each; no XLA flags)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, __file__, job_dir, str(r),
                              str(world)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout: float = 240.0):
    """Wait for every rank; fail with the stderr of those that failed."""
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errs.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)


def arch_cfg(name: str, capacity_factor: float | None = None,
             dtype: str = "bfloat16", attention: dict | None = None):
    """The tiny config of ``name`` in ``dtype``; ``attention``: fields of
    its attention config replaced."""
    cfg = tiny(cbase.get_config(name)).replace(dtype=dtype,
                                               param_dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    if attention:
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, **attention))
    return cfg


def task_cfg(spec):
    return arch_cfg(spec["arch"], spec.get("capacity_factor"),
                    spec["dtype"], spec.get("attention"))


def model_from(cfg, inp, prefix: str):
    model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = len(prefix) + 1
    convert.load_leaves(cfg, model, {k[n:]: inp[k] for k in inp.files
                                     if k.startswith(prefix + "/")})
    return model


def batch_of(inp, prefix: str) -> dict:
    """tokens, labels, and frames where the batch has them."""
    return {k: torch.from_numpy(inp[f"{prefix}/{k}"])
            for k in ("tokens", "labels", "frames")
            if f"{prefix}/{k}" in inp.files}


def numpy(t):
    return t.detach().float().numpy()


def gather_rows(t, split, mesh):
    return sh.gather_leaf(t, (layout.entry(split),) + (None,) * (t.ndim - 1),
                          mesh)


def task_train(name, job, inp, mesh, out):
    """One train step on the mesh, and its reduced gradients alone: under
    int8 from a residual carried in (:func:`_carried_residual`), the
    dequantized pod sums beside each pod's new residual."""
    spec = job["tasks"][name]
    cfg = task_cfg(spec).replace(remat=spec.get("remat", "none"))
    tcfg = TrainConfig(warmup_steps=2, decay_steps=20, seed=0,
                       optimizer=spec.get("optimizer", "adamw"),
                       dp_compression=spec.get("compression", "none"))
    batch = {k: v if k == "frames" else v[:, :spec.get("seq")]
             for k, v in batch_of(inp, spec["batch"]).items()}
    rules = profiles.rules_for(cfg, mesh, "train", spec.get("overrides"))
    state = state_of(cfg, tcfg, model_from(cfg, inp, spec["params"]))
    with sh.use_mesh(mesh, rules):
        st = layout.shard_state(cfg, state_of(cfg, tcfg, model_from(
            cfg, inp, spec["params"])), mesh, rules)
        if "ef" in st:
            _carried_residual(cfg, name, state, st, mesh, out)
        *_, grads, ef, specs = ts._mesh_grads(cfg, tcfg, st, batch)
        for k, g in grads.items():
            out[f"{name}/g/{k}"] = numpy(sh.gather_leaf(g, specs[k], mesh))
            if ef is not None:
                out[f"{name}/ef/{k}"] = per_pod(sh.gather_leaf(
                    ef[k], specs[k], mesh), mesh)
    state, metrics = build(cfg, tcfg, mesh, rules)(state, batch)
    for k, v in layout.gather_leaves(cfg, state["params"], mesh).items():
        out[f"{name}/p/{k}"] = numpy(v)
    if tcfg.optimizer == "adafactor":
        specs = ts._leaf_specs(cfg, state["params"])
        for k, v in state["opt"]["v"].items():
            if "v_row" in v:
                row, col = layout.factored_specs(specs[k])
                out[f"{name}/v_row/{k}"] = numpy(sh.gather_leaf(
                    v["v_row"], row, mesh))
                out[f"{name}/v_col/{k}"] = numpy(sh.gather_leaf(
                    v["v_col"], col, mesh))
    for k in ("loss", "ce", "aux", "grad_norm"):
        out[f"{name}/{k}"] = np.asarray(float(metrics[k]))
    if "ef" in state:
        ef_max = max(float(e.abs().max()) for e in state["ef"].values())
        ef_max = comm.all_reduce_raw(torch.tensor(ef_max), tuple(
            mesh.axis_names), op=dist.ReduceOp.MAX, mesh=mesh)
        out[f"{name}/ef_max"] = ef_max.numpy()


def per_pod(t, mesh):
    """A tensor that differs between the pods: (pods, ...) of every pod's."""
    return numpy(comm.all_gather_raw(t[None], 0, ts.POD, mesh))


def _carried_residual(cfg, name, state, st, mesh, out):
    """Give the sharded int8 state ``st`` a carried residual ``ef`` drawn
    from a seed for each pod (EF_PREV x N(0, 1), the rank's block of it),
    so that the reduction must add it; written per pod."""
    gen = torch.Generator().manual_seed(7 + mesh.coords[ts.POD])
    specs = ts._leaf_specs(cfg, st["params"])
    for k in st["ef"]:
        full = EF_PREV * torch.randn(state["ef"][k].shape, generator=gen)
        st["ef"][k] = sh.shard_leaf(full, specs[k], mesh)
        out[f"{name}/ef_prev/{k}"] = per_pod(full, mesh)


def task_decode(name, job, inp, mesh, out):
    """Prefill, then decode steps from an empty cache, under the serve
    rules: the logits of every rank's rows gathered."""
    spec = job["tasks"][name]
    cfg = arch_cfg(spec["arch"], dtype=spec["dtype"])
    model = model_from(cfg, inp, spec["params"])
    rules = profiles.rules_for(cfg, mesh, "decode", spec.get("overrides"))
    prompts = torch.from_numpy(inp[f"{spec['batch']}/prompts"])
    steps = torch.from_numpy(inp[f"{spec['batch']}/steps"])
    B = prompts.shape[0]
    with sh.use_mesh(mesh, rules):
        layout.shard_model(cfg, model, mesh, rules)
        split = comm.batch_axes_for(B)
        with torch.no_grad(), comm.batch(split):
            logits, _ = models.prefill(cfg, model, {
                "tokens": comm.local_rows(prompts, split)})
            out[f"{name}/prefill"] = numpy(gather_rows(logits, split, mesh))
            cache = models.init_cache(cfg, B, spec["max_seq"], "cpu")
            seen = []
            for t in range(steps.shape[1]):
                logits, cache = models.decode_step(
                    cfg, model, cache, comm.local_rows(steps[:, t:t + 1],
                                                       split))
                seen.append(numpy(gather_rows(logits, split, mesh)))
            out[f"{name}/decode"] = np.stack(seen, 1)


def widen(cfg, pre, batch: int, max_seq: int, mesh=None):
    """A prefill's cache as a decode cache of ``max_seq`` slots: each k /
    v entry's positions copied into the first slots, every other entry as
    it is.  On a mesh (the mesh context entered) each entry is gathered
    from the prefill's blocks and cut as the decode cache's."""
    cache = models.init_cache(cfg, batch, max_seq, "cpu")
    whole = (lambda t: t) if mesh is None else \
        (lambda t: sh.gather_leaf(t, comm.spec_of(t), mesh))
    for c, p in zip(cache["layers"], pre["layers"]):
        for k, t in c.items():
            full = whole(p[k])
            if k in ("k", "v"):
                wide = torch.zeros(full.shape[:2] + (max_seq,)
                                   + full.shape[3:], dtype=full.dtype)
                wide[:, :, :full.shape[2]] = full
                full = wide
            t.copy_(full if mesh is None else
                    sh.shard_leaf(full, comm.spec_of(t), mesh))
    cache["len"].copy_(pre["len"])
    return cache


def task_serve(name, job, inp, mesh, out):
    """Prefill (frames too, for an encoder-decoder), then decode steps on
    from the prefill's cache, widened to ``max_seq`` slots, under the
    serve rules: the logits of every rank's rows gathered."""
    spec = job["tasks"][name]
    cfg = task_cfg(spec)
    model = model_from(cfg, inp, spec["params"])
    rules = profiles.rules_for(cfg, mesh, "decode", spec.get("overrides"))
    batch = {k: torch.from_numpy(inp[f"{spec['batch']}/{k}"])
             for k in ("prompts", "frames")
             if f"{spec['batch']}/{k}" in inp.files}
    steps = torch.from_numpy(inp[f"{spec['batch']}/steps"])
    B = steps.shape[0]
    with sh.use_mesh(mesh, rules):
        layout.shard_model(cfg, model, mesh, rules)
        split = comm.batch_axes_for(B)
        with torch.no_grad(), comm.batch(split):
            logits, pre = models.prefill(cfg, model, {
                ("tokens" if k == "prompts" else k): comm.local_rows(v, split)
                for k, v in batch.items()})
            out[f"{name}/prefill"] = numpy(gather_rows(logits, split, mesh))
            cache = widen(cfg, pre, B, spec["max_seq"], mesh)
            seen = []
            for t in range(steps.shape[1]):
                logits, cache = models.decode_step(
                    cfg, model, cache, comm.local_rows(steps[:, t:t + 1],
                                                       split))
                seen.append(numpy(gather_rows(logits, split, mesh)))
            out[f"{name}/decode"] = np.stack(seen, 1)


def task_moe(name, job, inp, mesh, out):
    """moe_ep (train rules: expert weights FSDP over data) and the mesh half
    of moe_decode (serve rules) on one MoE layer's weights."""
    spec = job["tasks"][name]
    cfg = arch_cfg(spec["arch"], spec.get("capacity_factor"), spec["dtype"])
    mcfg = cfg.moe
    x = torch.from_numpy(inp[f"{name}/x"])
    xd = torch.from_numpy(inp[f"{name}/x_decode"])
    w = {k: torch.from_numpy(inp[f"{name}/{k}"])
         for k in ("router", "w_gate", "w_in", "w_out")}
    for step, fn in (("train", "ep"), ("decode", "decode")):
        rules = profiles.rules_for(cfg, mesh, step)
        specs = sh.param_specs({f"stack/0/moe/{k}": (1,) + tuple(v.shape)
                                for k, v in w.items()}, mesh, rules)
        params = {}
        for k, v in w.items():
            s = specs[f"stack/0/moe/{k}"][1:]
            params[k] = layout.tagged(sh.shard_leaf(v, s, mesh), s)
        with sh.use_mesh(mesh, rules), torch.no_grad():
            if fn == "ep":
                split = comm.batch_axes_for(x.shape[0])
                with comm.batch(split):
                    y, aux = moe.moe_ep(mcfg, params, comm.local_rows(
                        x, split), cfg.act)
                    out[f"{name}/ep_out"] = gather_rows(y, split,
                                                        mesh).numpy()
                    out[f"{name}/ep_aux"] = aux.numpy()
                    kept = _kept(mcfg, params, comm.local_rows(x, split))
                    out[f"{name}/ep_kept"] = comm.all_gather_raw(
                        comm.all_gather_raw(kept[None], 0, "model"), 0,
                        "data").numpy()
            else:
                split = comm.batch_axes_for(xd.shape[0])
                y = moe.moe_decode(mcfg, params, comm.local_rows(xd, split),
                                   cfg.act)
                out[f"{name}/decode_out"] = gather_rows(y, split,
                                                        mesh).numpy()


def _kept(mcfg, params, x):
    """This rank's routing and dispatch, as moe_ep makes them: (T, k) of
    expert id where the assignment was kept, else -1 (-2 pads)."""
    ep = sh.current_mesh().shape[moe.EP_AXIS]
    Bl, S, D = x.shape
    xl = comm.split(x, 1, (moe.EP_AXIS,)) if S % ep == 0 else x
    tokens = xl.reshape(-1, D)
    gates, eidx, _ = moe.route(mcfg, comm.weight(params["router"]), tokens)
    cap = moe.capacity_of(mcfg, tokens.shape[0])
    _, _, _, keep, _ = moe._dispatch_local(mcfg, tokens, gates, eidx, cap)
    return torch.where(keep.reshape(eidx.shape), eidx, -1)


def task_cost(name, job, inp, mesh, out):
    """One dry-run cell's step (``launch.dryrun.build_cell``) of a tiny
    arch on the rank's CPU tensors under a cost counter: the collectives
    it logged, as JSON."""
    from repro_torch.launch import costanalysis, dryrun
    spec = job["tasks"][name]
    cfg = tiny(cbase.get_config(spec["arch"]))
    shape = cbase.ShapeConfig(name, spec["seq"], spec["batch"], spec["step"])
    rules = profiles.rules_for(cfg, mesh, shape.step)
    step, args, _, _ = dryrun.build_cell(cfg, shape, mesh, rules,
                                         TrainConfig(), device="cpu")
    with costanalysis.CostCounter() as counter:
        step(*args)
    c = counter.cost
    out[f"{name}/log"] = np.array(json.dumps({
        "collective_operand_bytes": c.collective_operand_bytes,
        "collective_wire_bytes": c.collective_wire_bytes,
        "collective_count": c.collective_count}))


TASKS = {"train": task_train, "decode": task_decode, "serve": task_serve,
         "moe": task_moe, "cost": task_cost}


def main(job_dir: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job_dir}/store",
                            rank=rank, world_size=world)
    job = json.load(open(os.path.join(job_dir, "job.json")))
    inp = np.load(os.path.join(job_dir, "inputs.npz"))
    mesh = make_test_mesh(**job["mesh"])
    out: dict = {}
    for name, spec in job["tasks"].items():
        TASKS[spec["kind"]](name, job, inp, mesh, out)
    if rank == 0:
        np.savez(os.path.join(job_dir, "out.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

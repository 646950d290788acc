"""End-to-end training: data pipeline -> train loop -> checkpoints,
with heartbeat monitoring and crash-safe resume.

The port of ``repro/launch/train.py``.  It runs on the card unless told
otherwise; on the CPU with ``--device cpu`` (tiny configs):

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --tiny --device cpu --steps 60 --batch 8 --seq 128 --ckpt-dir DIR

The loop is the reference's: the prefetch depth self-tunes (the
``PrefetchLoader``'s spinning window over a ``MutableLock``'d buffer),
checkpoints are async + atomic (the port's ``CheckpointManager``), a
heartbeat board is kept per step, and ``--fail-at`` stops the run after
that step to show that a rerun resumes from the last checkpoint.  The
train step runs eagerly (no ``jax.jit`` counterpart).

``--mesh`` (``use_mesh_flag``) trains on the reference's production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: 16 x 16 ranks):
the process group must already hold 256 ranks (the CLI initialises it
from torchrun's environment where that is set); any other world raises
``ValueError``.  Under torchrun each rank takes the card of its
``LOCAL_RANK`` before it joins the group, holds its blocks of the state
there (:func:`rank_device`), and writes and restores its own checkpoint
under ``<ckpt-dir>/rank<r>``.

A checkpoint holds ``{"params": {the reference's leaf path: tensor}, "opt":
the optimizer's state, "step"}`` (:func:`checkpoint_tree`): the
parameters by :func:`repro_torch.models.convert.param_leaves`, a layer's
tensors stacked over the periods as the reference stacks them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as cbase
from repro_torch.configs import catalog
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.runtime import HeartbeatBoard, StragglerMonitor
from repro_torch.sharding import comm, layout, profiles
from repro_torch.sharding import specs as sh
from repro_torch.train import TrainConfig, init_state, make_train_step


def build(cfg, tcfg, mesh=None, rules=None):
    """The train step, run eagerly.  With a mesh: the step under
    ``use_mesh(mesh, rules)`` (default rules: the train profile); a state
    of global tensors is cut into the rank's blocks on its first call (as
    the reference's jit reshards its state)."""
    step_fn = make_train_step(cfg, tcfg)
    if mesh is None:
        return step_fn
    if rules is None:
        rules = profiles.rules_for(cfg, mesh, "train")

    def wrapped(state, batch):
        with sh.use_mesh(mesh, rules):
            if not _is_sharded(state):
                state = layout.shard_state(cfg, state, mesh, rules)
            return step_fn(state, batch)

    return wrapped


def _is_sharded(state) -> bool:
    return any(hasattr(p, comm.SPEC) for p in state["params"].parameters())


def checkpoint_tree(cfg, state) -> dict:
    """The state as a checkpoint writes it: the parameters by the
    reference's leaf paths (stacked copies), the optimizer's state and the
    step."""
    return {"params": {k: convert.stack_leaf(v) for k, v in
                       convert.param_leaves(cfg, state["params"]).items()},
            "opt": state["opt"], "step": state["step"]}


def _load_into(target, tree) -> None:
    """Copy a restored tree (numpy leaves: the optimizer's f32 and int32
    state) into ``target``'s tensors, in place."""
    if isinstance(target, dict):
        for k, v in target.items():
            _load_into(v, tree[k])
        return
    with torch.no_grad():
        target.copy_(torch.from_numpy(np.array(tree)))


def restore(cfg, state, mgr: CheckpointManager):
    """Load the manager's latest checkpoint into ``state`` in place:
    (the restored step or None, state)."""
    step, tree = mgr.restore(checkpoint_tree(cfg, state))
    if step is None:
        return None, state
    convert.load_leaves(cfg, state["params"], tree["params"])
    _load_into(state["opt"], tree["opt"])
    _load_into(state["step"], tree["step"])
    return step, state


def rank_device(device=None) -> torch.device:
    """The device this rank trains on: :func:`resolve_device`'s, with the
    card named (``cuda`` -> ``cuda:<current>``, the card that
    ``torch.cuda.set_device`` made current)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def train_loop(cfg, tcfg, steps: int, batch: int, seq: int,
               ckpt_dir: str | None, ckpt_every: int = 20,
               fail_at: int | None = None, host_id: int = 0,
               log_every: int = 10, use_mesh_flag: bool = False,
               device=None, on_step=None):
    """Train ``steps`` steps of ``batch`` x ``seq`` tokens on ``device``
    (default: the card), checkpointing every ``ckpt_every`` steps into
    ``ckpt_dir`` (if given) and resuming from its latest checkpoint.
    ``on_step(step, metrics)``, if given, is called after each step.
    Returns ``{"losses", "state", "loader", "monitor"}`` (the loader's
    ``stats`` and the monitor's report), or ``{"died_at", "losses"}``
    after ``fail_at``."""
    mesh = None
    if use_mesh_flag:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
    device = rank_device(device)
    step_fn = build(cfg, tcfg, mesh)

    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=tcfg.seed))
    loader = PrefetchLoader(corpus, workers=2)
    board = HeartbeatBoard(n_hosts=1)
    monitor = StragglerMonitor(board, dead_after_s=60.0)
    if ckpt_dir and mesh is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank():05d}")
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None

    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    state = init_state(cfg, tcfg, gen, device)
    if mesh is not None:
        rules = profiles.rules_for(cfg, mesh, "train")
        with sh.use_mesh(mesh, rules):
            state = layout.shard_state(cfg, state, mesh, rules)
    start = 0
    if mgr is not None:
        got, state = restore(cfg, state, mgr)
        if got is not None:
            start = got + 1
            print(f"[resume] restored step {got} from {ckpt_dir}")
            # fast-forward the data stream for exactly-once consumption
            loader.next_consume = start
            loader.next_produce = max(loader.next_produce, start)

    losses = []
    t0 = time.time()
    try:
        for step in range(start, steps):
            batch_np = loader.get()
            state, metrics = step_fn(state, batch_np)
            loss = float(metrics["loss"])
            losses.append(loss)
            board.beat(host_id, step)
            if on_step is not None:
                on_step(step, metrics)
            if mgr is not None and step > 0 and step % ckpt_every == 0:
                mgr.save(step, checkpoint_tree(cfg, state))
            if fail_at is not None and step == fail_at:
                print(f"[failure-injection] dying at step {step} "
                      f"(last ckpt <= {step - step % ckpt_every})")
                return {"died_at": step, "losses": losses}
            if step % log_every == 0:
                print(f"step {step:>5}  loss {loss:8.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"({(time.time() - t0):.1f}s)", flush=True)
        rep = monitor.wait_for_step(steps - 1, timeout_s=1.0)
        if mgr is not None:
            mgr.save(steps - 1, checkpoint_tree(cfg, state))
    finally:
        if mgr is not None:
            mgr.wait()
            mgr.close()
        loader.close()
    print(f"done: {steps - start} steps, final loss {losses[-1]:.4f}, "
          f"prefetch late-rate "
          f"{loader.stats['empty_gets']}/{loader.stats['gets']}, "
          f"monitor ready={rep.ready}")
    return {"losses": losses, "state": state, "loader": loader.stats,
            "monitor": rep}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="the production mesh: a world of 256 ranks "
                         "(torchrun's environment), else ValueError")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh and "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # torchrun starts a rank a card: take it before NCCL sees the group
        if ("LOCAL_RANK" in os.environ
                and resolve_device(args.device).type == "cuda"):
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(init_method="env://")
    cfg = cbase.get_config(args.arch)
    if args.tiny:
        cfg = catalog.tiny(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       decay_steps=max(100, args.steps),
                       grad_accum=args.accum)
    return train_loop(cfg, tcfg, args.steps, args.batch, args.seq,
                      args.ckpt_dir, ckpt_every=args.ckpt_every,
                      fail_at=args.fail_at, use_mesh_flag=args.mesh,
                      device=args.device)


if __name__ == "__main__":
    main()

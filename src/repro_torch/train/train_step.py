"""The factories of train_step and eval_step.

The port of ``repro/train/train_step.py``.  ``make_train_step(cfg, tcfg)``
returns

    train_step(state, batch) -> (state', metrics)

where ``state = {"params": the model (a Transformer or an EncDec whose
parameters require grad), "opt": the optimizer's state, "step": an int32
0-d tensor}``.  The step computes the loss and its gradients through the
model's kernels and their backwards (:func:`_grads_plain`, with
``tcfg.grad_accum`` microbatches summed in ``tcfg.accum_dtype``), hands
the optimizer the reference's leaves (the gradients and parameters of a
layer stacked over the periods, or over an encoder-decoder's two stacks,
by the reference's paths:
:func:`repro_torch.models.convert.param_leaves`) and writes the updates
back into the model's parameters in place.

Under a mesh (``specs.use_mesh``, the state cut into the rank's blocks by
:func:`repro_torch.sharding.layout.shard_state`) the step takes the global
batch and computes on the rank's rows of it (split over the ``batch``
rule's axes, which must divide it; with ``grad_accum`` each microbatch is
the reference's, its rows split alike).  The loss is the global one; each
gradient is summed over the batch's axes (an FSDP weight's gather already
summed it over the ``fsdp`` axes), and the clipping norm is the global
norm over the distinct blocks.

``dp_compression="int8"`` is the reference's error-feedback compression
of the cross-pod all-reduce: each pod computes its gradients on its part
of the batch (combined over its own data axes), adds the carried residual
``ef``, and the pods sum int8 values (widened to int32) under one scale a
leaf, the max over the pods; the quantization residual stays local.  It
needs a ``pod`` mesh axis and raises ``ValueError`` without one, as the
reference's assert does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert
from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh

from .optimizer import TrainConfig, apply_updates, make_optimizer

POD = "pod"


def _flat(leaves: dict) -> list:
    """The parameters of :func:`convert.param_leaves`, leaf by leaf."""
    return [t for leaf in leaves.values()
            for t in (leaf if isinstance(leaf, tuple) else (leaf,))]


def _regroup(leaves: dict, tensors) -> dict:
    """Per-parameter tensors (in :func:`_flat`'s order) as the leaves':
    a stacked leaf's stacked over its periods."""
    it = iter(tensors)
    return {k: (torch.stack([next(it) for _ in leaf])
                if isinstance(leaf, tuple) else next(it))
            for k, leaf in leaves.items()}


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               generator: torch.Generator | None = None, device=None):
    """Parameters from ``generator`` on ``device`` (default: the card),
    unfrozen for training, the optimizer's initial state over the
    reference's leaves, step 0; with ``dp_compression="int8"`` the error
    feedback ``ef``, f32 zeros of every leaf's shape."""
    return state_of(cfg, tcfg, models.init_params(cfg, generator, device))


def state_of(cfg: ModelConfig, tcfg: TrainConfig, model):
    """The train state around an existing model (e.g. weights carried over
    from elsewhere), which it unfreezes: the optimizer's initial state,
    step 0."""
    model.requires_grad_(True)
    leaves = convert.param_leaves(cfg, model)
    params = {k: convert.stack_leaf(v) for k, v in leaves.items()}
    state = {"params": model, "opt": make_optimizer(tcfg).init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=models.device_of(model))}
    if tcfg.dp_compression == "int8":
        state["ef"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}
    return state


def _split_microbatches(batch: dict, n: int) -> list:
    """(B, ...) -> n microbatches of (B/n, ...) for every leaf; under a
    mesh this rank's rows of each.  The microbatch must stay divisible by
    the batch-splitting degree."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into grad_accum={n} "
                         f"equal microbatches")
    split = comm.batch_split()
    dp = comm.axes_size(split)
    if (b // n) % dp:
        raise ValueError(
            f"microbatch {b}//{n}={b // n} not divisible by the "
            f"batch-sharding degree {dp}; lower grad_accum")
    return [{k: comm.local_rows(v[i * (b // n):(i + 1) * (b // n)], split)
             for k, v in batch.items()} for i in range(n)]


def _grads_plain(cfg: ModelConfig, model, batch: dict, accum: int = 1,
                 accum_dtype: str = "float32"):
    """(loss, {"ce", "aux"}, grads by the reference's leaf paths).  With
    ``accum`` > 1 the batch is split into microbatches whose gradients are
    summed in ``accum_dtype``, then scaled by 1 / accum in f32."""
    leaves = convert.param_leaves(cfg, model)
    flat = _flat(leaves)

    def one(mb):
        loss, metrics = models.family(cfg).loss_fn(cfg, model, mb)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if accum <= 1:
        loss, metrics, grads = one(_split_microbatches(batch, 1)[0])
        return loss, metrics, _regroup(leaves, grads)
    adt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[accum_dtype]
    acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in flat]
    l_tot = a_tot = 0.0
    for mb in _split_microbatches(batch, accum):
        loss, metrics, grads = one(mb)
        for a, g in zip(acc, grads):
            a.add_(g.to(adt))
        del grads
        l_tot, a_tot = l_tot + loss, a_tot + metrics["aux"]
    inv = 1.0 / accum
    grads = [a.float() * inv for a in acc]
    del acc
    return (l_tot * inv, {"ce": l_tot * inv, "aux": a_tot * inv},
            _regroup(leaves, grads))


def _on(model, batch: dict) -> dict:
    dev = models.device_of(model)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


# --------------------------------------------------------------------------
# The mesh: gradient reduction and the int8 error-feedback compression
# --------------------------------------------------------------------------
def _leaf_specs(cfg: ModelConfig, model) -> dict:
    """The spec of each leaf of :func:`convert.param_leaves` (stacked: the
    period dim unsplit), read off the sharded parameters."""
    out = {}
    for k, leaf in convert.param_leaves(cfg, model).items():
        t = leaf[0] if isinstance(leaf, tuple) else leaf
        spec = getattr(t, comm.SPEC, None)
        if spec is None:
            raise ValueError(f"{k} is not sharded: cut the state with "
                             f"sharding.layout.shard_state first")
        out[k] = ((None,) + spec) if isinstance(leaf, tuple) else spec
    return out


def _spec_axes(spec) -> tuple:
    return tuple(a for e in spec for a in sh.entry_axes(e))


def _reduce_grads(grads: dict, specs: dict, axes: tuple) -> dict:
    """Sum each gradient over ``axes`` less those its FSDP gather summed."""
    out = {}
    for k, g in grads.items():
        done = comm.gathered_axes(specs[k])
        out[k] = comm.all_reduce_raw(g, tuple(a for a in axes
                                              if a not in done))
    return out


def _quantized_psum(g, spec):
    """int8 quantized sum of an f32 leaf's blocks over the pods: (the
    dequantized mean, the local quantization residual).  The scale is the
    leaf's max |g| over every block and pod, over 127."""
    scale = torch.clamp_min(g.abs().max() / 127.0, 1e-12)
    scale = comm.all_reduce_raw(scale, _spec_axes(spec) + (POD,),
                                op=dist.ReduceOp.MAX)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = comm.all_reduce_raw(q.to(torch.int32), (POD,))
    n = comm.axes_size((POD,))
    deq = total.float() * scale / n
    return deq, g - q.float() * scale


def _mesh_grads(cfg: ModelConfig, tcfg: TrainConfig, state, batch):
    """(loss, metrics, grads, ef) of the rank's blocks under the mesh."""
    mesh, model = sh.current_mesh(), state["params"]
    b = next(iter(batch.values())).shape[0]
    split = comm.batch_axes_for(b)
    wanted = tuple(a for a in sh.entry_axes(sh.current_rules().batch)
                   if a in mesh.axis_names)
    if split != wanted:
        raise ValueError(f"batch {b} does not split over the batch axes "
                         f"{wanted}: the port computes on split rows only")
    int8 = tcfg.dp_compression == "int8"
    if int8 and POD not in mesh.axis_names:
        raise ValueError("int8 DP compression needs a 'pod' mesh axis")
    reduce = tuple(a for a in split if not (int8 and a == POD))
    if not set(comm.fsdp_axes()) <= set(reduce):
        raise NotImplementedError(
            f"fsdp axes {comm.fsdp_axes()} outside the gradient's "
            f"reduction axes {reduce}")
    specs = _leaf_specs(cfg, model)
    with comm.batch(split, reduce):
        loss, metrics, grads = _grads_plain(cfg, model, batch,
                                            tcfg.grad_accum,
                                            "float32" if int8
                                            else tcfg.accum_dtype)
    grads = _reduce_grads(grads, specs, reduce)
    ef = None
    if int8:
        pairs = {k: _quantized_psum(g.float() + state["ef"][k], specs[k])
                 for k, g in grads.items()}
        grads = {k: p[0] for k, p in pairs.items()}
        ef = {k: p[1] for k, p in pairs.items()}
        n = comm.axes_size((POD,))
        loss = comm.all_reduce_raw(loss, (POD,)) / n
        metrics = {k: comm.all_reduce_raw(v, (POD,)) / n
                   for k, v in metrics.items()}
    return loss, metrics, grads, ef, specs


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    opt = make_optimizer(tcfg)

    def train_step(state, batch):
        model = state["params"]
        batch = _on(model, batch)
        ef = None
        if sh.active():
            loss, metrics, grads, ef, specs = _mesh_grads(cfg, tcfg, state,
                                                          batch)
            step_opt = make_optimizer(tcfg, specs=specs)
        elif tcfg.dp_compression == "int8":
            raise ValueError("int8 DP compression needs a 'pod' mesh axis")
        else:
            loss, metrics, grads = _grads_plain(cfg, model, batch,
                                                tcfg.grad_accum,
                                                tcfg.accum_dtype)
            step_opt = opt
        leaves = convert.param_leaves(cfg, model)
        params = {k: convert.stack_leaf(v) for k, v in leaves.items()}
        updates, opt_state = step_opt.update(grads, state["opt"], params,
                                             state["step"])
        del grads, params
        # each parameter takes its slice of its leaf's update
        own, upd = {}, {}
        for k, leaf in leaves.items():
            for i, p in enumerate(leaf if isinstance(leaf, tuple)
                                  else (leaf,)):
                own[(k, i)] = p
                upd[(k, i)] = (updates[k][i] if isinstance(leaf, tuple)
                               else updates[k])
        apply_updates(own, upd)
        new_state = {"params": model, "opt": opt_state,
                     "step": state["step"] + 1}
        if ef is not None:
            new_state["ef"] = ef
        out_metrics = {"loss": loss, **metrics,
                       "grad_norm": opt_state["grad_norm"],
                       "lr": opt_state["lr"]}
        return new_state, out_metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = models.family(cfg).loss_fn(cfg, params,
                                                       _on(params, batch))
        return {"loss": loss, **metrics}
    return eval_step

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
back into the model's parameters in place.  The reference's int8
error-feedback compression of the cross-pod all-reduce needs a pod mesh
and raises here (ROADMAP.md A7, S5: n/a on 1xH100).
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.models import convert

from .optimizer import TrainConfig, apply_updates, make_optimizer

_NO_POD_MESH = ("dp_compression='int8' compresses the cross-pod gradient "
                "all-reduce and needs a pod mesh (ROADMAP.md A7, S5: n/a on "
                "1xH100)")


def _check(tcfg: TrainConfig) -> None:
    if tcfg.dp_compression != "none":
        raise NotImplementedError(_NO_POD_MESH)


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
    reference's leaves, step 0."""
    _check(tcfg)
    return state_of(cfg, tcfg, models.init_params(cfg, generator, device))


def state_of(cfg: ModelConfig, tcfg: TrainConfig, model):
    """The train state around an existing model (e.g. weights carried over
    from elsewhere), which it unfreezes: the optimizer's initial state,
    step 0."""
    model.requires_grad_(True)
    leaves = convert.param_leaves(cfg, model)
    opt = make_optimizer(tcfg).init(
        {k: convert.stack_leaf(v) for k, v in leaves.items()})
    return {"params": model, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=models.device_of(model))}


def _split_microbatches(batch: dict, n: int) -> list:
    """(B, ...) -> n microbatches of (B/n, ...) for every leaf."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into grad_accum={n} "
                         f"equal microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


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
        loss, metrics, grads = one(batch)
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    _check(tcfg)
    opt = make_optimizer(tcfg)

    def train_step(state, batch):
        model = state["params"]
        batch = _on(model, batch)
        loss, metrics, grads = _grads_plain(cfg, model, batch,
                                            tcfg.grad_accum,
                                            tcfg.accum_dtype)
        leaves = convert.param_leaves(cfg, model)
        params = {k: convert.stack_leaf(v) for k, v in leaves.items()}
        updates, opt_state = opt.update(grads, state["opt"], params,
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

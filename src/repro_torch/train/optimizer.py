"""Optimizers from scratch: AdamW, Adafactor and SGD over dicts of tensors.

The port of ``repro/train/optimizer.py``.  The reference's optimizers walk
pytrees; these walk dicts keyed by leaf name.  The train step hands them
the reference's leaves (:func:`repro_torch.models.convert.param_leaves`: a
layer's tensor stacked over the periods), so that the rules that read a
leaf's rank or its whole extent (no weight decay under two dims,
Adafactor's factored second moments over the last two dims and its
per-leaf update clipping and scale) see what the reference sees.  The math
is f32, as in the reference.  AdamW's moments and Adafactor's second
moments are updated in place: the state handed in is the state handed
back.

API (mirrors the optax triple, but plain functions):

    opt = make_optimizer(tcfg)              # tcfg: TrainConfig
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)   # in place

Under a mesh each rank holds its blocks of the leaves, and the train step
passes ``specs`` (leaf -> its spec, the stacked period dim unsplit): the
clipping norm sums each leaf's squares over the axes its blocks differ
over, so that it is the global norm.  AdamW and SGD are elementwise
otherwise.  Adafactor's means are the whole leaf's, where GSPMD would
reduce them: the row mean (over the columns) and the column mean (over
the rows) each sum over only the axes that split the dim they average,
as does ``mean(v_row)``, and the update's RMS and the parameter's scale
over every axis that splits the leaf; each sum is divided by the global
count.  ``v_row`` / ``v_col`` hold the rank's blocks of the leaf's rows /
columns (:func:`repro_torch.sharding.layout.factored_specs`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.sharding import comm
from repro_torch.sharding import specs as sh

f32 = torch.float32


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"            # adamw | adafactor | sgd
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    # adafactor
    factored: bool = True
    master_weights: bool = False        # fp32 master copy (off: update in-place)
    # gradient accumulation (microbatches per optimizer step)
    grad_accum: int = 1
    # dtype of the accumulation buffer: float32 (exact) or bfloat16
    accum_dtype: str = "float32"
    # int8 error-feedback compression of the cross-pod all-reduce (needs a
    # pod mesh axis)
    dp_compression: str = "none"        # none | int8
    seed: int = 0


# --------------------------------------------------------------------------
# LR schedule: linear warmup -> cosine decay to min_lr_ratio
# --------------------------------------------------------------------------
def lr_schedule(tcfg: TrainConfig, step):
    """The learning rate at ``step`` (an int or a tensor), an f32 tensor
    on the step's device."""
    step = torch.as_tensor(step).to(f32)
    warm = torch.clamp_max((step + 1.0) / max(1, tcfg.warmup_steps), 1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(1, tcfg.decay_steps - tcfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = tcfg.min_lr_ratio + (1.0 - tcfg.min_lr_ratio) * cos
    return tcfg.learning_rate * warm * scale


# --------------------------------------------------------------------------
# Global-norm clipping
# --------------------------------------------------------------------------
def global_norm(tree: dict, norm_axes: dict | None = None):
    """sqrt of the sum of every leaf's squares, in f32 (leaves in sorted
    name order).  With ``norm_axes`` (a mesh's blocks) each leaf's sum is
    summed over the axes its blocks differ over, leaves sharing axes
    together."""
    sums = [torch.sum(torch.square(tree[k].to(f32))) for k in sorted(tree)]
    if norm_axes is not None:
        groups: dict = {}
        for k, s in zip(sorted(tree), sums):
            groups.setdefault(norm_axes[k], []).append(s)
        sums = [comm.all_reduce_raw(torch.sum(torch.stack(v)), axes)
                for axes, v in groups.items()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: dict, max_norm: float,
                        norm_axes: dict | None = None):
    """(the grads in f32, scaled so that their global norm is at most
    ``max_norm``; the norm before scaling)."""
    norm = global_norm(grads, norm_axes)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return {k: g.to(f32) * scale for k, g in grads.items()}, norm


# --------------------------------------------------------------------------
# Optimizer protocol
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable           # (grads, state, params, step) -> (updates, state)


def apply_updates(params: dict, updates: dict) -> dict:
    """``p <- (p in f32 + u) in p's dtype`` for every leaf, in place."""
    with torch.no_grad():
        for k, p in params.items():
            p.copy_((p.to(f32) + updates[k]).to(p.dtype))
    return params


def _scalars(device):
    z = lambda dtype: torch.zeros((), dtype=dtype, device=device)
    return {"count": z(torch.int32), "grad_norm": z(f32), "lr": z(f32)}


def _device(params: dict):
    return next(iter(params.values())).device


def _norm_axes(specs: dict | None) -> dict | None:
    """leaf -> the mesh axes its blocks differ over."""
    if specs is None:
        return None
    return {k: tuple(a for e in spec for a in sh.entry_axes(e))
            for k, spec in specs.items()}


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def make_adamw(tcfg: TrainConfig, specs: dict | None = None
               ) -> Optimizer:
    norm_axes = _norm_axes(specs)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()},
                **_scalars(_device(params))}

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip_norm,
                                           norm_axes)
        count = state["count"] + 1
        b1, b2 = tcfg.b1, tcfg.b2
        c1 = 1.0 - b1 ** count.to(f32)
        c2 = 1.0 - b2 ** count.to(f32)
        lr = lr_schedule(tcfg, step)
        updates = {}
        for k, p in params.items():
            g = grads.pop(k)
            m = state["m"][k].mul_(b1).add_((1 - b1) * g)
            v = state["v"][k].mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            u = (m / c1) / (torch.sqrt(v / c2) + tcfg.eps)
            if tcfg.weight_decay and p.ndim >= 2:   # no decay on norms/bias
                u = u + tcfg.weight_decay * p.to(f32)
            updates[k] = -lr * u
        return updates, {"m": state["m"], "v": state["v"], "count": count,
                         "grad_norm": gnorm, "lr": lr}

    return Optimizer(init=init, update=update)


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): factored v, no m, relative update
# scale.  State per matrix leaf: v_row (rows,), v_col (cols,).
# --------------------------------------------------------------------------
def _factored_dims(shape):
    """(row_axis, col_axis) for factoring, or None under two dims.  The
    two trailing dims are factored (a stacked leaf's leading dim is a batch
    dim of independent factorizations)."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def _leaf_mean(specs: dict | None, k: str):
    """``mean(x, dim)`` of a block of leaf ``k`` (or of a tensor whose dim
    ``dim`` is the leaf's dim ``of``) as the whole leaf's: without a mesh
    the local mean; on one, the sum over the axes that split that dim
    (every axis of the leaf where ``dim`` is None) over the global
    count."""
    if specs is None:
        return lambda x, dim=None, keepdim=False, of=None: (
            torch.mean(x) if dim is None else x.mean(dim=dim,
                                                      keepdim=keepdim))
    spec = specs[k]

    def mean(x, dim=None, keepdim=False, of=None):
        entries = spec if dim is None else (spec[dim if of is None else of],)
        axes = tuple(a for e in entries for a in sh.entry_axes(e))
        n = (x.numel() if dim is None else x.shape[dim]) \
            * comm.axes_size(axes)
        part = torch.sum(x) if dim is None else x.sum(dim=dim,
                                                      keepdim=keepdim)
        return comm.all_reduce_raw(part, axes) / n

    return mean


def make_adafactor(tcfg: TrainConfig, specs: dict | None = None
                   ) -> Optimizer:
    norm_axes = _norm_axes(specs)
    decay = 0.8  # beta2 schedule exponent: 1 - t^-0.8 (paper default)

    def dims_of(p):
        return _factored_dims(p.shape) if tcfg.factored else None

    def init(params):
        def leaf(p):
            dims = dims_of(p)
            zeros = lambda shape: torch.zeros(shape, dtype=f32,
                                              device=p.device)
            if dims is None:
                return {"v": zeros(p.shape)}
            r, c = dims
            return {"v_row": zeros([s for i, s in enumerate(p.shape)
                                    if i != c]),
                    "v_col": zeros([s for i, s in enumerate(p.shape)
                                    if i != r])}

        st = {"v": {k: leaf(p) for k, p in params.items()},
              **_scalars(_device(params))}
        if tcfg.master_weights:
            st["master"] = {k: p.detach().to(f32).clone()
                            for k, p in params.items()}
        return st

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip_norm,
                                           norm_axes)
        count = state["count"] + 1
        t = count.to(f32)
        beta2 = 1.0 - t ** (-decay)
        lr = lr_schedule(tcfg, step)
        updates = {}
        for k, p in params.items():
            g = grads.pop(k)
            v = state["v"][k]
            mean = _leaf_mean(specs, k)
            g2 = torch.square(g) + 1e-30
            dims = dims_of(p)
            if dims is None:
                v["v"].mul_(beta2).add_((1 - beta2) * g2)
                u = g * torch.rsqrt(v["v"] + tcfg.eps)
            else:
                r, c = dims
                vr = v["v_row"].mul_(beta2).add_((1 - beta2)
                                                 * mean(g2, c))
                vc = v["v_col"].mul_(beta2).add_((1 - beta2)
                                                 * mean(g2, r))
                # rank-1 reconstruction: v ~= vr vc / mean(vr); vr's last
                # dim is the leaf's row dim r
                denom = torch.clamp_min(mean(vr, -1, keepdim=True, of=r),
                                        1e-30)
                vhat = (vr / denom).unsqueeze(c) * vc.unsqueeze(r)
                u = g * torch.rsqrt(vhat + tcfg.eps)
            del g, g2
            # update clipping (adafactor d=1.0)
            rms_u = torch.sqrt(mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms_u, 1.0)
            # relative step scale
            pf = p.to(f32)
            p_scale = torch.clamp_min(torch.sqrt(mean(torch.square(pf))),
                                      1e-3)
            upd = -lr * p_scale * u
            if tcfg.weight_decay and p.ndim >= 2:
                upd = upd - lr * tcfg.weight_decay * pf
            updates[k] = upd
        new_state = {"v": state["v"], "count": count, "grad_norm": gnorm,
                     "lr": lr}
        if tcfg.master_weights:
            master = {k: mp + updates[k] for k, mp in state["master"].items()}
            new_state["master"] = master
            updates = {k: mp - params[k].to(f32) for k, mp in master.items()}
        return updates, new_state

    return Optimizer(init=init, update=update)


# --------------------------------------------------------------------------
# SGD (tests / ablations)
# --------------------------------------------------------------------------
def make_sgd(tcfg: TrainConfig, specs: dict | None = None
             ) -> Optimizer:
    norm_axes = _norm_axes(specs)

    def init(params):
        return _scalars(_device(params))

    def update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip_norm,
                                           norm_axes)
        lr = lr_schedule(tcfg, step)
        updates = {k: -lr * g for k, g in grads.items()}
        return updates, {"count": state["count"] + 1, "grad_norm": gnorm,
                         "lr": lr}

    return Optimizer(init=init, update=update)


def make_optimizer(tcfg: TrainConfig, specs: dict | None = None
                   ) -> Optimizer:
    """The optimizer of ``tcfg``; ``specs`` (leaf -> spec) for a mesh's
    blocks."""
    return {"adamw": make_adamw, "adafactor": make_adafactor,
            "sgd": make_sgd}[tcfg.optimizer](tcfg, specs)

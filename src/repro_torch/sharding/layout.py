"""The port's parameters, train state and decode cache under the specs.

Each rank holds, of every parameter leaf, the block that the reference's
spec gives it: the specs are resolved on the reference's leaf paths and
shapes (:func:`repro_torch.models.convert.param_leaves`: ``embed/tok``,
``stack/<j>/attn/wq`` stacked over the periods), and each layer's tensor
takes the spec without the stacked leaf's period dim.  A sharded parameter
carries that spec (``comm.SPEC``), which the model code reads to call its
collectives.  The optimizer's moments and the int8 step's error feedback
have their parameter's shape and take its spec.

The cache's k / v (the port's (B, KV, S, hd) per layer) take the spec of
the reference's ``stack/<j>/k`` (periods, B, S, KV, hd) with its axes
permuted; ``len`` the spec of ``len``.

:func:`shard_model` / :func:`shard_state` cut global tensors into the
rank's blocks, :func:`init_cache` allocates the rank's blocks of a cache;
:func:`gather_leaves` assembles the parameters again (a collective: every
rank calls it).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

from . import comm
from . import specs as sh


def tagged(t: torch.Tensor, spec) -> torch.Tensor:
    """``t`` carrying ``spec``."""
    setattr(t, comm.SPEC, tuple(spec))
    return t


def leaf_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter leaves: path -> global (stacked) shape."""
    from repro_torch import models
    from repro_torch.models import convert
    model = models.family(cfg).init_params(cfg, None, "meta")
    return {k: tuple(convert.stack_leaf(v).shape)
            for k, v in convert.param_leaves(cfg, model).items()}


def model_specs(cfg: ModelConfig, mesh, rules) -> dict:
    """path -> spec of every parameter leaf of ``cfg``."""
    return sh.param_specs(leaf_shapes(cfg), mesh, rules)


def _per_layer(path: str, spec, stacked: bool) -> tuple:
    if not stacked:
        return tuple(spec)
    if spec[0] is not None:
        raise NotImplementedError(
            f"{path}: a spec that splits the stacked period dim ({spec})")
    return tuple(spec[1:])


def shard_model(cfg: ModelConfig, model, mesh, rules) -> dict:
    """Cut the model's (global) parameters into this rank's blocks, in
    place, each tagged with its spec.  Returns the leaf specs."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "an encoder-decoder on a mesh (ROADMAP.md A13)")
    from repro_torch.models import convert
    specs = model_specs(cfg, mesh, rules)
    with torch.no_grad():
        for path, leaf in convert.param_leaves(cfg, model).items():
            stacked = isinstance(leaf, tuple)
            spec = _per_layer(path, specs[path], stacked)
            for p in (leaf if stacked else (leaf,)):
                p.data = sh.shard_leaf(p.data, spec, mesh)
                tagged(p, spec)
    return specs


def gather_leaves(cfg: ModelConfig, model, mesh) -> dict:
    """The reference's leaves (global, stacked) from every rank's blocks:
    path -> tensor (a collective)."""
    from repro_torch.models import convert
    out = {}
    for path, leaf in convert.param_leaves(cfg, model).items():
        ts = leaf if isinstance(leaf, tuple) else (leaf,)
        full = [sh.gather_leaf(t.detach(), getattr(t, comm.SPEC, ()) or
                               (None,) * t.ndim, mesh) for t in ts]
        out[path] = torch.stack(full) if isinstance(leaf, tuple) else full[0]
    return out


def _shard_tree(tree: dict, specs: dict, mesh) -> dict:
    return {k: sh.shard_leaf(v, specs[k], mesh) for k, v in tree.items()}


def shard_state(cfg: ModelConfig, state: dict, mesh, rules) -> dict:
    """A train state of global tensors (``train_step.init_state``) as this
    rank's: the model cut in place, AdamW's moments and the error feedback
    cut alike (Adafactor's factored moments raise)."""
    specs = shard_model(cfg, state["params"], mesh, rules)
    opt = dict(state["opt"])
    if "v" in opt and isinstance(next(iter(opt["v"].values())), dict):
        raise NotImplementedError(
            "Adafactor's factored moments on a mesh (ROADMAP.md A13)")
    for name in ("m", "v", "master"):
        if name in opt:
            opt[name] = _shard_tree(opt[name], specs, mesh)
    out = dict(state, opt=opt)
    if "ef" in state:
        out["ef"] = _shard_tree(state["ef"], specs, mesh)
    return out


# --------------------------------------------------------------------------
# Decode cache
# --------------------------------------------------------------------------
def _mesh_rules():
    return sh.current_mesh(), sh.current_rules()


def kv_spec(cfg: ModelConfig, batch: int, max_seq: int) -> tuple:
    """The spec of a layer's k / v (B, KV, S, hd) under the current mesh
    and rules: the reference's (periods, B, S, KV, hd) spec permuted."""
    a = cfg.attention
    mesh, rules = _mesh_rules()
    spec = sh.cache_specs({"stack/0/k": (cfg.num_periods, batch, max_seq,
                                         a.num_kv_heads, a.head_dim)},
                          mesh, rules)["stack/0/k"]
    return (spec[1], spec[3], spec[2], spec[4])


def entry(axes: tuple):
    """A tuple of axes as a spec entry."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def prefill_kv_spec(cfg: ModelConfig, rows: int, seq: int) -> tuple:
    """The spec of a prefill's k / v (the rank's ``rows``, every kv head,
    ``seq`` positions split as the cache's ``kvseq`` rule splits them)."""
    split = comm.batch_split()
    spec = kv_spec(cfg, rows * comm.axes_size(split), seq)
    return (entry(split), None, spec[2], None)


def len_spec(batch: int) -> tuple:
    mesh, rules = _mesh_rules()
    return sh.cache_specs({"len": (batch,)}, mesh, rules)["len"]


def _local_shape(shape, spec) -> tuple:
    mesh = sh.current_mesh()
    return tuple(s // comm.axes_size(sh.entry_axes(e), mesh)
                 for s, e in zip(shape, spec))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """This rank's blocks of an empty decode cache of ``batch`` sequences
    (global) and ``max_seq`` positions."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of
    for l in range(cfg.num_layers):
        transformer._mesh_check(transformer.layer_spec(cfg, l).mixer)
    a = cfg.attention
    spec = kv_spec(cfg, batch, max_seq)
    shape = _local_shape((batch, a.num_kv_heads, max_seq, a.head_dim), spec)
    dtype = dtype_of(cfg.dtype)
    zeros = lambda: tagged(torch.zeros(shape, dtype=dtype, device=device),
                           spec)
    ls = len_spec(batch)
    return {"layers": [{"k": zeros(), "v": zeros()}
                       for _ in range(cfg.num_layers)],
            "len": tagged(torch.zeros(_local_shape((batch,), ls),
                                      dtype=torch.int32, device=device), ls)}

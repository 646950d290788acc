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
permuted (an encoder-decoder's ``enc_k`` / ``enc_v`` that of its
``enc_kv``); an rwkv6 layer's ``att_shift``, ``ffn_shift`` and ``wkv``,
a mamba layer's ``conv`` and ``ssm`` the spec of the reference's entry of
that name without its period dim; ``len`` the spec of ``len``.  Adafactor's
factored moments take their leaf's spec without the dim they average
over.

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


def factored_specs(spec) -> tuple:
    """The specs of Adafactor's ``v_row`` (the leaf's spec without its
    last dim) and ``v_col`` (without its next-to-last dim) for a leaf of
    ``spec``, factored over its two trailing dims."""
    spec = tuple(spec)
    return spec[:-1], spec[:-2] + spec[-1:]


def _shard_moments(v: dict, specs: dict, mesh) -> dict:
    out = {}
    for k, st in v.items():
        if "v" in st:
            out[k] = {"v": sh.shard_leaf(st["v"], specs[k], mesh)}
            continue
        row, col = factored_specs(specs[k])
        out[k] = {"v_row": sh.shard_leaf(st["v_row"], row, mesh),
                  "v_col": sh.shard_leaf(st["v_col"], col, mesh)}
    return out


def shard_state(cfg: ModelConfig, state: dict, mesh, rules) -> dict:
    """A train state of global tensors (``train_step.init_state``) as this
    rank's: the model cut in place, AdamW's moments, Adafactor's second
    moments (factored or not), the master weights and the error feedback
    cut alike."""
    specs = shard_model(cfg, state["params"], mesh, rules)
    opt = dict(state["opt"])
    for name in ("m", "v", "master"):
        if name not in opt:
            continue
        tree = opt[name]
        if isinstance(next(iter(tree.values())), dict):
            opt[name] = _shard_moments(tree, specs, mesh)
        else:
            opt[name] = _shard_tree(tree, specs, mesh)
    out = dict(state, opt=opt)
    if "ef" in state:
        out["ef"] = _shard_tree(state["ef"], specs, mesh)
    return out


# --------------------------------------------------------------------------
# Decode cache
# --------------------------------------------------------------------------
def _mesh_rules():
    return sh.current_mesh(), sh.current_rules()


#: The reference's cache path of each of the port's cache entries (its
#: CACHE_RULES match on the name).
_REF_CACHE = {"k": "stack/0/k", "v": "stack/0/v",
              "att_shift": "stack/0/att_shift",
              "ffn_shift": "stack/0/ffn_shift", "wkv": "stack/0/wkv",
              "conv": "stack/0/conv", "ssm": "stack/0/ssm",
              "enc_k": "enc_kv/0", "enc_v": "enc_kv/0"}
#: Entries the port keeps as (B, KV, S, hd), the reference as (B, S, KV,
#: hd).
_KV = ("k", "v", "enc_k", "enc_v")


def entry_spec(name: str, shape) -> tuple:
    """The spec of a cache entry ``name`` of the port's global ``shape``
    (one layer's, in the port's layout) under the current mesh and rules:
    the reference's entry's spec without its period dim, permuted where
    the layouts differ."""
    mesh, rules = _mesh_rules()
    shape = tuple(shape)
    kv = name in _KV
    ref = (1,) + ((shape[0], shape[2], shape[1], shape[3]) if kv else shape)
    path = _REF_CACHE[name]
    spec = sh.cache_specs({path: ref}, mesh, rules)[path][1:]
    return (spec[0], spec[2], spec[1], spec[3]) if kv else spec


def kv_spec(cfg: ModelConfig, batch: int, max_seq: int) -> tuple:
    """The spec of a layer's k / v (B, KV, S, hd) under the current mesh
    and rules: the reference's (periods, B, S, KV, hd) spec permuted."""
    a = cfg.attention
    return entry_spec("k", (batch, a.num_kv_heads, max_seq, a.head_dim))


def entry(axes: tuple):
    """A tuple of axes as a spec entry."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def prefill_kv_spec(cfg: ModelConfig, rows: int, seq: int) -> tuple:
    """The spec of a prefill's k / v (the rank's ``rows``; the kv heads
    and the ``seq`` positions split as the cache's ``kvheads`` and
    ``kvseq`` rules split them at that length)."""
    split = comm.batch_split()
    spec = kv_spec(cfg, rows * comm.axes_size(split), seq)
    return (entry(split), spec[1], spec[2], None)


def prefill_kv(cfg: ModelConfig, kvheads: tuple, k, v) -> dict:
    """A prefill's k / v (the rank's rows, (B, KV, S, hd), its kv heads
    split over ``kvheads``) as the rank's blocks of the cache entry."""
    spec = prefill_kv_spec(cfg, k.shape[0], k.shape[2])
    out = {}
    for name, t in (("k", k), ("v", v)):
        t = comm.gather(t, 1, kvheads)
        t = comm.split(t, 1, sh.entry_axes(spec[1]))
        out[name] = tagged(comm.split(t, 2, sh.entry_axes(spec[2]))
                           .contiguous(), spec)
    return out


def tag_states(layer, cache: dict, like: dict | None = None) -> dict:
    """An rwkv6 or mamba layer's states, each carrying the spec of the
    blocks it holds: that of its namesake in ``like`` (the cache a decode
    step read), else the rank's rows and the heads (``wkv``) or channels
    (``conv``, ``ssm``) of the layer's weights."""
    rows = entry(comm.batch_split())
    if layer.mixer == "rwkv6":
        heads = entry(comm.split_axes(layer.rwkv["w_r"], 1))
        own = {"att_shift": (rows, None), "ffn_shift": (rows, None),
               "wkv": (rows, heads, None, None)}
    else:
        ffn = entry(comm.split_axes(layer.mamba["in_proj"], 1))
        own = {"conv": (rows, None, ffn), "ssm": (rows, ffn, None)}
    for name, t in cache.items():
        spec = comm.spec_of((like or {}).get(name)) or own[name]
        tagged(t, spec)
    return cache


def len_spec(batch: int) -> tuple:
    mesh, rules = _mesh_rules()
    return sh.cache_specs({"len": (batch,)}, mesh, rules)["len"]


def _local_shape(shape, spec) -> tuple:
    mesh = sh.current_mesh()
    return tuple(s // comm.axes_size(sh.entry_axes(e), mesh)
                 for s, e in zip(shape, spec))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """This rank's blocks of an empty decode cache of ``batch`` sequences
    (global) and ``max_seq`` positions: each entry of the no-mesh cache
    (:func:`repro_torch.models.transformer.cache_entry`,
    :func:`repro_torch.models.encdec.cache_entry`) cut as
    :func:`entry_spec` gives it."""
    from repro_torch.models import encdec, transformer

    def zeros(name, t):
        spec = entry_spec(name, t.shape)
        return tagged(torch.zeros(_local_shape(t.shape, spec),
                                  dtype=t.dtype, device=device), spec)

    layers = []
    for l in range(cfg.num_layers):
        meta = (encdec.cache_entry(cfg, batch, max_seq, "meta")
                if cfg.is_encoder_decoder else transformer.cache_entry(
                    cfg, transformer.layer_spec(cfg, l), batch, max_seq,
                    "meta"))
        layers.append({name: zeros(name, t) for name, t in meta.items()})
    ls = len_spec(batch)
    return {"layers": layers,
            "len": tagged(torch.zeros(_local_shape((batch,), ls),
                                      dtype=torch.int32, device=device), ls)}

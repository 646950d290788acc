"""Logical-axis sharding rules, resolved to explicit local blocks.

The port of ``repro/sharding/specs.py``.  The rule tables
(:class:`MeshRules`, :data:`PARAM_RULES`, :data:`CACHE_RULES`) and their
resolution (:func:`logical_to_spec`, :func:`param_specs`,
:func:`cache_specs`) are the reference's, verbatim.  A *spec* is the
``PartitionSpec``'s twin: a tuple with one entry per dim, each ``None``
(replicated), a mesh-axis name, or a tuple of names (major first).

Where the reference hands its specs to GSPMD, the port holds explicit
local shards: each rank keeps, of every tensor, the block its coordinates
give it (:func:`shard_leaf`), and the model code calls the collectives
that GSPMD would insert (:mod:`repro_torch.sharding.comm`).
:func:`gather_leaf` assembles a global tensor again from the ranks'
blocks.

Logical axes:

    batch    — global batch                (data parallel)
    seq      — sequence (activations)      (sequence parallel, long-context)
    kvseq    — KV-cache sequence           (decode-time SP)
    heads    — attention heads             (tensor parallel)
    kvheads  — KV heads                    (TP when divisible, else replicated)
    dmodel   — residual/model dim          (usually unsharded for activations)
    ffn      — MLP hidden dim              (tensor parallel)
    vocab    — embedding/logits vocab dim  (tensor parallel)
    expert   — MoE experts                 (expert parallel)
    fsdp     — parameter FSDP shards       (maps onto the data axis)

A rule value may be a mesh-axis name, a tuple of names, or None.  A mesh
is anything with ``axis_names`` (a tuple) and ``shape`` (a name -> size
dict); :class:`repro_torch.launch.mesh.Mesh` adds each axis's process
group and this rank's coordinates.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class MeshRules:
    """Resolution table: logical axis -> physical mesh axis (or axes)."""

    batch: tuple | str | None = ("pod", "data")
    seq: tuple | str | None = None
    # the carried residual stream (what remat stores between layers);
    # sharding it over "model" is Megatron-SP-style sequence parallelism
    seqcarry: tuple | str | None = None
    kvseq: tuple | str | None = "model"
    heads: tuple | str | None = "model"
    kvheads: tuple | str | None = "model"
    dmodel: tuple | str | None = None
    ffn: tuple | str | None = "model"
    vocab: tuple | str | None = "model"
    expert: tuple | str | None = "model"
    fsdp: tuple | str | None = None          # set to ("pod","data") for FSDP

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        return getattr(self, logical)

    def with_overrides(self, **kw) -> "MeshRules":
        return replace(self, **kw)

    def strip(self, axis: str) -> "MeshRules":
        """Remove one physical axis from every rule (e.g. 'pod' when it is
        handled by an enclosing per-pod computation)."""
        kw = {}
        for fld in self.__dataclass_fields__:
            axes = getattr(self, fld)
            if axes is None:
                continue
            if isinstance(axes, str):
                kw[fld] = None if axes == axis else axes
            else:
                kept = tuple(a for a in axes if a != axis)
                kw[fld] = (kept if len(kept) > 1
                           else (kept[0] if kept else None))
        return replace(self, **kw)

    def restrict(self, mesh) -> "MeshRules":
        """Drop references to axes the mesh does not have (e.g. 'pod' on a
        single-pod mesh)."""
        kw = {}
        for fld in self.__dataclass_fields__:
            axes = getattr(self, fld)
            if axes is None:
                continue
            if isinstance(axes, str):
                kw[fld] = axes if axes in mesh.axis_names else None
            else:
                kept = tuple(a for a in axes if a in mesh.axis_names)
                kw[fld] = (kept if len(kept) > 1
                           else (kept[0] if kept else None))
        return replace(self, **kw)


# --------------------------------------------------------------------------
# The sharding context.  When no mesh is installed every helper is the
# identity, so model code runs unmodified.  The reference's context is
# thread-local; the port's is process-wide, because the autograd engine
# recomputes a checkpointed layer of a CUDA backward on a thread of its
# own, and that recomputation must see the mesh the forward saw.
# --------------------------------------------------------------------------
class _Ctx:
    def __init__(self):
        self.mesh = None
        self.rules: MeshRules | None = None


_CTX = _Ctx()


@contextmanager
def use_mesh(mesh, rules: MeshRules):
    """Install (mesh, rules); valid mesh-axis names are checked eagerly."""
    for fld in rules.__dataclass_fields__:
        axes = rules.resolve(fld)
        if axes is None:
            continue
        for ax in (axes,) if isinstance(axes, str) else axes:
            if ax not in mesh.axis_names:
                raise ValueError(
                    f"rule {fld}={axes!r} references unknown mesh axis {ax!r}"
                    f" (mesh has {mesh.axis_names})")
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> MeshRules:
    return _CTX.rules if _CTX.rules is not None else MeshRules()


def active() -> bool:
    return _CTX.mesh is not None


def _dim_ok(dim_size: int, axes, mesh) -> bool:
    """Only shard a dimension the mesh divides evenly (e.g. 8 kv-heads on a
    16-way model axis -> replicate instead)."""
    if axes is None:
        return False
    n = 1
    for ax in (axes,) if isinstance(axes, str) else axes:
        n *= mesh.shape[ax]
    return dim_size % n == 0 and dim_size >= n


def logical_to_spec(shape: tuple[int, ...], logical: tuple[str | None, ...],
                    mesh, rules: MeshRules) -> tuple:
    """Resolve logical axes to a spec, dropping non-divisible dims and
    axes already consumed by an earlier dimension."""
    assert len(shape) == len(logical), (shape, logical)
    used: set[str] = set()
    out = []
    for size, name in zip(shape, logical):
        axes = rules.resolve(name)
        if axes is not None and not isinstance(axes, str):
            axes = tuple(a for a in axes if a in mesh.axis_names)
            axes = axes or None
        if isinstance(axes, str) and axes not in mesh.axis_names:
            axes = None
        # an axis may appear in only one dim of a spec
        if axes is not None:
            flat = (axes,) if isinstance(axes, str) else tuple(axes)
            if any(a in used for a in flat) or not _dim_ok(size, flat, mesh):
                axes = None
            else:
                used.update(flat)
                axes = flat[0] if len(flat) == 1 else tuple(flat)
        out.append(axes)
    return tuple(out)


# --------------------------------------------------------------------------
# Parameter sharding: path-pattern -> logical axes, resolved against shapes.
# Patterns are regexes over the '/'-joined path.  First match wins.
# --------------------------------------------------------------------------
#: (regex, logical axes per dim — trailing dims matched right-aligned)
PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / lm head: shard the vocab dim
    (r"embed/tok$",            ("vocab", "fsdp")),
    (r"lm_head$",              ("fsdp", "vocab")),
    (r"pos_embed$",            (None, None)),
    # attention projections (stacked layers get an extra leading dim)
    (r"(attn|self_attn|cross_attn)/wq$",   ("fsdp", "heads", None)),
    (r"(attn|self_attn|cross_attn)/wk$",   ("fsdp", "kvheads", None)),
    (r"(attn|self_attn|cross_attn)/wv$",   ("fsdp", "kvheads", None)),
    (r"(attn|self_attn|cross_attn)/wo$",   ("heads", None, "fsdp")),
    (r"(attn|self_attn|cross_attn)/(bq)$", ("heads", None)),
    (r"(attn|self_attn|cross_attn)/(bk|bv)$", ("kvheads", None)),
    (r"(attn|self_attn|cross_attn)/(bo)$", (None,)),
    # dense mlp
    (r"mlp/w_(in|gate)$",      ("fsdp", "ffn")),
    (r"mlp/w_out$",            ("ffn", "fsdp")),
    (r"mlp/b_(in|gate)$",      ("ffn",)),
    (r"mlp/b_out$",            (None,)),
    # MoE: experts on the leading dim
    (r"moe/router$",           ("fsdp", None)),
    (r"moe/w_(in|gate)$",      ("expert", "fsdp", "ffn")),
    (r"moe/w_out$",            ("expert", "ffn", "fsdp")),
    # mamba
    (r"mamba/in_proj$",        ("fsdp", "ffn")),
    (r"mamba/conv_w$",         (None, "ffn")),
    (r"mamba/conv_b$",         ("ffn",)),
    (r"mamba/(x_dt|x_b|x_c)$", ("ffn", None)),
    (r"mamba/dt_proj$",        (None, "ffn")),
    (r"mamba/dt_bias$",        ("ffn",)),
    (r"mamba/a_log$",          ("ffn", None)),
    (r"mamba/d$",              ("ffn",)),
    (r"mamba/out_proj$",       ("ffn", "fsdp")),
    (r"mamba/norm$",           ("ffn",)),
    # rwkv6
    (r"rwkv/(w_r|w_k|w_v|w_g)$",  ("fsdp", "ffn")),
    (r"rwkv/w_o$",             ("ffn", "fsdp")),
    (r"rwkv/(mu_.*|w0|ddlerp_.*)$", None),      # small mixing vectors
    (r"rwkv/(lora_.*)$",       None),
    (r"rwkv/ln_(w|b)$",        (None,)),
    (r"rwkvffn/w_k$",          ("fsdp", "ffn")),
    (r"rwkvffn/w_v$",          ("ffn", "fsdp")),
    (r"rwkvffn/w_r$",          ("fsdp", None)),
    (r"rwkvffn/mu_.*$",        None),
    # norms & scalars: replicate
    (r".*(norm|ln)[^/]*$",     None),
    (r".*", None),
]


def param_logical_axes(path_str: str, ndim: int) -> tuple:
    """Match PARAM_RULES; right-align the logical axes to the array rank
    (stacked-layer params carry extra leading dims which stay unsharded,
    except FSDP which may claim the stack dim via rule override)."""
    for pat, logical in PARAM_RULES:
        if re.search(pat, path_str):
            if logical is None:
                return (None,) * ndim
            logical = tuple(logical)
            if len(logical) > ndim:      # un-stacked variant (e.g. biases)
                logical = logical[-ndim:]
            pad = (None,) * (ndim - len(logical))
            return pad + logical
    return (None,) * ndim


def param_specs(shapes: dict, mesh, rules: MeshRules) -> dict:
    """Specs of parameter leaves: ``{path: shape}`` -> ``{path: spec}``,
    paths as :func:`repro_torch.models.convert.param_leaves` names them
    (the reference's '/'-joined pytree paths)."""
    return {path: logical_to_spec(tuple(shape), param_logical_axes(
        path, len(shape)), mesh, rules) for path, shape in shapes.items()}


# --------------------------------------------------------------------------
# Decode-cache sharding: KV caches sequence-sharded (flash-decode), SSM /
# linear-attention states sharded over their channel dims.
# --------------------------------------------------------------------------
CACHE_RULES: list[tuple[str, tuple]] = [
    # attention KV: (periods, B, S, KV, hd) — (^|/) also catches the
    # enc-dec cache whose k/v live at the root
    (r"(^|/)(k|v)$",        (None, "batch", "kvseq", "kvheads", None)),
    # whisper cross-attention KV: (L, B, enc_seq, KV, hd)
    (r"enc_kv",             (None, "batch", None, "kvheads", None)),
    # mamba: conv (periods, B, K-1, d_in), ssm (periods, B, d_in, N)
    (r"/conv$",             (None, "batch", None, "ffn")),
    (r"/ssm$",              (None, "batch", "ffn", None)),
    # rwkv6: wkv (periods, B, H, hd, hd); shifts (periods, B, D)
    (r"/wkv$",              (None, "batch", "heads", None, None)),
    (r"_shift$",            (None, "batch", None)),
    (r"/len$",              ("batch",)),
    (r".*",                 None),
]


def cache_logical_axes(path_str: str, ndim: int) -> tuple:
    for pat, logical in CACHE_RULES:
        if re.search(pat, path_str):
            if logical is None:
                return (None,) * ndim
            logical = tuple(logical)
            if len(logical) > ndim:
                logical = logical[-ndim:]
            return (None,) * (ndim - len(logical)) + logical
    return (None,) * ndim


def cache_specs(shapes: dict, mesh, rules: MeshRules) -> dict:
    """Specs of cache leaves: ``{path: shape}`` -> ``{path: spec}``, paths
    and shapes the reference's (``stack/<j>/k`` of (periods, B, S, KV,
    hd), ``len``)."""
    return {path: logical_to_spec(tuple(shape), cache_logical_axes(
        path, len(shape)), mesh, rules) for path, shape in shapes.items()}


# --------------------------------------------------------------------------
# Explicit local blocks
# --------------------------------------------------------------------------
def entry_axes(entry) -> tuple:
    """A spec entry as a tuple of axis names (major first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(axes: tuple, mesh, coords: dict) -> tuple[int, int]:
    """(index, count) of the block that ``coords`` (axis -> coordinate)
    holds along a dim split over ``axes``, the first axis major."""
    idx, n = 0, 1
    for ax in axes:
        idx = idx * mesh.shape[ax] + coords[ax]
        n *= mesh.shape[ax]
    return idx, n


def block_slices(shape, spec, mesh, coords: dict) -> tuple:
    """The slices of a global tensor of ``shape`` that the rank at
    ``coords`` holds under ``spec``."""
    out = []
    for size, entry in zip(shape, spec):
        i, n = block_index(entry_axes(entry), mesh, coords)
        if size % n:
            raise ValueError(f"dim {size} does not split over {entry!r}")
        b = size // n
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def shard_leaf(t: torch.Tensor, spec, mesh, coords: dict | None = None):
    """The block of the global tensor ``t`` that this rank (or the rank
    at ``coords``) holds under ``spec``: a contiguous copy, which holds
    none of the global tensor's storage (``.contiguous()`` of a block that
    is contiguous already would be a view of it)."""
    coords = mesh.coords if coords is None else coords
    return t[block_slices(t.shape, spec, mesh, coords)].clone(
        memory_format=torch.contiguous_format)


def gather_leaf(t: torch.Tensor, spec, mesh):
    """The global tensor from every rank's block ``t`` (the inverse of
    :func:`shard_leaf`; a collective: every rank of the mesh calls it)."""
    from . import comm
    for dim, entry in enumerate(spec):
        # the minor axis first, so that the blocks land major-first
        for ax in reversed(entry_axes(entry)):
            t = comm.all_gather_raw(t, dim, ax, mesh)
    return t

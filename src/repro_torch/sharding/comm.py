"""The collectives of the mesh path, where GSPMD would insert them.

Each rank holds explicit local blocks (:mod:`.specs`); the model code calls
these functions at the points where the reference's compiler inserts its
collectives.  Every function is the identity without a mesh
(``specs.use_mesh`` not entered) or over no axes, so the one-device paths
run exactly as before.

Gradients follow Megatron's convention: an activation replicated over
the ``model`` axis holds its whole gradient on every rank of that axis.
So a tensor-parallel block is entered through :func:`copy` (identity
forward, gradient summed over the axis) and left through :func:`reduce`
(sum forward, identity backward); a sequence split (:func:`split`) gathers
its gradient and a gather (:func:`gather`) slices it.  A weight split
over the ``fsdp`` axes is gathered before use (:func:`weight`), its
gradient summed over those axes and sliced back to the rank's block.
Data parallelism: the loss is the global one (its sums pass through
:func:`reduce` over the batch's axes), and the train step sums each
gradient over those axes that its weight's gather did not already sum.

A collective runs over one mesh axis at a time: over several axes it runs
over each in turn, the minor axis first where blocks are laid out, which
composes to the collective over their product.  gloo has no
``reduce_scatter_tensor``: on CPU tensors the scatter is an all-reduce
and a slice.

Each raw collective logs its kind, operand and output bytes and group
size to the active cost counter (:mod:`repro_torch.launch.costanalysis`),
whatever the backend: the dry-run's collective terms.  A scatter is
logged as one, also where an all-reduce carries it out.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch.autograd import Function

from repro_torch.launch import costanalysis

from . import specs as sh


active = sh.active
entry_axes = sh.entry_axes


def _mesh(mesh=None):
    return mesh if mesh is not None else sh.current_mesh()


def axes_size(axes: tuple, mesh=None) -> int:
    m = _mesh(mesh)
    n = 1
    for ax in axes:
        n *= m.shape[ax]
    return n


def axes_index(axes: tuple, mesh=None) -> int:
    """This rank's block index along a dim split over ``axes``."""
    m = _mesh(mesh)
    return sh.block_index(axes, m, m.coords)[0]


# --------------------------------------------------------------------------
# Raw collectives over one axis (no autograd)
# --------------------------------------------------------------------------
def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _all_reduce(t, axes, op, m, log: bool):
    out = t.clone()
    for ax in axes:
        if log:
            costanalysis.add_collective("all-reduce", _nbytes(out),
                                        _nbytes(out), m.shape[ax])
        dist.all_reduce(out, op=op, group=m.group(ax))
    return out


def all_reduce_raw(t, axes: tuple, op=dist.ReduceOp.SUM, mesh=None):
    """``t`` reduced over ``axes`` (a new tensor)."""
    return _all_reduce(t, axes, op, _mesh(mesh), True)


def all_gather_raw(t, dim: int, ax: str, mesh=None):
    """The blocks of every rank of ``ax`` concatenated along ``dim`` in
    coordinate order."""
    m = _mesh(mesh)
    n = m.shape[ax]
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    costanalysis.add_collective("all-gather", _nbytes(src), _nbytes(out), n)
    dist.all_gather_into_tensor(out, src, group=m.group(ax))
    return out.movedim(0, dim)


def _block(t, dim: int, axes: tuple, mesh=None):
    n = axes_size(axes, mesh)
    b = t.shape[dim] // n
    return t.narrow(dim, axes_index(axes, mesh) * b, b)


def reduce_scatter_raw(t, dim: int, axes: tuple, mesh=None):
    """``t`` summed over ``axes``, this rank's block along ``dim``."""
    m = _mesh(mesh)
    for ax in axes:                     # major first: blocks nest
        n = m.shape[ax]
        costanalysis.add_collective("reduce-scatter", _nbytes(t),
                                    _nbytes(t) // n, n)
        if t.device.type == "cuda":
            src = t.movedim(dim, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, src, group=m.group(ax))
            t = out.movedim(0, dim)
        else:
            t = _block(_all_reduce(t, (ax,), dist.ReduceOp.SUM, m, False),
                       dim, (ax,), m)
    return t.contiguous()


def all_to_all_raw(t, ax: str, mesh=None):
    """Dim 0's equal blocks exchanged over ``ax``: block j goes to
    coordinate j, and the result's block i came from coordinate i."""
    m = _mesh(mesh)
    src = t.contiguous()
    out = torch.empty_like(src)
    costanalysis.add_collective("all-to-all", _nbytes(src), _nbytes(out),
                                m.shape[ax])
    dist.all_to_all_single(out, src, group=m.group(ax))
    return out


# --------------------------------------------------------------------------
# Differentiable collectives (identity without a mesh or over no axes)
# --------------------------------------------------------------------------
def _idle(axes) -> bool:
    return not axes or not sh.active()


# Each function keeps the mesh it ran under: the autograd engine runs a
# CUDA backward on a thread of its own.
class _Reduce(Function):
    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce_raw(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.mesh = axes, _mesh()
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.axes, mesh=ctx.mesh), None


class _GatherParam(Function):
    @staticmethod
    def forward(ctx, w, dim, axes):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, _mesh()
        for ax in reversed(axes):
            w = all_gather_raw(w, dim, ax)
        return w

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.dim, ctx.axes, ctx.mesh), None, None


class _Gather(Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, _mesh()
        for ax in reversed(axes):
            x = all_gather_raw(x, dim, ax)
        return x

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.dim, ctx.axes, ctx.mesh).contiguous(), None,
                None)


class _Split(Function):
    @staticmethod
    def forward(ctx, x, dim, axes):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, _mesh()
        return _block(x, dim, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        for ax in reversed(ctx.axes):
            g = all_gather_raw(g, ctx.dim, ax, ctx.mesh)
        return g, None, None


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.mesh = ax, _mesh()
        return all_to_all_raw(x, ax)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.ax, ctx.mesh), None


def reduce(x, axes: tuple):
    """Sum over ``axes``, identity backward (leaving a tensor-parallel
    block, or a sum whose consumer every rank computes alike)."""
    return x if _idle(axes) else _Reduce.apply(x, tuple(axes))


def copy(x, axes: tuple):
    """Identity, gradient summed over ``axes`` (entering a
    tensor-parallel block)."""
    return x if _idle(axes) else _Copy.apply(x, tuple(axes))


def gather(x, dim: int, axes: tuple):
    """The blocks over ``axes`` concatenated along ``dim``; backward takes
    this rank's block of the (replicated) gradient."""
    return x if _idle(axes) else _Gather.apply(x, dim, tuple(axes))


def gather_sum(x, dim: int, axes: tuple):
    """The blocks over ``axes`` concatenated along ``dim``, for consumers
    that differ between the ranks (each reads its own part of the whole):
    backward sums the gradient over the axes and takes this rank's
    block."""
    return x if _idle(axes) else _GatherParam.apply(x, dim, tuple(axes))


def split(x, dim: int, axes: tuple):
    """This rank's block along ``dim``; backward gathers the blocks'
    gradients."""
    return x if _idle(axes) else _Split.apply(x, dim, tuple(axes))


def all_to_all(x, ax: str):
    return x if _idle((ax,)) else _AllToAll.apply(x, ax)


def all_reduce_max(x, axes: tuple):
    """Max over ``axes`` (no gradient: a stabiliser)."""
    if _idle(axes):
        return x
    return all_reduce_raw(x.detach(), tuple(axes), op=dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------
#: The attribute a sharded parameter carries: its spec without the
#: stacked leaf's leading period dim.
SPEC = "mesh_spec"


def spec_of(w):
    """A parameter's spec, or None (no mesh, or not sharded)."""
    return getattr(w, SPEC, None) if sh.active() else None


def fsdp_axes() -> tuple:
    return sh.entry_axes(sh.current_rules().fsdp)


def split_axes(w, dim: int) -> tuple:
    """The non-FSDP axes (tensor / expert parallel) that split ``w``'s dim
    ``dim``: its local block's share of that dim."""
    spec = spec_of(w)
    if spec is None:
        return ()
    fsdp = fsdp_axes()
    return tuple(a for a in sh.entry_axes(spec[dim]) if a not in fsdp)


def weight(w):
    """``w`` for use: gathered over the FSDP axes its spec splits it on
    (gradient summed over them and sliced back); splits over other axes
    stay.  Identity without a mesh."""
    spec = spec_of(w)
    if spec is None:
        return w
    fsdp = fsdp_axes()
    for dim, entry in enumerate(spec):
        axes = sh.entry_axes(entry)
        on = tuple(a for a in axes if a in fsdp)
        if on and on != axes:
            raise NotImplementedError(
                f"dim {dim} of a weight split over {axes}: FSDP and "
                f"tensor-parallel axes on one dim")
        if on:
            w = _GatherParam.apply(w, dim, on)
    return w


def gathered_axes(spec) -> tuple:
    """The FSDP axes a weight of ``spec`` is gathered over (its gradient
    is already summed over them)."""
    fsdp = fsdp_axes()
    return tuple(a for e in spec for a in sh.entry_axes(e) if a in fsdp)


# --------------------------------------------------------------------------
# The batch of a run
# --------------------------------------------------------------------------
class _Run:
    """Process-wide, as the mesh context is (:mod:`.specs`)."""

    def __init__(self):
        self.split: tuple = ()
        self.reduce: tuple = ()


_RUN = _Run()


@contextmanager
def batch(split: tuple, reduce: tuple | None = None):
    """Within: the activations' batch rows are split over ``split``, and
    the loss and gradients combine over ``reduce`` (default: ``split``;
    the int8 step's per-pod gradients leave out the pod)."""
    prev = (_RUN.split, _RUN.reduce)
    _RUN.split = tuple(split)
    _RUN.reduce = tuple(split if reduce is None else reduce)
    try:
        yield
    finally:
        _RUN.split, _RUN.reduce = prev


def batch_split() -> tuple:
    return _RUN.split if sh.active() else ()


def batch_reduce() -> tuple:
    return _RUN.reduce if sh.active() else ()


def batch_axes_for(B: int) -> tuple:
    """The axes a global batch of ``B`` rows splits over under the
    current rules (the ``batch`` rule where the mesh divides B)."""
    spec = sh.logical_to_spec((B,), ("batch",), sh.current_mesh(),
                              sh.current_rules())
    return sh.entry_axes(spec[0])


def local_rows(t, axes: tuple):
    """This rank's rows of a global batch tensor (no gradient)."""
    if _idle(axes):
        return t
    return _block(t, 0, tuple(axes)).contiguous()

"""Cost of one eager step on the meta device: the dry-run's "profiler".

The port of ``repro/launch/hloanalysis.py``.  The reference parses the
post-SPMD HLO of a compiled step; the port has no HLO and counts the
eager step itself while it runs on ``meta`` tensors (shapes, no bytes)
under :class:`CostCounter`, a ``TorchDispatchMode``.  Every op the step
dispatches is one kernel launch on the card, so it plays the part of the
reference's post-fusion top-level instruction:

* ``flops``            — 2·M·N·K for every product and convolution
                         (``torch.utils.flop_counter``'s formulas); the
                         hand-written kernels K5–K8 report their own
                         (:func:`add_kernel`, from their meta branches);
* ``traffic_bytes``    — operand bytes plus output bytes of every op
                         that launches a kernel (views and allocations
                         launch none); a hand-written kernel counts its
                         inputs once and its outputs once;
* ``collective_*``     — per kind and group size, operand bytes, ring-
                         adjusted wire bytes and counts, logged by
                         :mod:`repro_torch.sharding.comm`'s raw
                         collectives (:func:`add_collective`), whatever
                         the backend;
* ``peak_bytes``       — the most bytes of storage allocated during the
                         step and alive at once (a tracker of the
                         storages the step's ops create and free), the
                         port's ``temp_bytes`` once the outputs are taken
                         out.

A recomputation under ``torch.utils.checkpoint`` dispatches its ops again
in the backward and is counted again, as XLA's HLO counts a remat.
:func:`roofline_terms` keeps the reference's signature and keys; its
constants are the NVIDIA H100 SXM data sheet's at the 700 W power limit
(dense bf16, HBM3, NVLink 4), not measurements.  A 16 x 16 "pod" of
H100s spans 32 hosts of 8 cards, and the links between hosts are slower
than NVLink, so ``collective_s`` is a lower bound.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: The part the roofline's constants are for, and its power limit.
PART = "NVIDIA H100 SXM5 80GB (data sheet), 700 W"
PEAK_FLOPS_BF16 = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 450e9                 # bytes/s each way per card

#: Ops that launch no kernel: allocations (their bytes are tracked, not
#: moved) and metadata.  Views are told by ``OpOverload.is_view``.
_NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh", "detach", "alias",
              "_local_scalar_dense", "set_", "resize_", "sym_size",
              "sym_stride", "sym_numel", "sym_storage_offset"}


@dataclass
class Cost:
    """The counterpart of ``HloCost``, with the op count and the
    hand-written kernels' share beside it."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_operand_bytes: dict = field(
        default_factory=lambda: defaultdict(float))
    collective_wire_bytes: dict = field(
        default_factory=lambda: defaultdict(float))
    collective_count: dict = field(default_factory=lambda: defaultdict(int))
    #: Kernels launched: dispatched ops that launch one, and K5–K8.
    n_ops: int = 0
    #: name -> {"launches", "flops", "bytes"} of the hand-written kernels.
    kernels: dict = field(default_factory=dict)
    #: Most bytes allocated during the step and alive at once.
    peak_bytes: int = 0

    @property
    def total_collective_wire_bytes(self) -> float:
        return sum(self.collective_wire_bytes.values())


def wire_bytes(kind: str, operand_bytes: float, out_bytes: float,
               g: int) -> float:
    """Ring-algorithm bytes a device sends for one collective over a group
    of ``g`` (``hloanalysis._collective``'s formulas)."""
    share = (g - 1) / max(1, g)
    if kind == "all-reduce":
        return 2.0 * operand_bytes * share
    if kind == "all-gather":
        return out_bytes * share
    return operand_bytes * share          # reduce-scatter, all-to-all


_STACK: list = []


def active() -> "CostCounter | None":
    """The innermost counter that is counting, or None."""
    return _STACK[-1] if _STACK else None


def add_kernel(name: str, flops: float, n_bytes: float) -> None:
    """A hand-written kernel's meta launch: its FLOPs and the bytes it
    moves (each input read once, each output written once)."""
    c = active()
    if c is None:
        return
    cost = c.cost
    cost.flops += flops
    cost.traffic_bytes += n_bytes
    cost.n_ops += 1
    k = cost.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                       "bytes": 0.0})
    k["launches"] += 1
    k["flops"] += flops
    k["bytes"] += n_bytes


def add_collective(kind: str, operand_bytes: float, out_bytes: float,
                   g: int) -> None:
    """One collective over a group of ``g`` ranks: its operand and output
    bytes (which also count as HBM traffic) and its wire bytes."""
    c = active()
    if c is None:
        return
    cost = c.cost
    key = f"{kind}(g={g})"
    cost.collective_operand_bytes[key] += operand_bytes
    cost.collective_wire_bytes[key] += wire_bytes(kind, operand_bytes,
                                                  out_bytes, g)
    cost.collective_count[key] += 1
    cost.traffic_bytes += operand_bytes + out_bytes


def tensor_bytes(tensors) -> int:
    """Bytes of the tensors' own extents."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it into ``self.cost`` and tracks
    the storages they allocate (``self.live`` bytes now, ``cost.peak_bytes``
    the most).  Install it with ``with CostCounter() as c:``; the
    hand-written kernels and the collectives find it through
    :func:`active`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self._storages: dict = {}
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(outs, ins)
        name = func.overloadpacket.__name__
        if (func.is_view or name in _NO_KERNEL or func.namespace != "aten"
                or all(t.device.type == "cpu" for t in ins + outs)):
            return out
        cost = self.cost
        cost.n_ops += 1
        uniq = {id(t): t for t in ins}
        cost.traffic_bytes += tensor_bytes(uniq.values()) \
            + tensor_bytes(outs)
        formula = self._flops.get(func.overloadpacket)
        if formula is not None:
            cost.flops += float(formula(*args, **kwargs, out_val=out))
        return out


def roofline_terms(cost: Cost, mem_bytes: float) -> dict:
    """Per-card seconds for each roofline term.  ``cost`` is one rank's
    step; ``mem_bytes`` is its HBM traffic (falls back to
    ``cost.traffic_bytes``)."""
    compute_s = cost.flops / PEAK_FLOPS_BF16
    memory_s = (mem_bytes or cost.traffic_bytes) / HBM_BW
    collective_s = cost.total_collective_wire_bytes / NVLINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "flops": cost.flops,
        "traffic_bytes": mem_bytes or cost.traffic_bytes,
        "collective_operand_bytes": dict(cost.collective_operand_bytes),
        "collective_wire_bytes": dict(cost.collective_wire_bytes),
        "collective_count": dict(cost.collective_count),
        "part": PART,
        "peak_flops_bf16": PEAK_FLOPS_BF16,
        "hbm_bytes_per_s": HBM_BW,
        "nvlink_bytes_per_s": NVLINK_BW,
    }

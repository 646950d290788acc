"""Production and test meshes over ``torch.distributed``.

The port of ``repro/launch/mesh.py``: the same axis names and order.  The
caller has already called ``torch.distributed.init_process_group`` with
its address or store, the world size and the rank (nothing on a machine
tells a program of its cluster).  A mesh lays the world's ranks out
row-major over its axes, as ``jax.make_mesh`` lays out the devices, and
:func:`torch.distributed.device_mesh.init_device_mesh` gives each axis its
process group.

Production topology: one pod = 16 x 16 = 256 devices (``data`` x
``model``); multi-pod = 2 pods = 512 devices with a leading ``pod`` axis
(pure data parallel + optional FSDP).  A world whose size is not the
mesh's product raises ``ValueError``: nothing falls back to one device.
"""

from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist


class Mesh:
    """A named mesh over the initialised world.

    ``axis_names`` (major first), ``shape`` (axis -> size), ``coords``
    (axis -> this rank's coordinate) and :meth:`group` (an axis's process
    group)."""

    def __init__(self, shape: tuple, axis_names: tuple,
                 device_type: str | None = None):
        n = math.prod(shape)
        world = dist.get_world_size() if dist.is_initialized() else None
        if world != n:
            raise ValueError(
                f"the mesh {dict(zip(axis_names, shape))} needs {n} ranks; "
                + (f"the world has {world}" if world else
                   "torch.distributed is not initialised (call "
                   "init_process_group with the world's size and rank)"))
        if device_type is None:
            device_type = ("cuda" if "nccl" in str(dist.get_backend())
                           else "cpu")
        from torch.distributed.device_mesh import init_device_mesh
        self.device_mesh = init_device_mesh(device_type, tuple(shape),
                                            mesh_dim_names=tuple(axis_names))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        rank = dist.get_rank()
        self.coords = {ax: int(c) for ax, c in zip(
            axis_names, np.unravel_index(rank, shape))}
        self._groups = {ax: self.device_mesh.get_group(ax)
                        for ax in axis_names}
        for ax, g in self._groups.items():
            # a group's ranks in coordinate order: blocks land in order
            assert dist.get_rank(g) == self.coords[ax], (ax, self.coords)

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                   device_type: str | None = None) -> Mesh:
    """Small mesh for tests: (pod, data, model) with a pod, else (data,
    model)."""
    if pod:
        return Mesh((pod, data, model), ("pod", "data", "model"),
                    device_type)
    return Mesh((data, model), ("data", "model"), device_type)


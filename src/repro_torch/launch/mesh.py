"""Process meshes on ``torch.distributed`` (the port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over a
process group the caller has initialised (``init_process_group`` with its
own address, world size and rank).  Its device type names the TRANSPORT the
collective executors move bytes over: ``"cpu"`` is gloo, which reads host
memory, so the executors stage every unit through a (pinned) host buffer.
Where the codec runs is a separate choice, the session's ``device=``: on the
card the codec runs on ``cuda`` while gloo moves host-staged bytes.  Other
transports (NCCL: one GPU a rank) are refused by the executors, never
swapped in quietly.

:func:`make_production_mesh` lays the JAX production meshes, ``(16, 16)``
over ``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data",
"model")``, over a group of 256 or 512 ranks: the multi-pod dry run builds
them on torch's ``fake`` backend (``repro_torch.launch.dryrun``), which
moves no byte.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with ``mesh_dim_names=axes`` over the
    initialised default group, on the ``"cpu"`` (gloo) transport; rank
    ``r`` sits at the row-major coordinate of ``r``.  Raises when no group
    is initialised or the sizes disagree."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"group has {world}")
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (the JAX ``make_production_mesh``'s shape and
    axis names) over the initialised default group, which must have 256
    (512 with ``multi_pod``) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}``, the counterpart of a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def describe(mesh) -> str:
    return " × ".join(f"{k}={v}" for k, v in mesh_shape(mesh).items()) + \
        f"  ({mesh.mesh.numel()} ranks, {mesh.device_type} transport)"

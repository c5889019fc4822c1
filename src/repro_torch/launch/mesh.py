"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the initialized default process group, one rank a reducer.  The caller
starts the ranks and initializes the group (``init_process_group`` with
its own address, world size and rank); nothing here reads a cluster's
environment.  Functions only: importing this module touches no device or
process-group state.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    return dist.get_world_size()


def _device_type(device) -> str:
    """``device``'s type, or the card's under NCCL and the CPU under any
    other backend."""
    import torch
    import torch.distributed as dist

    if device is not None:
        return torch.device(device).type
    return "cuda" if "nccl" in dist.get_backend() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the ranks of the initialized
    default process group: ``(16, 16)`` ``("data", "model")``, or
    ``(2, 16, 16)`` ``("pod", "data", "model")`` with ``multi_pod``, on
    the device type of its backend (as ``make_host_mesh``'s default).
    Raises, naming the world size it needs, under a group of another
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if _world() != need:
        raise ValueError(
            f"the production mesh {shape} {axes} needs a process group of "
            f"{need} ranks; this one has {_world()}")
    return init_device_mesh(_device_type(None), shape,
                            mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device=None):
    """A ``("data", "model")`` mesh over every rank of the initialized
    default process group, ``model_axis`` ranks a model group.  Its
    device type is ``device``'s, by default the one its backend's
    collectives use: ``cuda`` under NCCL, else the CPU (gloo).  Gloo
    ranks sharing one card hold CUDA tensors, so they pass
    ``device="cuda"``: a mesh's device type is that of the tensors placed
    on it."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _world()
    if n % model_axis:
        raise ValueError(f"world size {n} is not a multiple of "
                         f"model_axis={model_axis}")
    return init_device_mesh(_device_type(device), (n // model_axis,
                                                   model_axis),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's reducer axes, ``pod`` before ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def num_chips(mesh) -> int:
    """Ranks in the mesh."""
    return int(np.prod(tuple(mesh.shape)))

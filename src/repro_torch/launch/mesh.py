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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's TPU-pod mesh shapes ((16, 16) or (2, 16, 16)) serve
    its sharded train and dry-run launchers: ROADMAP A, slice 16e."""
    raise NotImplementedError(
        "make_production_mesh builds a TPU pod mesh for the sharded train "
        "and dry-run launchers, which are ROADMAP A, slice 16e — build a "
        "DeviceMesh with make_host_mesh or "
        "torch.distributed.device_mesh.init_device_mesh")


def make_host_mesh(model_axis: int = 1):
    """A ``("data", "model")`` mesh over every rank of the initialized
    default process group, ``model_axis`` ranks a model group, on the
    device its backend's collectives use: ``cuda`` under NCCL, else the
    CPU (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized default "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"world size {n} is not a multiple of "
                         f"model_axis={model_axis}")
    device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's reducer axes, ``pod`` before ``data``."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def num_chips(mesh) -> int:
    """Ranks in the mesh."""
    return int(np.prod(tuple(mesh.shape)))

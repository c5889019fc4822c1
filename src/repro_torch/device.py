"""Device placement for the port: where tensors live and which sweep runs.

The port's entry points run on the card unless the caller asks for the CPU.
A request for ``cuda`` on a machine without one raises; nothing falls back
to the CPU.  ``use_pallas`` keeps the reference's knob name: ``"auto"``
selects the hand-written CUDA kernel for CUDA tensors and the plain torch
version for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

# metrics the CUDA sweep kernels implement (``kernels.ops._metric_to_mode``)
_KERNEL_METRICS = ("euclidean", "sqeuclidean", "dot", "cosine")


def is_dtensor(x) -> bool:
    """A ``torch.distributed.tensor.DTensor``: it carries its device mesh,
    and its rows lie on the mesh's ranks."""
    return getattr(x, "device_mesh", None) is not None


def resolve_device(device=None, like=None) -> torch.device:
    """``device`` if given, else the device of tensor ``like``, else
    ``cuda``.  Raises when the resolved device is CUDA and none is present."""
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) \
            else DEFAULT_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch path on the CPU")
    return dev


def as_points(x, device=None, dtype=torch.float32) -> torch.Tensor:
    """``x`` (numpy array, sequence or tensor) as a ``dtype`` tensor on the
    resolved device.  A tensor already there in ``dtype`` is returned as is:
    the points cross to the device once and stay."""
    dev = resolve_device(device, like=x)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def resolve_use_pallas(use_pallas, device: torch.device,
                       metric_name: str) -> bool:
    """Resolve the kernel switch for a run on ``device``.

    ``"auto"``: the CUDA kernel for CUDA tensors when the metric has a
    kernel mode, else the plain torch sweep.  ``True``: the kernel, which
    needs a CUDA device and a kernel metric (raises otherwise).  ``False``:
    the plain torch sweep on any device."""
    dev = torch.device(device)
    if use_pallas == "auto" or use_pallas is None:
        return dev.type == "cuda" and metric_name in _KERNEL_METRICS
    if not use_pallas:
        return False
    if dev.type != "cuda":
        raise ValueError(
            "use_pallas=True launches the CUDA kernel and needs CUDA "
            f"tensors; the points are on {dev}")
    if metric_name not in _KERNEL_METRICS:
        raise ValueError(f"no kernel path for metric {metric_name!r}")
    return True


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (or passthrough of array-likes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Meshes: ``torch.distributed`` ``DeviceMesh``es with named dims.

The port of ``repro.launch.mesh``.  Both constructors are functions, so
importing this module touches no device or process-group state.  A mesh
spans the default process group, which the caller starts
(``torch.distributed.init_process_group``); ``make_production_mesh``
needs one of 256 or 512 ranks, which in practice is the dry-run's fake
process group (``launch/dryrun.py``).  Its devices are ``cuda`` unless
``device_type`` names another.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import resolve_device


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _device_type(device_type: Optional[str]) -> str:
    """``cuda`` unless the caller names another (``resolve_device``)."""
    return resolve_device(device_type).type


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), on a process group of exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, want = _world(), math.prod(shape)
    if n != want:
        raise RuntimeError(f"a {shape} mesh needs {want} ranks, the "
                           f"process group has {n}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None, *,
                   pod: Optional[int] = None):
    """A small ("data", "model") mesh over the default process group,
    clamped to its world size as the reference clamps to its devices:
    ``data`` at most the world, ``model`` at most what is left.  With
    ``pod`` a ("pod", "data", "model") mesh, the production multi-pod
    mesh's axes (``pod`` clamped first, then ``data`` and ``model`` to
    what is left).  The mesh takes the first ranks of the group."""
    from torch.distributed.device_mesh import DeviceMesh
    n = _world()
    lead, names = (), ("data", "model")
    if pod is not None:
        pod = max(1, min(pod, n))
        n //= pod
        lead, names = (pod,), ("pod", "data", "model")
    data = min(data, n)
    model = max(1, min(model, n // data))
    shape = lead + (data, model)
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(_device_type(device_type), ranks,
                      mesh_dim_names=names)

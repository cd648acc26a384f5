"""PyTorch/CUDA port of the Clock2Q+ reproduction.

This package mirrors ``repro``'s layout and names, module for module, so
a reader finds each module's counterpart.  It imports ``torch`` and
numpy only: nothing of JAX and nothing of the ``repro`` package (it
keeps its own copies of what it needs; ``tests/test_torch_boundary.py``
enforces that).

Entry points run on the card: with no ``device=`` argument they use
``cuda`` and raise where there is none.  The plain PyTorch versions of
the kernels run only for tensors that the caller put on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises where CUDA is asked for and absent; there is
    no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev

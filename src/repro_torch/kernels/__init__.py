"""Hand-written Hopper kernels of the port, one package each: the CUDA
source under ``csrc/``, its build, its wrapper (``ops``) and its plain
PyTorch version (``ref``)."""


def refuse_grad(kernel: str, tensors, missing: str) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any of ``tensors``
    requires it: the CUDA launch of ``kernel`` writes its output through
    ``ctypes``, which records no autograd graph, so a loss built on it
    would silently stop the gradient.  ``missing`` says what is missing
    (the backward kernel's work item)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} on CUDA has no backward: {missing}.  Call it under "
            f"torch.no_grad() (inference), or on CPU tensors, whose plain "
            f"version autograd differentiates")

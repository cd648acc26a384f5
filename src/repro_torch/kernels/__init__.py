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


def runs_plain(kernel: str, t) -> bool:
    """Whether a wrapper handed ``t`` runs its kernel's plain version: a
    CPU tensor that holds data.  A CUDA tensor goes to the kernel's
    operator (``torch.ops.repro_torch``), whose CUDA implementation
    launches the kernel; so does a tensor of shapes only (a
    ``FakeTensorMode`` trace, on any device), whose registered fake
    implementation gives the outputs' shapes.  Any other device
    raises."""
    if t.device.type == "cuda":
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {t.device}")
    from torch._subclasses.fake_tensor import is_fake

    return not is_fake(t)

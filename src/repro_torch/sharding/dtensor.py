"""DTensor helpers of the sharded model: what the model calls where a
tensor may be a DTensor (the sharded train step's params and batch are,
``training/step.py``), and the identity on plain tensors.

* ``is_dtensor`` — whether a tensor is a DTensor.
* ``settle`` — a DTensor with its pending (``Partial``) reductions done,
  so that later ops see replicated values.
* ``to_placements`` / ``replicate`` — a DTensor redistributed.
* ``local_in`` / ``local_out`` — a DTensor's local shard with what its
  gradient is, and back: the kernel call sites run on local shards.
* ``like`` — a gradient reduced to its param's placements; ``plain`` —
  a replicated DTensor's value; ``implicit`` — DTensor's implicit
  replication of plain tensors; ``refuse`` — the kernels' guard.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def settle(x):
    """``x`` with every ``Partial`` placement reduced to ``Replicate``
    (an all-reduce over that mesh dim); a plain tensor as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def to_placements(x, placements):
    """``x`` redistributed to ``placements`` where it is a DTensor."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements)


def local_in(x, placements, grad_placements=None):
    """``x`` redistributed to ``placements``, as its local tensor;
    ``grad_placements`` say what the local gradient is (``Partial()``
    on a mesh dim where each rank's local computation gives only its
    share of it), by default ``placements``."""
    x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements or placements)


def local_out(t, like, placements):
    """Local tensor ``t`` as a DTensor on ``like``'s mesh, evenly split
    by ``placements``."""
    return DTensor.from_local(t, like.device_mesh, placements,
                              run_check=False)


def like(g, t):
    """Gradient ``g`` of DTensor ``t`` reduced to ``t``'s placements (its
    ``Partial`` sums done: an all-reduce, or a reduce-scatter where ``t``
    is split); a plain gradient as it is."""
    if not is_dtensor(g):
        return g
    return g.redistribute(t.device_mesh, t.placements)


def plain(x):
    """A replicated DTensor's value as a plain tensor (every rank holds
    it whole); anything else as it is."""
    if is_dtensor(x):
        return settle(x).full_tensor()
    return x


def implicit():
    """DTensor's implicit replication: a plain tensor that meets a
    DTensor in an op counts as replicated (the positions, masks and
    scalars the model makes); no effect on plain ops."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def refuse(kernel: str, *tensors) -> None:
    """Raise where a DTensor reaches a kernel wrapper: the kernels take
    each rank's local shards (the model's call sites hand them over),
    never a DTensor, and never fall back to their plain versions for
    one."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{kernel} takes local tensors, not DTensors: call it through "
            f"the model's call site, which hands it each rank's shards")


def replicate(x):
    """DTensor ``x`` replicated on every mesh dim (its pending sums done,
    its shards gathered)."""
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduce_grad(x):
    """``x`` as it is, its gradient reduced to ``x``'s placements in the
    backward pass (Megatron's identity-forward, all-reduce-backward
    operator), at the input of a block of column-split products: left
    to itself DTensor keeps that gradient ``Partial`` down the residual
    stream and, at the next row-split product's backward, gathers the
    weight rather than reduce the activation's gradient.  A plain
    tensor, or one that needs no gradient, as it is."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, run_check=False)

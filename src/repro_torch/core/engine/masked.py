"""The masked single-slot gather/scatter shared by the lane-batched step.

Lanes diverge, so the step is straight-line code over mutually exclusive
case masks, with ``mset`` as its single write primitive.  Every array is
a contiguous ``(L, N)`` tensor, one row per lane, indexed with one int64
index per lane in ``[0, N)`` through its flat view.  The step clamps a
garbage index (a -1 key, a slot of another ring) into the row where its
lane's mask is False; the write there rewrites the slot's own value.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _row_starts(L: int, N: int, device: torch.device) -> torch.Tensor:
    return torch.arange(0, L * N, N, device=device)


def _flat(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    L, N = arr.shape
    return _row_starts(L, N, arr.device) + i


def mget(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``arr[l, i[l]]`` for every lane ``l``."""
    return torch.take(arr, _flat(arr, i))


def mset(arr: torch.Tensor, i: torch.Tensor, val, mask: torch.Tensor) -> None:
    """Masked single-slot scatter, in place: ``arr[l, i[l]] = val[l]``
    where ``mask[l]``, else unchanged (the masked-off lane rewrites its
    slot with its own value)."""
    fi = _flat(arr, i)
    new = torch.where(mask, val, torch.take(arr, fi))
    arr.view(-1).scatter_(0, fi, new if new.dtype == arr.dtype
                          else new.to(arr.dtype))

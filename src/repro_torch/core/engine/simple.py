"""Capacity-masked FIFO / Clock / LRU steps, lane-batched in PyTorch.

The port of ``repro/core/engine/simple.py``: the same state keys, dtypes
and padded layout, with a leading lane axis on every tensor.  Each ring
is padded to the grid's widest, the logical capacity is the per-lane
``cap``, cursors wrap modulo ``cap``, and ``key < 0`` is the no-op
padding sentinel.  Clock's victim is the reference's closed-form sweep:
the first slot from the hand that is not occupied-and-ref'd, the refs it
passed cleared; a fruitless full lap clears every ref and takes the hand
slot.  LRU's victim is the ``argmin`` of ``last`` over the logical
slots, the first index on ties (empty slots hold -1 and fill in index
order).

Each ``*_step`` updates the state IN PLACE.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine.layout import EMPTY, SweepConfig
from repro_torch.core.engine.masked import mget, mset

_I32_MAX = 2**31 - 1

# Every state tensor and its dtype, per family: the reference's layout.
FIFO_DTYPES = dict(keys=torch.int32, pos=torch.int32, resident=torch.bool,
                   cap=torch.int32)
CLOCK_DTYPES = dict(keys=torch.int32, ref=torch.bool, hand=torch.int32,
                    loc=torch.int32, cap=torch.int32)
LRU_DTYPES = dict(keys=torch.int32, last=torch.int32, t=torch.int32,
                  loc=torch.int32, cap=torch.int32)
DTYPES = dict(fifo=FIFO_DTYPES, clock=CLOCK_DTYPES, lru=LRU_DTYPES)
# The (L, width) tensors of each family and the width each is padded to.
RINGS = dict(keys="pC", ref="pC", last="pC", resident="U", loc="U")

State = Dict[str, torch.Tensor]


def sizes(cfg: SweepConfig) -> Tuple[int]:
    """Logical array size for a simple single-ring policy."""
    return (max(1, cfg.capacity),)


def _lanes(configs: Sequence[SweepConfig], phys, device):
    caps = [sizes(c)[0] for c in configs]
    (pC,) = phys if phys is not None else (max(caps),)
    cap = torch.tensor(caps, dtype=torch.int32, device=device)
    zero = torch.zeros(len(configs), dtype=torch.int32, device=device)
    keys = torch.full((len(configs), pC), EMPTY, dtype=torch.int32,
                      device=device)
    return keys, cap, zero


# -- FIFO ----------------------------------------------------------------------

def fifo_init_lanes(configs: Sequence[SweepConfig], universe: int,
                    phys: Optional[Tuple[int]] = None,
                    device=None) -> State:
    """Masked FIFO state for ``len(configs)`` lanes."""
    keys, cap, zero = _lanes(configs, phys, device)
    return dict(keys=keys, pos=zero,
                resident=torch.zeros((len(configs), int(universe)),
                                     dtype=torch.bool, device=device),
                cap=cap)


def fifo_step(st: State, key: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One FIFO transition per lane, in place: ``(state, key (L,)) ->
    (state, hit (L,) bool)``."""
    active = key >= 0
    if not bool(active.any()):
        return st, active
    key = key.long().clamp(min=0)
    hit = active & mget(st["resident"], key)
    miss = active & ~hit
    s = st["pos"].long()
    old = mget(st["keys"], s).long()
    mset(st["resident"], old.clamp(min=0), False, miss & (old >= 0))
    mset(st["resident"], key, True, miss)
    mset(st["keys"], s, key, miss)
    st["pos"].copy_(torch.where(miss, (s + 1) % st["cap"], s))
    return st, hit


# -- Clock (second chance) -----------------------------------------------------

def clock_init_lanes(configs: Sequence[SweepConfig], universe: int,
                     phys: Optional[Tuple[int]] = None,
                     device=None) -> State:
    """Masked second-chance Clock state for ``len(configs)`` lanes."""
    keys, cap, zero = _lanes(configs, phys, device)
    return dict(keys=keys, ref=torch.zeros_like(keys, dtype=torch.bool),
                hand=zero,
                loc=torch.full((len(configs), int(universe)), EMPTY,
                               dtype=torch.int32, device=device),
                cap=cap)


def clock_step(st: State, key: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One Clock transition per lane, in place."""
    active = key >= 0
    if not bool(active.any()):
        return st, active
    key = key.long().clamp(min=0)
    keys, ref, loc = st["keys"], st["ref"], st["loc"]
    slot = mget(loc, key).long()
    hit = active & (slot >= 0)
    miss = active & ~hit
    mset(ref, slot.clamp(min=0), True, hit)
    if not bool(miss.any()):
        return st, hit

    # closed-form sweep: first slot (cyclic from hand) not occupied&ref'd;
    # a full fruitless lap clears every ref and takes the hand slot
    C = keys.shape[1]  # physical ring size
    cap, hand = st["cap"].long(), st["hand"].long()
    idx = torch.arange(C, device=keys.device)
    valid = idx < cap[:, None]
    d = torch.where(valid, torch.remainder(idx - hand[:, None], cap[:, None]),
                    C + 1)
    skippable = (keys >= 0) & ref
    vd = torch.where(valid & ~skippable, d, C + 1).amin(dim=1)
    vd = torch.minimum(vd, cap)
    ms = (hand + vd) % cap
    ref &= ~(miss[:, None] & valid & (d < vd[:, None]))
    victim = mget(keys, ms).long()
    mset(loc, victim.clamp(min=0), EMPTY, miss & (victim >= 0))
    mset(loc, key, ms, miss)
    mset(keys, ms, key, miss)
    mset(ref, ms, False, miss)
    st["hand"].copy_(torch.where(miss, (ms + 1) % cap, hand))
    return st, hit


# -- LRU -----------------------------------------------------------------------

def lru_init_lanes(configs: Sequence[SweepConfig], universe: int,
                   phys: Optional[Tuple[int]] = None,
                   device=None) -> State:
    """Masked LRU state (exact, timestamp-argmin victim)."""
    keys, cap, zero = _lanes(configs, phys, device)
    return dict(keys=keys, last=torch.full_like(keys, -1), t=zero,
                loc=torch.full((len(configs), int(universe)), EMPTY,
                               dtype=torch.int32, device=device),
                cap=cap)


def lru_step(st: State, key: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One LRU transition per lane, in place."""
    active = key >= 0
    if not bool(active.any()):
        return st, active
    key = key.long().clamp(min=0)
    keys, last, loc = st["keys"], st["last"], st["loc"]
    slot = mget(loc, key).long()
    hit = active & (slot >= 0)
    miss = active & ~hit
    # empty logical slots have last = -1 and are picked first; padded
    # slots are masked to +inf (ties: argmin's first index)
    valid = torch.arange(keys.shape[1], device=keys.device) \
        < st["cap"][:, None]
    s = torch.where(valid, last, _I32_MAX).argmin(dim=1)
    victim = mget(keys, s).long()
    mset(loc, victim.clamp(min=0), EMPTY, miss & (victim >= 0))
    mset(keys, s, key, miss)
    tslot = torch.where(hit, slot, s)
    mset(last, tslot, st["t"], active)
    st["t"].add_(active.to(torch.int32))
    mset(loc, key, tslot, miss)
    return st, hit

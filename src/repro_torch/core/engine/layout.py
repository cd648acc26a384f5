"""Unified state layout for the capacity-masked policy core.

The port's own copy of ``repro/core/engine/layout.py``: the constants
and sizing formulas every engine derives its sizes from.  Plain Python
(no torch, no numpy), so the sizes match the reference's exactly.

``SweepConfig`` (one grid point: a full policy parameterization) also
lives here, below the step modules, to avoid an import cycle with the
engine registry.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Sentinel for an empty slot in every key array (queue rings, location
# tables).
EMPTY = -1

# Location-table "where" codes: which segment a key currently lives in.
W_NONE, W_SMALL, W_MAIN, W_GHOST = 0, 1, 2, 3


def seg(capacity: int, frac: float) -> int:
    """Segment size for a fraction of ``capacity`` (at least one slot)."""
    return max(1, int(round(capacity * frac)))


def c2qp_sizes(capacity: int, small_frac: float = 0.1,
               ghost_frac: float = 0.5,
               window_frac: float = 0.5) -> Tuple[int, int, int, int]:
    """(small, main, ghost, window) segment sizes for one Clock2Q+
    configuration — the single source of the sizing formulas."""
    S = min(capacity, seg(capacity, small_frac))
    M = max(1, capacity - S)
    G = seg(capacity, ghost_frac)
    W = int(round(window_frac * S))
    return S, M, G, W


def sq_sizes(capacity: int, small_frac: float = 0.1,
             ghost_frac: float = 1.0) -> Tuple[int, int, int]:
    """(small, main, ghost) sizes for the S3-FIFO family (no correlation
    window; ghost defaults to a FULL capacity's worth of tombstones)."""
    S = min(capacity, seg(capacity, small_frac))
    M = max(1, capacity - S)
    G = seg(capacity, ghost_frac)
    return S, M, G


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One grid point: a full policy parameterization.

    ``skip_limit`` uses the sweep convention: 0 = unlimited (the paper
    default).  ``policy`` selects the registered lane engine; fields a
    policy does not read (see ``PolicyEngine.knobs``) are ignored by it.
    ``bits`` is only read by the s3fifo family (1- vs 2-bit counters).

    The field DEFAULTS are the Clock2Q+ paper defaults; build configs
    for another policy through ``get_engine(name).config(capacity,
    ...)``, which applies that engine's own preset.
    """
    capacity: int
    window_frac: float = 0.5
    small_frac: float = 0.1
    ghost_frac: float = 0.5
    skip_limit: int = 0
    policy: str = "clock2q+"
    bits: int = 2

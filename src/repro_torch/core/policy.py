"""Cache-policy API shared by every replacement algorithm in the zoo.

The port's own copy of ``repro/core/policy.py``.

Keys are opaque hashable block ids (ints in practice).  ``access`` returns
True on a hit.  Policies that support dirty blocks accept ``dirty=True`` on
access (a write); others ignore the flag.

Event recording (``record_events=True``) captures queue-flow events used by
the Table-1 / Fig-10 reproductions:

    ("small_to_main", key, t) | ("small_to_ghost", key, t) |
    ("ghost_to_main", key, t) | ("evict_main", key, t) | ("evict_small", key, t)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple


@dataclasses.dataclass
class SimResult:
    name: str
    capacity: int
    requests: int
    hits: int

    @property
    def misses(self) -> int:
        return self.requests - self.hits

    @property
    def miss_ratio(self) -> float:
        return self.misses / max(1, self.requests)

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.requests)


class CachePolicy:
    """Base class.  Subclasses implement ``access``."""

    name: str = "base"

    def __init__(self, capacity: int, record_events: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.record_events = record_events
        self.events: List[Tuple[str, int, int]] = []
        self.clock_time = 0  # request counter, advanced by access()

    # -- subclass API ------------------------------------------------------
    def access(self, key, dirty: bool = False) -> bool:
        raise NotImplementedError

    def __contains__(self, key) -> bool:  # resident (data present, not ghost)
        raise NotImplementedError

    def __len__(self) -> int:  # number of resident blocks
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------
    def _event(self, kind: str, key) -> None:
        if self.record_events:
            self.events.append((kind, key, self.clock_time))

    def run(self, trace: Iterable, dirty_fn: Optional[Callable] = None) -> SimResult:
        """Replay ``trace``; ``dirty_fn(i, key) -> bool`` marks writes."""
        hits = 0
        n = 0
        for i, key in enumerate(trace):
            self.clock_time = i
            d = bool(dirty_fn(i, key)) if dirty_fn is not None else False
            hits += self.access(key, dirty=d)
            n += 1
        return SimResult(self.name, self.capacity, n, hits)


# ---------------------------------------------------------------------------
# registry

_REGISTRY: Dict[str, Callable[..., CachePolicy]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_policy(name: str, capacity: int, **kw) -> CachePolicy:
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](capacity, **kw)


def policy_names() -> List[str]:
    return sorted(_REGISTRY)


def seg_size(capacity: int, frac: float, minimum: int = 1) -> int:
    """Segment sizing helper: round(frac*capacity) clamped to [minimum, capacity-?]."""
    return max(minimum, int(round(capacity * frac)))

"""S3-FIFO (SOSP'23), as described in the Clock2Q+ paper §3.3.

The port's own copy of ``repro/core/policies/s3fifo.py``.

Sizing: Small FIFO = 10%, Main = 90% of capacity, Ghost = 100% of capacity
(keys only).  ``bits=1``: promote on >=1 re-reference (freq cap 1).
``bits=2`` (the default "S3-FIFO 2-bit"): promote on >=2 re-references
(freq cap 3).  The Main queue is a FIFO with reinsertion (freq decrement),
equivalent to a coarse clock; ``skip_limit`` bounds reinsertions per
eviction (paper §5.5.2).
"""

from __future__ import annotations

import collections

from repro_torch.core.policy import CachePolicy, register, seg_size
from repro_torch.core.policies.two_q import _GhostFIFO


@register("s3fifo")
class S3FIFO(CachePolicy):
    name = "s3fifo"

    def __init__(self, capacity: int, small_frac: float = 0.1,
                 ghost_frac: float = 1.0, bits: int = 2, skip_limit=None, **kw):
        super().__init__(capacity, **kw)
        self.name = f"s3fifo-{bits}bit"
        small_cap = min(capacity, seg_size(capacity, small_frac))
        self.small_cap = small_cap
        self.main_cap = max(1, capacity - small_cap)
        self.freq_cap = 1 if bits == 1 else 3
        self.promote_at = 1 if bits == 1 else 2
        self.small = collections.deque()  # [key, freq]
        self.main = collections.deque()   # [key, freq]
        self.in_small = {}  # key -> entry
        self.in_main = {}
        self.ghost = _GhostFIFO(seg_size(capacity, ghost_frac))
        self.skip_limit = skip_limit
        self.skipped_per_eviction = []

    # -- internals ---------------------------------------------------------
    def _evict_main(self):
        skips = 0
        while True:
            e = self.main.popleft()
            key, freq = e
            if freq >= 1 and (self.skip_limit is None or skips < self.skip_limit):
                e[1] = freq - 1
                self.main.append(e)
                skips += 1
                continue
            del self.in_main[key]
            self._event("evict_main", key)
            self.skipped_per_eviction.append(skips)
            return

    def _insert_main(self, key):
        while len(self.main) >= self.main_cap:
            self._evict_main()
        e = [key, 0]
        self.main.append(e)
        self.in_main[key] = e

    def _evict_small(self):
        e = self.small.popleft()
        key, freq = e
        del self.in_small[key]
        if freq >= self.promote_at:
            self._event("small_to_main", key)
            self._insert_main(key)
        else:
            self._event("small_to_ghost", key)
            self.ghost.push(key)

    # -- public ------------------------------------------------------------
    def access(self, key, dirty: bool = False) -> bool:
        e = self.in_small.get(key)
        if e is not None:
            e[1] = min(self.freq_cap, e[1] + 1)
            return True
        e = self.in_main.get(key)
        if e is not None:
            e[1] = min(self.freq_cap, e[1] + 1)
            return True
        if key in self.ghost:
            self.ghost.remove(key)
            self._event("ghost_to_main", key)
            self._insert_main(key)
            return False
        while len(self.small) >= self.small_cap:
            self._evict_small()
        e = [key, 0]
        self.small.append(e)
        self.in_small[key] = e
        return False

    def __contains__(self, key):
        return key in self.in_small or key in self.in_main

    def __len__(self):
        return len(self.in_small) + len(self.in_main)

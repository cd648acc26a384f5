"""Clock2Q+ — the paper's contribution (§3.4, §5.5), as the pure-Python
oracle: the port's own copy of ``repro/core/policies/clock2qplus.py``
with the algorithm only (``dirty_mode="off"``; no flushers, no adaptive
variant, no event log).

Structure: Small FIFO (10% of capacity) with a correlation window covering
the ``window_frac`` (default 50%) most-recently-inserted entries; Main
Clock (90%); Ghost FIFO (50%, keys only).

Semantics:
  * hit in Small FIFO: the Ref bit is set ONLY if the block has aged past
    the correlation window (i.e. >= W insertions happened since it entered).
  * hit in Main Clock: sets the Ref bit (second chance).
  * miss + ghost hit: block goes straight into the Main Clock.
  * miss: block enters the Small FIFO; Small-FIFO eviction promotes
    ref-set blocks to the Main Clock and pushes the rest to the Ghost FIFO.
"""

from __future__ import annotations

import collections

from repro_torch.core.policy import CachePolicy, seg_size
from repro_torch.core.policies.two_q import _GhostFIFO, _MainClock


class _SmallEntry:
    __slots__ = ("key", "ref", "seq")

    def __init__(self, key, seq):
        self.key = key
        self.ref = False
        self.seq = seq


class Clock2QPlus(CachePolicy):
    """The Clock2Q+ policy; ``skip_limit`` None means unlimited."""

    name = "clock2q+"

    def __init__(self, capacity: int, small_frac: float = 0.1,
                 ghost_frac: float = 0.5, window_frac: float = 0.5,
                 skip_limit=None):
        super().__init__(capacity)
        small_cap = min(capacity, seg_size(capacity, small_frac))
        self.small_cap = small_cap
        self.window = int(round(window_frac * small_cap))
        self.small = collections.deque()  # _SmallEntry, head = oldest
        self.in_small = {}
        self.ghost = _GhostFIFO(seg_size(capacity, ghost_frac))
        self.main = _MainClock(max(1, capacity - small_cap), skip_limit=skip_limit)
        self.small_seq = 0  # insertion counter for window aging

    def _insert_main(self, key):
        if self.main.full():
            self.main.evict()
        self.main.insert(key)

    def _evict_small(self):
        e = self.small.popleft()
        del self.in_small[e.key]
        if e.ref:
            self._insert_main(e.key)
        else:
            self.ghost.push(e.key)

    def access(self, key) -> bool:
        """Serve one request; True on a hit."""
        e = self.in_small.get(key)
        if e is not None:
            if self.small_seq - e.seq >= self.window:
                e.ref = True
            return True
        if self.main.hit(key):
            return True
        if key in self.ghost:
            self.ghost.remove(key)
            self._insert_main(key)
            return False
        # brand-new block
        if len(self.small) >= self.small_cap:
            self._evict_small()
        e = _SmallEntry(key, self.small_seq)
        self.small_seq += 1
        self.small.append(e)
        self.in_small[key] = e
        return False

    def __contains__(self, key):
        """Whether ``key`` is resident (Small FIFO or Main clock)."""
        return key in self.in_small or key in self.main

    def __len__(self):
        """Number of resident blocks."""
        return len(self.in_small) + len(self.main)

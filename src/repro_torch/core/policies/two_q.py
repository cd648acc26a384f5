"""2Q (VLDB'94, full version sizing per the paper's Fig. 2) and Clock2Q

The port's own copy of ``repro/core/policies/two_q.py``.
(vSAN's previous algorithm: 2Q with the Main LRU replaced by a Clock).

Sizing (paper §3.1/§3.2): Main = 75%, Small FIFO = 25% of capacity,
Ghost FIFO = 50% of capacity (keys only).
"""

from __future__ import annotations

import collections
from collections import OrderedDict

from repro_torch.core.policy import CachePolicy, register, seg_size


class _GhostFIFO:
    """Ghost FIFO with the paper's production ring semantics (§4.1): a ring
    of the last ``capacity`` pushed keys; a promoted (removed) key leaves a
    tombstone that is reclaimed only when the ring wraps over it.

    Entries are sequence-stamped so that lazy removals (ghost hits) never
    evict a newer re-insertion of the same key via a stale ring entry.
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self.q = collections.deque()  # (key, seq), ring of last `capacity` pushes
        self.members = {}  # key -> latest seq
        self._seq = 0

    def push(self, key):
        self._seq += 1
        self.q.append((key, self._seq))
        self.members[key] = self._seq
        while len(self.q) > self.capacity:
            k, s = self.q.popleft()
            if self.members.get(k) == s:
                del self.members[k]

    def remove(self, key):
        self.members.pop(key, None)  # deque entry becomes stale

    def __contains__(self, key):
        return key in self.members

    def __len__(self):
        return len(self.members)


class _SmallFIFO:
    """Bounded FIFO of resident keys (no ref bits) with O(1) membership."""

    def __init__(self, capacity: int):
        self.capacity = max(1, capacity)
        self.q = collections.deque()
        self.members = set()

    def full(self) -> bool:
        return len(self.q) >= self.capacity

    def push(self, key):
        self.q.append(key)
        self.members.add(key)

    def pop(self):
        key = self.q.popleft()
        self.members.discard(key)
        return key

    def __contains__(self, key):
        return key in self.members

    def __len__(self):
        return len(self.members)


@register("2q")
class TwoQ(CachePolicy):
    name = "2q"

    def __init__(self, capacity: int, small_frac: float = 0.25,
                 ghost_frac: float = 0.5, **kw):
        super().__init__(capacity, **kw)
        small_cap = min(capacity, seg_size(capacity, small_frac))
        self.main_cap = max(1, capacity - small_cap)
        self.small = _SmallFIFO(small_cap)
        self.ghost = _GhostFIFO(seg_size(capacity, ghost_frac))
        self.main = OrderedDict()  # LRU: MRU at end

    def _insert_main(self, key):
        while len(self.main) >= self.main_cap:
            victim, _ = self.main.popitem(last=False)
            self._event("evict_main", victim)
        self.main[key] = None

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.main:
            self.main.move_to_end(key)
            return True
        if key in self.small:
            return True  # 2Q: no action for A1in hits
        if key in self.ghost:
            self.ghost.remove(key)
            self._event("ghost_to_main", key)
            self._insert_main(key)
            return False
        # brand-new block -> Small FIFO
        if self.small.full():
            victim = self.small.pop()
            self._event("small_to_ghost", victim)
            self.ghost.push(victim)
        self.small.push(key)
        return False

    def __contains__(self, key):
        return key in self.main or key in self.small

    def __len__(self):
        return len(self.main) + len(self.small)


class _MainClock:
    """Second-chance clock used as the Main queue of Clock2Q/Clock2Q+/S3-FIFO.

    ``skip_limit``: max ref-skips per eviction before a block is forcibly
    evicted regardless of its ref bit (paper §5.5.2); None = unlimited.
    ``dirty_limit``: max dirty blocks skipped per eviction before giving up.
    """

    def __init__(self, capacity: int, skip_limit=None, dirty_limit: int = 64):
        self.capacity = max(1, capacity)
        self.keys = [None] * self.capacity
        self.ref = [False] * self.capacity
        self.dirty = [False] * self.capacity
        self.slot_of = {}
        self.hand = 0
        self.fill = 0
        self.skip_limit = skip_limit
        self.dirty_limit = dirty_limit
        self.skipped_per_eviction = []  # stats for Fig. 12a

    def full(self) -> bool:
        return self.fill >= self.capacity and len(self.slot_of) >= self.capacity

    def hit(self, key) -> bool:
        s = self.slot_of.get(key)
        if s is None:
            return False
        self.ref[s] = True
        return True

    def set_dirty(self, key, val: bool):
        s = self.slot_of.get(key)
        if s is not None:
            self.dirty[s] = val

    def evict(self):
        """Return the evicted key (and free its slot), honoring skip limits."""
        ref_skips = 0
        dirty_skips = 0
        forced = False
        while True:
            s = self.hand
            if self.keys[s] is None:  # free slot (can happen after resize)
                self.hand = (self.hand + 1) % self.capacity
                continue
            if self.dirty[s]:
                dirty_skips += 1
                self.hand = (self.hand + 1) % self.capacity
                if dirty_skips > self.dirty_limit:
                    # production: trigger synchronous flush of this block
                    self.dirty[s] = False
                continue
            if self.ref[s] and not forced:
                self.ref[s] = False
                ref_skips += 1
                self.hand = (self.hand + 1) % self.capacity
                if self.skip_limit is not None and ref_skips >= self.skip_limit:
                    forced = True  # next clean block goes regardless of ref
                continue
            victim = self.keys[s]
            self.keys[s] = None
            self.ref[s] = False
            del self.slot_of[victim]
            self.hand = (self.hand + 1) % self.capacity
            self.skipped_per_eviction.append(ref_skips)
            return victim

    def insert(self, key, dirty: bool = False):
        """Insert assuming a free slot exists (call evict() first if full)."""
        if self.fill < self.capacity:
            s = self.fill
            self.fill += 1
            if self.keys[s] is not None:  # shouldn't happen
                raise RuntimeError("clock fill bookkeeping broken")
        else:
            # reuse the slot most recently freed by evict(): scan from hand-1
            s = None
            for off in range(self.capacity):
                cand = (self.hand - 1 - off) % self.capacity
                if self.keys[cand] is None:
                    s = cand
                    break
            if s is None:
                raise RuntimeError("insert into full clock without evict")
        self.keys[s] = key
        self.ref[s] = False
        self.dirty[s] = dirty
        self.slot_of[key] = s

    def __contains__(self, key):
        return key in self.slot_of

    def __len__(self):
        return len(self.slot_of)


@register("clock2q")
class Clock2Q(CachePolicy):
    """2Q with a Main Clock (the previous vSAN algorithm, paper §3.2)."""

    name = "clock2q"

    def __init__(self, capacity: int, small_frac: float = 0.25,
                 ghost_frac: float = 0.5, skip_limit=None, **kw):
        super().__init__(capacity, **kw)
        small_cap = min(capacity, seg_size(capacity, small_frac))
        self.small = _SmallFIFO(small_cap)
        self.ghost = _GhostFIFO(seg_size(capacity, ghost_frac))
        self.main = _MainClock(max(1, capacity - small_cap), skip_limit=skip_limit)

    def _insert_main(self, key):
        if self.main.full():
            victim = self.main.evict()
            self._event("evict_main", victim)
        self.main.insert(key)

    def access(self, key, dirty: bool = False) -> bool:
        if self.main.hit(key):
            return True
        if key in self.small:
            return True  # no ref bit in Clock2Q's Small FIFO
        if key in self.ghost:
            self.ghost.remove(key)
            self._event("ghost_to_main", key)
            self._insert_main(key)
            return False
        if self.small.full():
            victim = self.small.pop()
            self._event("small_to_ghost", victim)
            self.ghost.push(victim)
        self.small.push(key)
        return False

    def __contains__(self, key):
        return key in self.main or key in self.small

    def __len__(self):
        return len(self.main) + len(self.small)

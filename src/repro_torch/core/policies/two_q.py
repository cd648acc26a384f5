"""The queues the Clock2Q+ oracle is built from: the port's own copy of
``_GhostFIFO`` and ``_MainClock`` from ``repro/core/policies/two_q.py``
(without the dirty-block handling, which the port does not model)."""

from __future__ import annotations

import collections


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
        """Append ``key``; the oldest entry falls off a full ring."""
        self._seq += 1
        self.q.append((key, self._seq))
        self.members[key] = self._seq
        while len(self.q) > self.capacity:
            k, s = self.q.popleft()
            if self.members.get(k) == s:
                del self.members[k]

    def remove(self, key):
        """Forget ``key`` (its ring entry becomes a tombstone)."""
        self.members.pop(key, None)

    def __contains__(self, key):
        """Whether ``key`` is a live ghost."""
        return key in self.members

    def __len__(self):
        """Number of live ghosts."""
        return len(self.members)


class _MainClock:
    """Second-chance clock used as the Main queue of Clock2Q+.

    ``skip_limit``: max ref-skips per eviction before a block is forcibly
    evicted regardless of its ref bit (paper §5.5.2); None = unlimited.
    """

    def __init__(self, capacity: int, skip_limit=None):
        self.capacity = max(1, capacity)
        self.keys = [None] * self.capacity
        self.ref = [False] * self.capacity
        self.slot_of = {}
        self.hand = 0
        self.fill = 0
        self.skip_limit = skip_limit

    def full(self) -> bool:
        """Whether every slot holds a block."""
        return self.fill >= self.capacity and len(self.slot_of) >= self.capacity

    def hit(self, key) -> bool:
        """Set ``key``'s ref bit if resident; True on a hit."""
        s = self.slot_of.get(key)
        if s is None:
            return False
        self.ref[s] = True
        return True

    def evict(self):
        """Return the evicted key (and free its slot), honoring skip limits."""
        ref_skips = 0
        forced = False
        while True:
            s = self.hand
            if self.keys[s] is None:  # free slot
                self.hand = (self.hand + 1) % self.capacity
                continue
            if self.ref[s] and not forced:
                self.ref[s] = False
                ref_skips += 1
                self.hand = (self.hand + 1) % self.capacity
                if self.skip_limit is not None and ref_skips >= self.skip_limit:
                    forced = True  # next block goes regardless of ref
                continue
            victim = self.keys[s]
            self.keys[s] = None
            self.ref[s] = False
            del self.slot_of[victim]
            self.hand = (self.hand + 1) % self.capacity
            return victim

    def insert(self, key):
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
        self.slot_of[key] = s

    def __contains__(self, key):
        """Whether ``key`` is resident in the clock."""
        return key in self.slot_of

    def __len__(self):
        """Number of resident blocks."""
        return len(self.slot_of)

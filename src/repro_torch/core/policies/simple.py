"""Classic single-structure policies: FIFO, LRU, Clock, SLRU, LFU, SIEVE.

The port's own copy of ``repro/core/policies/simple.py``.
"""

from __future__ import annotations

import collections
import heapq
from collections import OrderedDict

from repro_torch.core.policy import CachePolicy, register, seg_size


@register("fifo")
class FIFO(CachePolicy):
    name = "fifo"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.q = collections.deque()
        self.resident = set()

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.resident:
            return True
        if len(self.q) >= self.capacity:
            old = self.q.popleft()
            self.resident.discard(old)
        self.q.append(key)
        self.resident.add(key)
        return False

    def __contains__(self, key):
        return key in self.resident

    def __len__(self):
        return len(self.resident)


@register("lru")
class LRU(CachePolicy):
    name = "lru"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.od = OrderedDict()  # key -> None; MRU at end

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.od:
            self.od.move_to_end(key)
            return True
        if len(self.od) >= self.capacity:
            self.od.popitem(last=False)
        self.od[key] = None
        return False

    def __contains__(self, key):
        return key in self.od

    def __len__(self):
        return len(self.od)


@register("clock")
class Clock(CachePolicy):
    """Second-chance clock over a fixed array of slots."""

    name = "clock"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.keys = [None] * capacity
        self.ref = [False] * capacity
        self.slot_of = {}
        self.hand = 0
        self.fill = 0

    def _evict_slot(self) -> int:
        while True:
            if self.ref[self.hand]:
                self.ref[self.hand] = False
                self.hand = (self.hand + 1) % self.capacity
                continue
            s = self.hand
            self.hand = (self.hand + 1) % self.capacity
            return s

    def access(self, key, dirty: bool = False) -> bool:
        s = self.slot_of.get(key)
        if s is not None:
            self.ref[s] = True
            return True
        if self.fill < self.capacity:
            s = self.fill
            self.fill += 1
        else:
            s = self._evict_slot()
            del self.slot_of[self.keys[s]]
        self.keys[s] = key
        self.ref[s] = False
        self.slot_of[key] = s
        return False

    def __contains__(self, key):
        return key in self.slot_of

    def __len__(self):
        return len(self.slot_of)


@register("slru")
class SLRU(CachePolicy):
    """Segmented LRU: probationary (20%) + protected (80%)."""

    name = "slru"

    def __init__(self, capacity: int, protected_frac: float = 0.8, **kw):
        super().__init__(capacity, **kw)
        self.prot_cap = min(capacity - 1, seg_size(capacity, protected_frac)) if capacity > 1 else 0
        self.prob_cap = capacity - self.prot_cap
        self.prob = OrderedDict()
        self.prot = OrderedDict()

    def _demote_overflow(self):
        while len(self.prot) > self.prot_cap:
            k, _ = self.prot.popitem(last=False)
            self._insert_prob(k)

    def _insert_prob(self, key):
        while len(self.prob) >= self.prob_cap:
            self.prob.popitem(last=False)
        self.prob[key] = None

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.prot:
            self.prot.move_to_end(key)
            return True
        if key in self.prob:
            del self.prob[key]
            self.prot[key] = None
            self._demote_overflow()
            return True
        self._insert_prob(key)
        return False

    def __contains__(self, key):
        return key in self.prob or key in self.prot

    def __len__(self):
        return len(self.prob) + len(self.prot)


@register("lfu")
class LFU(CachePolicy):
    """In-cache LFU with FIFO tie-break (lazy-deletion heap)."""

    name = "lfu"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.freq = {}
        self.heap = []  # (freq, seq, key) lazy entries
        self.seq = 0

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.freq:
            self.freq[key] += 1
            self.seq += 1
            heapq.heappush(self.heap, (self.freq[key], self.seq, key))
            return True
        if len(self.freq) >= self.capacity:
            while True:
                f, _, k = heapq.heappop(self.heap)
                if k in self.freq and self.freq[k] == f:
                    del self.freq[k]
                    break
        self.freq[key] = 1
        self.seq += 1
        heapq.heappush(self.heap, (1, self.seq, key))
        return False

    def __contains__(self, key):
        return key in self.freq

    def __len__(self):
        return len(self.freq)


@register("sieve")
class SIEVE(CachePolicy):
    """SIEVE (NSDI'24): single queue, visited bits, hand moves tail->head."""

    name = "sieve"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        # doubly linked list; head = newest, tail = oldest
        self.prev = {}
        self.next = {}
        self.visited = {}
        self.head = None
        self.tail = None
        self.hand = None

    def _unlink(self, key):
        p, n = self.prev[key], self.next[key]
        if p is not None:
            self.next[p] = n
        else:
            self.head = n
        if n is not None:
            self.prev[n] = p
        else:
            self.tail = p
        del self.prev[key], self.next[key], self.visited[key]

    def _push_head(self, key):
        self.prev[key] = None
        self.next[key] = self.head
        if self.head is not None:
            self.prev[self.head] = key
        self.head = key
        if self.tail is None:
            self.tail = key
        self.visited[key] = False

    def _evict(self):
        obj = self.hand if self.hand is not None else self.tail
        while obj is not None and self.visited[obj]:
            self.visited[obj] = False
            obj = self.prev[obj]
            if obj is None:
                obj = self.tail
        self.hand = self.prev[obj]
        self._unlink(obj)

    def access(self, key, dirty: bool = False) -> bool:
        if key in self.visited:
            self.visited[key] = True
            return True
        if len(self.visited) >= self.capacity:
            self._evict()
        self._push_head(key)
        return False

    def __contains__(self, key):
        return key in self.visited

    def __len__(self):
        return len(self.visited)

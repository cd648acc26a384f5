"""Belady's MIN — offline optimal, used as a lower bound in tests/benches.

The port's own copy of ``repro/core/policies/belady.py``.

Requires the trace up-front (``Belady(capacity, trace=...)``); ``access``
must then be called in trace order.
"""

from __future__ import annotations

import heapq

from repro_torch.core.policy import CachePolicy, register

_INF = 1 << 62


@register("belady")
class Belady(CachePolicy):
    name = "belady"

    def __init__(self, capacity: int, trace=None, **kw):
        super().__init__(capacity, **kw)
        if trace is None:
            raise ValueError("Belady requires trace=")
        self.trace = list(trace)
        # next_use[i] = index of next occurrence of trace[i] after i, or INF
        last = {}
        n = len(self.trace)
        self.next_use = [_INF] * n
        for i in range(n - 1, -1, -1):
            k = self.trace[i]
            self.next_use[i] = last.get(k, _INF)
            last[k] = i
        self.pos = 0
        self.resident = {}  # key -> next use index
        self.heap = []      # (-next_use, key) lazy

    def access(self, key, dirty: bool = False) -> bool:
        assert self.trace[self.pos] == key, "Belady must replay its own trace"
        nxt = self.next_use[self.pos]
        self.pos += 1
        if key in self.resident:
            self.resident[key] = nxt
            heapq.heappush(self.heap, (-nxt, key))
            return True
        if len(self.resident) >= self.capacity:
            while True:
                negnxt, k = heapq.heappop(self.heap)
                if k in self.resident and self.resident[k] == -negnxt:
                    del self.resident[k]
                    break
        self.resident[key] = nxt
        heapq.heappush(self.heap, (-nxt, key))
        return False

    def __contains__(self, key):
        return key in self.resident

    def __len__(self):
        return len(self.resident)

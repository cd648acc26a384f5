"""LIRS (Jiang & Zhang, SIGMETRICS'02) — low inter-reference recency set.

The port's own copy of ``repro/core/policies/lirs.py``.

Stack S holds LIR blocks plus recently-seen HIR blocks (resident or
ghost); queue Q holds resident HIR blocks.  L_hirs = 1% of capacity
(min 1).  The stack's non-resident (ghost) population is bounded at
2x capacity, as production implementations do.
"""

from __future__ import annotations

from collections import OrderedDict, deque

from repro_torch.core.policy import CachePolicy, register


@register("lirs")
class LIRS(CachePolicy):
    name = "lirs"

    def __init__(self, capacity: int, hirs_frac: float = 0.01, **kw):
        super().__init__(capacity, **kw)
        self.l_hirs = min(max(1, int(round(capacity * hirs_frac))),
                          max(1, capacity - 1))
        self.l_lirs = capacity - self.l_hirs
        self.stack = OrderedDict()   # key -> None (most recent at end)
        self.q = deque()             # resident HIR keys (front = oldest)
        self.is_lir = {}             # key -> bool (known keys)
        self.resident = set()
        self.ghost_cap = 2 * capacity
        self._n_lir = 0  # maintained incrementally (residents with LIR)

    # -- helpers ---------------------------------------------------------------
    def _stack_top(self, key):
        self.stack.pop(key, None)
        self.stack[key] = None

    def _prune(self):
        """Remove non-LIR entries from the stack bottom."""
        while self.stack:
            bottom = next(iter(self.stack))
            if self.is_lir.get(bottom, False):
                break
            del self.stack[bottom]
            if bottom not in self.resident:
                self.is_lir.pop(bottom, None)  # forget pruned ghosts

    def _bound_ghosts(self):
        """Amortized: only scan when the stack exceeds capacity+ghost_cap,
        and prune down with slack so scans happen every ~C/2 misses."""
        limit = self.capacity + self.ghost_cap
        if len(self.stack) <= limit:
            return
        target = limit - max(1, self.capacity // 2)  # hysteresis
        to_remove = []
        need = len(self.stack) - target
        for k in self.stack:  # oldest first
            if k not in self.resident and not self.is_lir.get(k):
                to_remove.append(k)
                if len(to_remove) >= need:
                    break
        for k in to_remove:
            del self.stack[k]
            self.is_lir.pop(k, None)

    def _demote_bottom_lir(self):
        """Bottom LIR -> resident HIR at the end of Q."""
        bottom = next(iter(self.stack))
        del self.stack[bottom]
        self.is_lir[bottom] = False
        self._n_lir -= 1
        self.q.append(bottom)
        self._prune()

    def _evict_hir(self):
        victim = self.q.popleft()
        self.resident.discard(victim)
        if victim not in self.stack:
            self.is_lir.pop(victim, None)
        self._event("evict_main", victim)

    @property
    def n_lir(self):
        return self._n_lir

    # -- access ------------------------------------------------------------------
    def access(self, key, dirty: bool = False) -> bool:
        if key in self.resident:
            if self.is_lir.get(key, False):
                was_bottom = next(iter(self.stack)) == key
                self._stack_top(key)
                if was_bottom:
                    self._prune()
            else:  # resident HIR
                if key in self.stack:
                    self.is_lir[key] = True
                    self._n_lir += 1
                    try:
                        self.q.remove(key)
                    except ValueError:
                        pass
                    self._stack_top(key)
                    self._demote_bottom_lir()
                else:
                    self._stack_top(key)
                    try:
                        self.q.remove(key)
                    except ValueError:
                        pass
                    self.q.append(key)
            return True

        # miss
        if len(self.resident) >= self.capacity:
            if self.q:
                self._evict_hir()
            else:  # degenerate: demote a LIR first
                self._demote_bottom_lir()
                self._evict_hir()
        if self.n_lir < self.l_lirs and key not in self.stack:
            # warmup: fill the LIR set directly
            self.is_lir[key] = True
            self._n_lir += 1
            self.resident.add(key)
            self._stack_top(key)
            return False
        if key in self.stack:  # ghost hit: straight to LIR
            self.is_lir[key] = True
            self._n_lir += 1
            self.resident.add(key)
            self._stack_top(key)
            self._demote_bottom_lir()
        else:  # cold block: resident HIR
            self.is_lir[key] = False
            self.resident.add(key)
            self._stack_top(key)
            self.q.append(key)
        self._bound_ghosts()
        return False

    def __contains__(self, key):
        return key in self.resident

    def __len__(self):
        return len(self.resident)

"""W-TinyLFU (Einziger et al., ToS'17): 1% LRU window + SLRU main with a

The port's own copy of ``repro/core/policies/tinylfu.py``.
Count-Min-Sketch admission filter (4 rows, 4-bit-style counters, periodic
halving after a sample of 10x capacity)."""

from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.policy import CachePolicy, register, seg_size

_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


class _CMSketch:
    def __init__(self, capacity: int):
        self.width = max(64, 1 << (4 * capacity - 1).bit_length())
        self.rows = [[0] * self.width for _ in range(4)]
        self.additions = 0
        self.sample = max(128, 10 * capacity)

    def _idx(self, key, row):
        h = (hash(key) * _PRIMES[row]) & 0xFFFFFFFF
        return (h ^ (h >> 16)) % self.width

    def add(self, key):
        for r in range(4):
            i = self._idx(key, r)
            if self.rows[r][i] < 15:
                self.rows[r][i] += 1
        self.additions += 1
        if self.additions >= self.sample:
            self._age()

    def estimate(self, key) -> int:
        return min(self.rows[r][self._idx(key, r)] for r in range(4))

    def _age(self):
        for r in range(4):
            row = self.rows[r]
            for i in range(self.width):
                row[i] >>= 1
        self.additions //= 2


@register("wtinylfu")
class WTinyLFU(CachePolicy):
    name = "wtinylfu"

    def __init__(self, capacity: int, window_frac: float = 0.01, **kw):
        super().__init__(capacity, **kw)
        self.win_cap = min(max(1, capacity - 1), seg_size(capacity, window_frac))
        main_cap = max(1, capacity - self.win_cap)
        self.prob_cap = max(1, main_cap - int(round(main_cap * 0.8)))
        self.prot_cap = main_cap - self.prob_cap
        self.window = OrderedDict()
        self.prob = OrderedDict()
        self.prot = OrderedDict()
        self.sketch = _CMSketch(capacity)

    def _main_insert(self, key):
        """Admit ``key`` into the probationary segment, evicting if needed."""
        if len(self.prob) + len(self.prot) >= self.prob_cap + self.prot_cap:
            victim = next(iter(self.prob)) if self.prob else next(iter(self.prot))
            if self.sketch.estimate(key) <= self.sketch.estimate(victim):
                return  # candidate rejected by the TinyLFU filter
            if self.prob:
                self.prob.popitem(last=False)
            else:
                self.prot.popitem(last=False)
        self.prob[key] = None

    def access(self, key, dirty: bool = False) -> bool:
        self.sketch.add(key)
        if key in self.window:
            self.window.move_to_end(key)
            return True
        if key in self.prot:
            self.prot.move_to_end(key)
            return True
        if key in self.prob:
            del self.prob[key]
            self.prot[key] = None
            while len(self.prot) > self.prot_cap:
                k, _ = self.prot.popitem(last=False)
                self.prob[k] = None
            return True
        # miss: new blocks enter the window
        self.window[key] = None
        if len(self.window) > self.win_cap:
            cand, _ = self.window.popitem(last=False)
            self._main_insert(cand)
        return False

    def __contains__(self, key):
        return key in self.window or key in self.prob or key in self.prot

    def __len__(self):
        return len(self.window) + len(self.prob) + len(self.prot)

"""ARC (Megiddo & Modha, FAST'03) — faithful to the published pseudocode.

The port's own copy of ``repro/core/policies/arc.py``.
"""

from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.policy import CachePolicy, register


@register("arc")
class ARC(CachePolicy):
    name = "arc"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self.p = 0.0
        self.t1 = OrderedDict()  # recency, MRU at end
        self.t2 = OrderedDict()  # frequency
        self.b1 = OrderedDict()  # ghost of t1
        self.b2 = OrderedDict()  # ghost of t2

    def _replace(self, in_b2: bool):
        if self.t1 and ((in_b2 and len(self.t1) == int(self.p)) or len(self.t1) > int(self.p)):
            k, _ = self.t1.popitem(last=False)
            self.b1[k] = None
        else:
            k, _ = self.t2.popitem(last=False)
            self.b2[k] = None

    def access(self, key, dirty: bool = False) -> bool:
        c = self.capacity
        if key in self.t1:
            del self.t1[key]
            self.t2[key] = None
            return True
        if key in self.t2:
            self.t2.move_to_end(key)
            return True
        if key in self.b1:
            self.p = min(float(c), self.p + max(len(self.b2) / max(1, len(self.b1)), 1.0))
            self._replace(False)
            del self.b1[key]
            self.t2[key] = None
            return False
        if key in self.b2:
            self.p = max(0.0, self.p - max(len(self.b1) / max(1, len(self.b2)), 1.0))
            self._replace(True)
            del self.b2[key]
            self.t2[key] = None
            return False
        # Case IV: brand-new
        l1 = len(self.t1) + len(self.b1)
        l2 = len(self.t2) + len(self.b2)
        if l1 == c:
            if len(self.t1) < c:
                self.b1.popitem(last=False)
                self._replace(False)
            else:
                self.t1.popitem(last=False)
        elif l1 < c and l1 + l2 >= c:
            if l1 + l2 == 2 * c:
                self.b2.popitem(last=False)
            self._replace(False)
        self.t1[key] = None
        return False

    def __contains__(self, key):
        return key in self.t1 or key in self.t2

    def __len__(self):
        return len(self.t1) + len(self.t2)

"""Clock2Q+ — the paper's contribution (§3.4, §4.1.3, §5.5).

The port's own copy of ``repro/core/policies/clock2qplus.py``.

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

Dirty-block handling (§4.1.3, toggled by ``dirty_mode``):
  * "off"        — dirty flags ignored (pure algorithm).
  * "simplified" — production behaviour: dirty blocks are skipped (cycled)
    when picking eviction candidates in the Small FIFO; after
    ``dirty_scan_limit`` dirty skips the new block bypasses straight into
    the Main Clock.  Dirty blocks are never moved Small->Main.
  * "accurate"   — like "simplified" but a dirty block with its Ref bit set
    IS moved to the Main Clock (the behaviour production skips; used as the
    Fig.-11 baseline).

Flushing (§4.1.3): time-based (``flush_after`` requests) + watermark
(``low_water``/``high_water`` fractions of capacity), both simulated in
request time.
"""

from __future__ import annotations

import collections
from collections import OrderedDict

from repro_torch.core.policy import CachePolicy, register, seg_size
from repro_torch.core.policies.two_q import _GhostFIFO, _MainClock


class _SmallEntry:
    __slots__ = ("key", "ref", "dirty", "seq")

    def __init__(self, key, seq):
        self.key = key
        self.ref = False
        self.dirty = False
        self.seq = seq


@register("clock2q+")
class Clock2QPlus(CachePolicy):
    name = "clock2q+"

    def __init__(self, capacity: int, small_frac: float = 0.1,
                 ghost_frac: float = 0.5, window_frac: float = 0.5,
                 skip_limit=None, dirty_mode: str = "off",
                 dirty_scan_limit: int = 16, flush_after: int = 0,
                 low_water: float = 0.1, high_water: float = 0.2,
                 adaptive: bool = False, **kw):
        super().__init__(capacity, **kw)
        if adaptive:
            # Beyond-paper (EXPERIMENTS.md §Perf, core-algorithm hillclimb):
            # the paper's 10%/50% sizing degenerates when the cache is
            # small (Small FIFO of 1-3 slots, window of 0-1 insertions —
            # §5.6 itself observes larger windows help small caches).
            # Floor the Small FIFO at min(8, 25% cap) and the window at
            # min(S, 4): identical to the paper's sizing for production
            # caches, 2Q-like filtering for tiny ones.
            small = max(int(round(0.1 * capacity)),
                        min(8, int(round(0.25 * capacity))))
            small_frac = small / capacity
        small_cap = min(capacity, seg_size(capacity, small_frac))
        self.small_cap = small_cap
        self.window = int(round(window_frac * small_cap))
        if adaptive:
            self.window = min(small_cap, max(self.window, 4))
        self.small = collections.deque()  # _SmallEntry, head = oldest
        self.in_small = {}
        self.ghost = _GhostFIFO(seg_size(capacity, ghost_frac))
        self.main = _MainClock(max(1, capacity - small_cap), skip_limit=skip_limit)
        self.small_seq = 0  # insertion counter for window aging
        assert dirty_mode in ("off", "simplified", "accurate")
        self.dirty_mode = dirty_mode
        self.dirty_scan_limit = dirty_scan_limit
        self.flush_after = flush_after
        self.low_water = low_water
        self.high_water = high_water
        self.dirty_since = OrderedDict()  # key -> request time first dirtied
        self.flows = collections.Counter()

    # -- dirty bookkeeping ---------------------------------------------------
    def _mark_dirty(self, key):
        if self.dirty_mode == "off":
            return
        if key not in self.dirty_since:
            self.dirty_since[key] = self.clock_time
        e = self.in_small.get(key)
        if e is not None:
            e.dirty = True
        else:
            self.main.set_dirty(key, True)

    def _clean(self, key):
        self.dirty_since.pop(key, None)
        e = self.in_small.get(key)
        if e is not None:
            e.dirty = False
        else:
            self.main.set_dirty(key, False)

    def _run_flushers(self):
        if self.dirty_mode == "off":
            return
        if self.flush_after:
            while self.dirty_since:
                key, t0 = next(iter(self.dirty_since.items()))
                if self.clock_time - t0 < self.flush_after:
                    break
                self._clean(key)
        high = self.high_water * self.capacity
        if len(self.dirty_since) > high:
            low = self.low_water * self.capacity
            while len(self.dirty_since) > low:
                key = next(iter(self.dirty_since))
                self._clean(key)

    # -- queue plumbing -------------------------------------------------------
    def _insert_main(self, key, dirty=False):
        if self.main.full():
            victim = self.main.evict()
            self._event("evict_main", victim)
        self.main.insert(key, dirty=dirty)

    def _evict_small(self) -> bool:
        """Free one Small-FIFO slot.  Returns False if every candidate within
        the dirty scan limit was dirty (caller should bypass to Main)."""
        dirty_skips = 0
        while True:
            e = self.small.popleft()
            if e.dirty:
                if self.dirty_mode == "accurate" and e.ref:
                    del self.in_small[e.key]
                    self._event("small_to_main", e.key)
                    self.flows["small_to_main"] += 1
                    self._insert_main(e.key, dirty=True)
                    return True
                # simplified (and accurate-without-ref): cycle it back
                self.small.append(e)
                dirty_skips += 1
                if dirty_skips >= min(self.dirty_scan_limit, len(self.small)):
                    return False
                continue
            del self.in_small[e.key]
            if e.ref:
                self._event("small_to_main", e.key)
                self.flows["small_to_main"] += 1
                self._insert_main(e.key)
            else:
                self._event("small_to_ghost", e.key)
                self.flows["small_to_ghost"] += 1
                self.ghost.push(e.key)
            return True

    # -- public ---------------------------------------------------------------
    def access(self, key, dirty: bool = False) -> bool:
        self._run_flushers()
        e = self.in_small.get(key)
        if e is not None:
            age = self.small_seq - e.seq
            if age >= self.window:
                e.ref = True
            if dirty:
                self._mark_dirty(key)
            return True
        if self.main.hit(key):
            if dirty:
                self._mark_dirty(key)
            return True
        if key in self.ghost:
            self.ghost.remove(key)
            self._event("ghost_to_main", key)
            self.flows["ghost_to_main"] += 1
            self._insert_main(key)
            if dirty:
                self._mark_dirty(key)
            return False
        # brand-new block
        if len(self.small) >= self.small_cap:
            if not self._evict_small():
                # §5.5.1: all scanned Small-FIFO candidates dirty -> bypass
                self.flows["small_bypass"] += 1
                self._insert_main(key)
                if dirty:
                    self._mark_dirty(key)
                return False
        e = _SmallEntry(key, self.small_seq)
        self.small_seq += 1
        self.small.append(e)
        self.in_small[key] = e
        if dirty:
            self._mark_dirty(key)
        return False

    def __contains__(self, key):
        return key in self.in_small or key in self.main

    def __len__(self):
        return len(self.in_small) + len(self.main)


@register("clock2q+a")
def _adaptive(capacity: int, **kw):
    """Clock2Q+A — adaptive small-FIFO/window floors (beyond-paper)."""
    kw.setdefault("adaptive", True)
    pol = Clock2QPlus(capacity, **kw)
    pol.name = "clock2q+a"
    return pol

"""Production-style Clock2Q+ (paper §4) — the array-based implementation.

The port's own copy of ``repro.core.prodcache`` (``ProdClock2QPlus``,
``AccessResult``, ``drive_resize``), with its imports pointed into
``repro_torch``.

Faithful to the vSAN engineering design, adapted from kernel C to a
host-side Python/NumPy runtime (this structure runs on the *host* CPU of a
GPU serving stack, where it allocates device KV blocks — see
repro_torch.kvcache):

  * No allocation after init: every queue is a contiguous array
    preallocated to its maximum (resizable) size (§4.1, §4.2.1 "reserved
    virtual address space").
  * Chained hash tables stored as arrays (bucket heads + per-entry next
    pointers), one for resident entries and one for the Ghost ring (§4.1).
  * "Always-full" queues with a single cursor for the Small FIFO / Ghost
    ring and a clock hand for the Main Clock (§4.1.1): eviction candidates
    are found by advancing the cursor; dirty/pinned entries are skipped in
    place (the paper's "equivalent to reinserting at the head"), with a
    bounded scan that falls back to the Main Clock (§4.1.3, §5.5.1).
  * Entries being filled are marked DOING-IO (§4.1.1); completion via
    ``io_done``.
  * Live resizing (§4.2): logical capacities move within the preallocated
    maxima; the hash table is rehashed *incrementally* (``resize_step``),
    lookups consult only the new bucket array, and the insertion path
    detects+migrates strays from the old one — the paper's protocol.

Semantics (hit/miss/eviction sequence) are identical to
``repro.core.policies.clock2qplus.Clock2QPlus`` with ``dirty_mode=
"simplified"`` when no pinning/resizing is used; a property test asserts
exact parity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.obs import (
    EV_EVICT, EV_GHOST_PROMOTE, EV_IO_WAIT, EV_RESIZE, EV_RETUNE,
    EV_WINDOW_ENTER, EV_WINDOW_EXIT, FLOW_KINDS,
)

# shared sentinel (repro.core.engine.layout is pure Python — importing it
# keeps this module JAX-free); re-exported here for the many callers that
# do `from repro.core.prodcache import EMPTY`
from repro_torch.core.engine.layout import EMPTY  # noqa: F401


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def drive_resize(policy, steps_per_call: int = 64) -> bool:
    """Drive a live resize (``ProdClock2QPlus`` or any policy exposing
    ``resize_step``/``rehash_pending``/``undrained_count``) until all
    *migratable* work is done.  Returns True when fully complete, False
    when only undrainable (pinned/DOING-IO) entries remain — it never
    spins on those: the unpin/io_done that would release them may be
    waiting on this very thread."""
    prev = None
    while not policy.resize_step(steps_per_call):
        if policy.rehash_pending():
            prev = None  # rehashing always progresses: never give up
            continue
        left = policy.undrained_count()
        if left == prev:  # full pass, zero drain progress
            return False
        prev = left
    return True


@dataclasses.dataclass
class AccessResult:
    """Outcome of one ``access``: hit, the key's payload slot, and the eviction (or bypass) it caused."""
    hit: bool
    block: int                 # payload handle for the key (>=0) or EMPTY
    evicted_key: int = EMPTY   # resident key whose payload was dropped
    evicted_block: int = EMPTY
    bypassed_to_main: bool = False
    io_pending: bool = False   # True when the caller must fill the block


class ProdClock2QPlus:
    """Array-based Clock2Q+ with pinning, dirty blocks, and live resizing."""

    # the registered lane engine that simulates this policy bit-for-bit
    # (consumed by the OnlineTuner and the MRC profiler)
    engine_policy = "clock2q+"

    def __init__(self, capacity: int, *, small_frac: float = 0.1,
                 ghost_frac: float = 0.5, window_frac: float = 0.5,
                 skip_limit=None, dirty_scan_limit: int = 16,
                 max_capacity: int = 0, track_io: bool = False,
                 max_small_frac: float = 0.0, max_ghost_frac: float = 0.0,
                 min_small_frac: float = 1.0, obs=None, shard_id: int = 0):
        self.track_io = track_io  # mark entries DOING-IO until io_done()
        self.max_capacity = max(capacity, max_capacity or capacity)
        self._small_frac = small_frac
        self._ghost_frac = ghost_frac
        self._window_frac = window_frac
        self.skip_limit = skip_limit
        self.dirty_scan_limit = dirty_scan_limit

        # Preallocation fractions: the small/ghost maxima cover fractions
        # up to max_small_frac, and the MAIN maximum covers fractions
        # down to min_small_frac (a smaller small queue means a larger
        # main), so ``retune`` can move the boundary either way at
        # runtime without the logical sizes clamping below capacity.
        ms = max(1, int(round(self.max_capacity
                              * max(small_frac, max_small_frac))))
        mm = max(1, self.max_capacity - max(1, int(round(
            self.max_capacity * min(small_frac, min_small_frac)))))
        mg = max(1, int(round(self.max_capacity
                              * max(ghost_frac, max_ghost_frac))))
        self.max_small, self.max_main, self.max_ghost = ms, mm, mg
        n_ent = ms + mm

        # entry arrays (small ids: [0, ms), main ids: [ms, ms+mm))
        self.key = np.full(n_ent, EMPTY, dtype=np.int64)
        self.ref = np.zeros(n_ent, dtype=bool)
        self.dirty = np.zeros(n_ent, dtype=bool)
        self.pin = np.zeros(n_ent, dtype=np.int32)
        self.io = np.zeros(n_ent, dtype=bool)
        self.block = np.full(n_ent, EMPTY, dtype=np.int64)
        self.seq = np.zeros(n_ent, dtype=np.int64)  # small insertion seq

        # resident hash: new + old bucket arrays for the resize protocol
        # (sized for the LOGICAL capacity; resize swaps in a new array)
        sc0 = max(1, min(ms, int(round(capacity * small_frac))))
        self.n_buckets = _next_pow2(2 * (sc0 + max(1, capacity - sc0)))
        self.buckets = np.full(self.n_buckets, EMPTY, dtype=np.int64)
        self.nxt = np.full(n_ent, EMPTY, dtype=np.int64)
        self.old_buckets: np.ndarray | None = None
        self.old_n_buckets = 0
        self._rehash_cursor = 0

        # ghost ring + its hash
        self.gkey = np.full(mg, EMPTY, dtype=np.int64)
        self.g_n_buckets = _next_pow2(2 * mg)
        self.gbuckets = np.full(self.g_n_buckets, EMPTY, dtype=np.int64)
        self.gnxt = np.full(mg, EMPTY, dtype=np.int64)
        self.gpos = 0

        # payload free list (stack)
        self.free_blocks = list(range(n_ent - 1, -1, -1))

        # observability (repro.obs): on by default, per-cache sink.  The
        # instruments below ARE the stats — ``hits``/``misses``/
        # ``io_waits``/``flows`` are thin views over them, so there is
        # exactly one schema to export and nothing to reconcile.  Hot
        # paths increment bound instruments directly (plain attribute /
        # array-cell adds); events fire on state transitions only.
        self.shard_id = int(shard_id)
        lbl = str(self.shard_id)
        if obs is None:
            obs = obs_mod.ObsSink(src=f"cache/shard{lbl}",
                                  labels={"shard": lbl})
        self.obs = obs
        self._ring = obs.ring
        self._c_hit_small = obs.counter(
            "cache_hits_total", ("shard", "queue"),
            "resident hits by queue").labels(lbl, "small")
        self._c_hit_main = obs.counter(
            "cache_hits_total", ("shard", "queue")).labels(lbl, "main")
        self._c_miss = obs.counter(
            "cache_misses_total", ("shard",), "misses (incl. ghost "
            "hits, which readmit to main)").labels(lbl)
        self._c_io_wait = obs.counter(
            "cache_io_waits_total", ("shard",),
            "hits on DOING-IO entries").labels(lbl)
        flow_fam = obs.counter("cache_flow_total", ("shard", "flow"),
                               "Clock2Q+ queue-transition counters")
        self._c_flow = {k: flow_fam.labels(lbl, k) for k in FLOW_KINDS}
        self._c_f_s2m = self._c_flow["small_to_main"]
        self._c_f_s2g = self._c_flow["small_to_ghost"]
        self._c_f_g2m = self._c_flow["ghost_to_main"]
        self._c_f_evict = self._c_flow["evict_main"]
        self._c_f_bypass = self._c_flow["small_bypass"]
        cap_fam = obs.gauge("cache_capacity", ("shard", "segment"),
                            "logical segment sizes (slots)")
        self._g_cap = {seg: cap_fam.labels(lbl, seg)
                       for seg in ("total", "small", "main", "ghost",
                                   "window")}
        self._g_resident = obs.gauge(
            "cache_resident_entries", ("shard",),
            "resident entries (set at snapshot time)").labels(lbl)
        obs.on_collect(self._obs_collect)

        # write-ahead delta journal hook (repro.faults.journal attaches
        # one via ShardJournal.attach; None keeps every hot path at a
        # single attribute test, same bargain as ``if ring.enabled``)
        self._journal = None
        self._in_retune = False  # retune() journals ONE record; its
        # internal begin_resize call must not add a second

        # cursors / logical sizes
        self.spos = 0
        self.hand = 0
        self.small_seq = 0
        self.set_capacity(capacity)

    def _obs_collect(self) -> None:
        self._g_resident.set(float(len(self)))

    # -- stats (views over the obs counter families) --------------------------
    @property
    def hits(self) -> int:
        """Accesses that hit (the obs counter's value)."""
        return self._c_hit_small.value + self._c_hit_main.value

    @property
    def misses(self) -> int:
        """Accesses that missed (the obs counter's value)."""
        return self._c_miss.value

    @property
    def io_waits(self) -> int:
        """Hits on entries still DOING-IO (the obs counter's value)."""
        return self._c_io_wait.value

    @property
    def flows(self) -> dict:
        """Queue-transition counters, derived from the
        ``cache_flow_total`` family in canonical ``obs.FLOW_KINDS``
        order (same keys as always — the sharded aggregate derives from
        the identical schema, so the key sets cannot drift)."""
        return {k: self._c_flow[k].value for k in FLOW_KINDS}

    # -- sizing ---------------------------------------------------------------
    def set_capacity(self, capacity: int) -> None:
        """Set the logical capacity (grow or shrink target). Shrinking may
        leave entries beyond the boundary; drain with ``resize_step``."""
        if not (1 <= capacity <= self.max_capacity):
            raise ValueError(f"capacity {capacity} not in [1, {self.max_capacity}]")
        self.capacity = capacity
        sc = max(1, min(self.max_small, int(round(capacity * self._small_frac))))
        self.small_cap = sc
        self.main_cap = max(1, min(self.max_main, capacity - sc))
        self.ghost_cap = max(1, min(self.max_ghost,
                                    int(round(capacity * self._ghost_frac))))
        self.window = int(round(self._window_frac * sc))
        self.spos %= self.small_cap
        self.hand %= self.main_cap
        if self.gpos >= self.ghost_cap:
            self.gpos = 0
        # purge ghost entries stranded beyond a shrunken ring: the cursor
        # never revisits those slots, so without this they would stay
        # hash-reachable forever (unbounded-age ghost hits)
        tail = self.gkey[self.ghost_cap:]
        if tail.size:
            for off in np.nonzero(tail != EMPTY)[0].tolist():
                self._ghost_remove_slot(self.ghost_cap + off)
        g = self._g_cap
        g["total"].value = float(capacity)
        g["small"].value = float(self.small_cap)
        g["main"].value = float(self.main_cap)
        g["ghost"].value = float(self.ghost_cap)
        g["window"].value = float(self.window)

    @property
    def tuning(self) -> dict:
        """Current tuning knobs (what ``retune`` retargets)."""
        return dict(small_frac=self._small_frac, ghost_frac=self._ghost_frac,
                    window_frac=self._window_frac)

    def retune(self, *, small_frac: float | None = None,
               ghost_frac: float | None = None,
               window_frac: float | None = None) -> None:
        """Runtime tuning setter (the OnlineTuner hook): retarget the
        correlation window and/or the small/ghost fractions of a LIVE
        cache.  The window change is immediate; segment boundaries move
        via the live-resize protocol — ``begin_resize`` at the current
        capacity recomputes them (``set_capacity`` clamps to the
        preallocated maxima, so payload handles never move) and entries
        stranded beyond a shrunken boundary drain through ``resize_step``
        exactly as a capacity resize would."""
        # validate everything BEFORE assigning anything: a rejected call
        # must not leave half-applied fractions for a later resize to
        # silently activate
        if small_frac is not None and not (0.0 < small_frac <= 1.0):
            raise ValueError(f"small_frac {small_frac} not in (0, 1]")
        if ghost_frac is not None and ghost_frac < 0.0:
            raise ValueError(f"ghost_frac {ghost_frac} < 0")
        if window_frac is not None and window_frac < 0.0:
            raise ValueError(f"window_frac {window_frac} < 0")
        if small_frac is not None:
            self._small_frac = small_frac
        if ghost_frac is not None:
            self._ghost_frac = ghost_frac
        if window_frac is not None:
            self._window_frac = window_frac
        old_window = self.window
        jr = self._journal
        if jr is not None:
            # journal the retune as ONE record of absolute post-values;
            # the embedded begin_resize is its deterministic consequence
            jr.on_retune(self._small_frac, self._ghost_frac,
                         self._window_frac)
        self._in_retune = True
        try:
            self.begin_resize(self.capacity)
        finally:
            self._in_retune = False
        if self._ring.enabled:
            self._ring.emit(EV_RETUNE, self.shard_id, a=old_window,
                            b=self.window)

    # -- hashing ---------------------------------------------------------------
    def _h(self, key: int, n_buckets: int) -> int:
        x = (key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        return (x >> 17) % n_buckets

    def _hash_insert(self, eid: int) -> None:
        b = self._h(int(self.key[eid]), self.n_buckets)
        self.nxt[eid] = self.buckets[b]
        self.buckets[b] = eid

    def _hash_remove(self, eid: int) -> None:
        key = int(self.key[eid])
        for buckets, nb in ((self.buckets, self.n_buckets),
                            (self.old_buckets, self.old_n_buckets)):
            if buckets is None:
                continue
            b = self._h(key, nb)
            cur = int(buckets[b])
            prev = EMPTY
            while cur != EMPTY:
                if cur == eid:
                    if prev == EMPTY:
                        buckets[b] = self.nxt[cur]
                    else:
                        self.nxt[prev] = self.nxt[cur]
                    self.nxt[cur] = EMPTY
                    return
                prev, cur = cur, int(self.nxt[cur])

    def _hash_lookup(self, key: int) -> int:
        """Search the NEW bucket array only (paper §4.2.1)."""
        cur = int(self.buckets[self._h(key, self.n_buckets)])
        while cur != EMPTY:
            if int(self.key[cur]) == key:
                return cur
            cur = int(self.nxt[cur])
        return EMPTY

    def _find_stray(self, key: int) -> int:
        """Insertion-path check of the OLD bucket array; migrate on hit."""
        if self.old_buckets is None:
            return EMPTY
        b = self._h(key, self.old_n_buckets)
        cur = int(self.old_buckets[b])
        prev = EMPTY
        while cur != EMPTY:
            if int(self.key[cur]) == key:
                if prev == EMPTY:
                    self.old_buckets[b] = self.nxt[cur]
                else:
                    self.nxt[prev] = self.nxt[cur]
                self.nxt[cur] = EMPTY
                self._hash_insert(cur)
                return cur
            prev, cur = cur, int(self.nxt[cur])
        return EMPTY

    # -- ghost ring -------------------------------------------------------------
    def _ghash(self, key: int) -> int:
        return self._h(key, self.g_n_buckets)

    def _ghost_lookup(self, key: int) -> int:
        cur = int(self.gbuckets[self._ghash(key)])
        while cur != EMPTY:
            if int(self.gkey[cur]) == key:
                return cur
            cur = int(self.gnxt[cur])
        return EMPTY

    def _ghost_remove_slot(self, slot: int) -> None:
        key = int(self.gkey[slot])
        b = self._ghash(key)
        cur = int(self.gbuckets[b])
        prev = EMPTY
        while cur != EMPTY:
            if cur == slot:
                if prev == EMPTY:
                    self.gbuckets[b] = self.gnxt[cur]
                else:
                    self.gnxt[prev] = self.gnxt[cur]
                break
            prev, cur = cur, int(self.gnxt[cur])
        self.gkey[slot] = EMPTY
        self.gnxt[slot] = EMPTY

    def _ghost_push(self, key: int) -> None:
        slot = self.gpos
        if int(self.gkey[slot]) != EMPTY:
            self._ghost_remove_slot(slot)
        self.gkey[slot] = key
        b = self._ghash(key)
        self.gnxt[slot] = self.gbuckets[b]
        self.gbuckets[b] = slot
        self.gpos = (self.gpos + 1) % self.ghost_cap

    # -- eviction ----------------------------------------------------------------
    def _evict_main_slot(self) -> int:
        """Advance the clock hand to a victim main slot; frees it. Returns
        the local main slot index."""
        skips = 0
        scanned_dirty = 0
        forced = False
        while True:
            s = self.hand
            self.hand = (self.hand + 1) % self.main_cap
            eid = self.max_small + s
            if int(self.key[eid]) == EMPTY:
                return s  # pre-warm / invalid slot: free for the taking
            if self.pin[eid] or self.io[eid]:
                continue
            if self.dirty[eid]:
                scanned_dirty += 1
                if scanned_dirty > self.dirty_scan_limit:
                    self.dirty[eid] = False  # synchronous flush fallback
                continue
            if self.ref[eid] and not forced:
                self.ref[eid] = False
                skips += 1
                if self.skip_limit is not None and skips >= self.skip_limit:
                    forced = True
                continue
            # victim
            self._hash_remove(eid)
            self._c_f_evict.value += 1
            self._last_evicted = (int(self.key[eid]), int(self.block[eid]))
            if self._ring.enabled:
                self._ring.emit(EV_EVICT, self.shard_id,
                                a=self._last_evicted[0], b=1)
            self.free_blocks.append(int(self.block[eid]))
            self.key[eid] = EMPTY
            self.block[eid] = EMPTY
            self.ref[eid] = False
            return s

    def _insert_main(self, key: int, block: int | None, dirty: bool,
                     io: bool) -> int:
        """Insert into the Main Clock; ``block=None`` allocates a payload
        handle AFTER the eviction has freed one."""
        s = self._evict_main_slot()
        if block is None:
            block = self.free_blocks.pop()
        eid = self.max_small + s
        self.key[eid] = key
        self.block[eid] = block
        self.ref[eid] = False
        self.dirty[eid] = dirty
        self.io[eid] = io
        self.pin[eid] = 0
        self._hash_insert(eid)
        return eid

    def _evict_small_slot(self):
        """Advance the small cursor to a free slot, promoting/demoting the
        displaced entries.  Returns slot or -1 (all-dirty bypass, §5.5.1)."""
        scanned = 0
        while True:
            s = self.spos
            self.spos = (self.spos + 1) % self.small_cap
            if int(self.key[s]) == EMPTY:
                return s
            if self.pin[s] or self.io[s] or self.dirty[s]:
                scanned += 1  # skipped in place == reinsert at head (§4.1.3)
                if scanned >= min(self.dirty_scan_limit, self.small_cap):
                    return -1
                continue
            key, block = int(self.key[s]), int(self.block[s])
            self._hash_remove(s)
            self.key[s] = EMPTY
            if self.ref[s]:
                self._c_f_s2m.value += 1
                self._insert_main(key, block, dirty=False, io=False)
            else:
                self._c_f_s2g.value += 1
                if self._ring.enabled:
                    self._ring.emit(EV_EVICT, self.shard_id, a=key, b=0)
                self._ghost_push(key)
                self.free_blocks.append(block)
                self._last_evicted = (key, block)
            self.ref[s] = False
            return s

    # -- public ------------------------------------------------------------------
    def access(self, key: int, dirty: bool = False, pin: bool = False) -> AccessResult:
        """Look up ``key``; on miss, admit it (Clock2Q+ placement) and return
        a payload handle the caller must fill (``io_pending=True``)."""
        self._last_evicted = (EMPTY, EMPTY)
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)  # resize protocol: check old location
        if eid != EMPTY:
            if eid < self.max_small:  # small FIFO hit: correlation window
                self._c_hit_small.value += 1
                age = self.small_seq - int(self.seq[eid])
                if age >= self.window and not self.ref[eid]:
                    # the entry leaves its correlation window: this first
                    # qualifying re-reference is a state transition (the
                    # ref bit flips), so it may emit — later hits don't
                    if self._ring.enabled:
                        self._ring.emit(EV_WINDOW_EXIT, self.shard_id,
                                        a=key, b=age)
                    self.ref[eid] = True
            else:
                self._c_hit_main.value += 1
                self.ref[eid] = True
            if dirty:
                self.dirty[eid] = True
            if pin:
                self.pin[eid] += 1
            if self.io[eid]:
                self._c_io_wait.value += 1
                if self._ring.enabled:
                    self._ring.emit(EV_IO_WAIT, self.shard_id, a=key)
            res = AccessResult(True, int(self.block[eid]),
                               io_pending=bool(self.io[eid]))
            jr = self._journal
            if jr is not None:
                jr.on_access(key, dirty, pin, res)
            return res

        self._c_miss.value += 1
        gslot = self._ghost_lookup(key)
        bypass = False
        if gslot != EMPTY:
            self._ghost_remove_slot(gslot)
            self._c_f_g2m.value += 1
            if self._ring.enabled:
                self._ring.emit(EV_GHOST_PROMOTE, self.shard_id, a=key)
            eid = self._insert_main(key, None, dirty=dirty, io=self.track_io)
            block = int(self.block[eid])
        else:
            s = self._evict_small_slot()
            if s < 0:
                self._c_f_bypass.value += 1
                bypass = True
                eid = self._insert_main(key, None, dirty=dirty, io=self.track_io)
                block = int(self.block[eid])
            else:
                block = self.free_blocks.pop()
                eid = s
                self.key[s] = key
                self.block[s] = block
                self.ref[s] = False
                self.dirty[s] = dirty
                self.io[s] = self.track_io
                self.pin[s] = 0
                self.seq[s] = self.small_seq
                self.small_seq += 1
                self._hash_insert(s)
                if self._ring.enabled:  # correlation window opens
                    self._ring.emit(EV_WINDOW_ENTER, self.shard_id, a=key)
        if pin:
            self.pin[eid] += 1
        ek, eb = self._last_evicted
        res = AccessResult(False, block, evicted_key=ek, evicted_block=eb,
                           bypassed_to_main=bypass, io_pending=True)
        jr = self._journal
        if jr is not None:
            jr.on_access(key, dirty, pin, res)
        return res

    def io_done(self, key: int) -> None:
        """Mark the fill of ``key``'s payload complete (clears DOING-IO)."""
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)
        if eid != EMPTY:
            self.io[eid] = False
        jr = self._journal
        if jr is not None:
            jr.on_io_done(key)

    def unpin(self, key: int) -> None:
        """Drop one pin of ``key``; an unpinned entry is evictable again."""
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)
        if eid != EMPTY and self.pin[eid] > 0:
            self.pin[eid] -= 1
        jr = self._journal
        if jr is not None:
            jr.on_unpin(key)

    def clean(self, key: int) -> None:
        """Mark a dirty block flushed (host copy completed)."""
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)
        if eid != EMPTY:
            self.dirty[eid] = False
        jr = self._journal
        if jr is not None:
            jr.on_clean(key)

    def set_dirty(self, key: int) -> None:
        """Mark resident block dirty without touching replacement state."""
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)
        if eid != EMPTY:
            self.dirty[eid] = True
        jr = self._journal
        if jr is not None:
            jr.on_set_dirty(key)

    def contains(self, key: int) -> bool:
        """True if ``key`` is resident (no replacement-state update)."""
        return self._hash_lookup(key) != EMPTY or self._find_stray(key) != EMPTY

    def slot_of(self, key: int) -> int:
        """Payload slot of a resident key (no replacement-state update), or
        EMPTY if absent."""
        eid = self._hash_lookup(key)
        if eid == EMPTY:
            eid = self._find_stray(key)
        return EMPTY if eid == EMPTY else int(self.block[eid])

    def replay(self, source, chunk_size: int = 1 << 20) -> int:
        """Replay a request stream (ndarray, ``repro_torch.traceio.
        TraceStore``, or any iterable of key chunks) through ``access``;
        returns the hit count (``hits``/``misses`` counters advance as
        usual).  The cache is stateful, so chunked streaming is
        state-carry by construction: any chunk_size is bit-identical to
        replaying the whole trace in one call, with peak memory bounded
        by the chunk."""
        from repro_torch.traceio.store import iter_chunks

        acc = self.access
        hits = 0
        for chunk in iter_chunks(source, chunk_size):
            for k in np.asarray(chunk).tolist():
                hits += acc(k).hit
        return hits

    @property
    def n_slots(self) -> int:
        """Size of the payload-handle space (preallocated entry count)."""
        return int(self.key.shape[0])

    def __len__(self) -> int:
        """Resident entries."""
        return int(np.sum(self.key != EMPTY))

    def dirty_keys(self):
        """Resident keys whose payload is dirty (device-only)."""
        mask = (self.key != EMPTY) & self.dirty
        return [int(k) for k in self.key[mask]]

    def resident_keys(self):
        """Resident keys, coldest first: Main Clock entries in hand order
        (the slot under the hand is the next eviction candidate), then
        Small FIFO entries by insertion sequence.  This is the admission
        order a failover rewarm replays so the rebuilt shard evicts in
        the same relative order the lost one would have
        (``repro.faults.recovery``)."""
        out = []
        ms = self.max_small
        for i in range(self.main_cap):
            eid = ms + (self.hand + i) % self.main_cap
            if int(self.key[eid]) != EMPTY:
                out.append(int(self.key[eid]))
        # out-of-bounds main entries (mid-resize strays), slot order
        for eid in range(ms + self.main_cap, ms + self.max_main):
            if int(self.key[eid]) != EMPTY:
                out.append(int(self.key[eid]))
        smalls = [(int(self.seq[s]), int(self.key[s]))
                  for s in range(ms) if int(self.key[s]) != EMPTY]
        out.extend(k for _, k in sorted(smalls))
        return out

    def ghost_keys(self):
        """Ghost-ring keys, oldest first (``gpos`` is the next overwrite
        slot, i.e. the oldest surviving ghost)."""
        out = []
        for i in range(self.ghost_cap):
            slot = (self.gpos + i) % self.ghost_cap
            if int(self.gkey[slot]) != EMPTY:
                out.append(int(self.gkey[slot]))
        return out

    # -- live resizing (§4.2) -----------------------------------------------------
    def rehash_pending(self) -> bool:
        """True while the incremental hash migration has work left (it can
        always progress — never blocked by pins/dirty/DOING-IO)."""
        return self.old_buckets is not None

    def undrained_count(self) -> int:
        """Resident entries beyond the logical boundaries (only pinned or
        DOING-IO ones can persist across resize_step calls)."""
        n = int((self.key[self.small_cap:self.max_small] != EMPTY).sum())
        n += int((self.key[self.max_small + self.main_cap:] != EMPTY).sum())
        return n

    def finish_rehash(self, n_entries: int = 256) -> None:
        """Drive the incremental hash migration (ONLY — never the
        out-of-bounds drain, whose boundaries may be about to change) to
        completion.  Unlike the drain, rehashing is pure pointer work and
        can never be blocked by pinned/dirty/DOING-IO entries, so this
        always terminates.  Required before a new ``begin_resize`` may
        retire the old bucket array."""
        while not self._rehash_step(n_entries):
            pass

    def begin_resize(self, new_capacity: int) -> None:
        """Start a live resize: swap in a right-sized bucket array and let
        ``resize_step`` migrate entries in the background.  If a previous
        resize's hash migration is still pending it is completed first
        (two old bucket arrays cannot coexist)."""
        jr = self._journal
        if jr is not None and not self._in_retune:
            jr.on_resize(new_capacity)
        self.finish_rehash()
        if self._ring.enabled:
            self._ring.emit(EV_RESIZE, self.shard_id, a=self.capacity,
                            b=new_capacity)
        self.set_capacity(new_capacity)
        n_new = _next_pow2(2 * (self.small_cap + self.main_cap))
        if n_new != self.n_buckets:
            self.old_buckets = self.buckets
            self.old_n_buckets = self.n_buckets
            self.buckets = np.full(n_new, EMPTY, dtype=np.int64)
            self.n_buckets = n_new
            self._rehash_cursor = 0

    def _rehash_step(self, n_entries: int) -> bool:
        """Migrate up to ``n_entries`` from the old hash location; True
        when the old bucket array is fully retired."""
        if self.old_buckets is None:
            return True
        moved = 0
        while self._rehash_cursor < self.old_n_buckets and moved < n_entries:
            b = self._rehash_cursor
            cur = int(self.old_buckets[b])
            while cur != EMPTY and moved < n_entries:
                nxt = int(self.nxt[cur])
                self.old_buckets[b] = nxt
                self._hash_insert(cur)
                cur = nxt
                moved += 1
            if cur == EMPTY:
                self._rehash_cursor += 1
        if self._rehash_cursor >= self.old_n_buckets:
            self.old_buckets = None
            self.old_n_buckets = 0
            return True
        return False

    def resize_step(self, n_entries: int = 64) -> bool:
        """Background-thread analogue: migrate up to ``n_entries`` from the
        old hash location and drain out-of-bounds slots.  Returns True when
        the resize is complete."""
        jr = self._journal
        if jr is not None:
            jr.on_resize_step(n_entries)
        done_hash = self._rehash_step(n_entries)
        done_drain = self._drain_out_of_bounds(n_entries)
        return done_hash and done_drain

    def _drain_out_of_bounds(self, budget: int) -> bool:
        """Evict entries living beyond the shrunken logical capacities.
        Dirty blocks are flushed (cleaned) first, as §4.2.2 prescribes."""
        done = True
        for eid in range(self.small_cap, self.max_small):
            if budget <= 0:
                return False
            if int(self.key[eid]) != EMPTY:
                if self.pin[eid] or self.io[eid]:
                    done = False
                    continue
                if self.dirty[eid]:
                    self.dirty[eid] = False  # trigger transaction flush
                key, block = int(self.key[eid]), int(self.block[eid])
                self._hash_remove(eid)
                self._ghost_push(key)
                self.free_blocks.append(block)
                self.key[eid] = EMPTY
                budget -= 1
        for s in range(self.main_cap, self.max_main):
            eid = self.max_small + s
            if budget <= 0:
                return False
            if int(self.key[eid]) != EMPTY:
                if self.pin[eid] or self.io[eid]:
                    done = False
                    continue
                if self.dirty[eid]:
                    self.dirty[eid] = False
                self._hash_remove(eid)
                self.free_blocks.append(int(self.block[eid]))
                self.key[eid] = EMPTY
                budget -= 1
        return done

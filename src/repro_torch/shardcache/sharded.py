"""``ShardedClock2QPlus`` — N hash-partitioned ``ProdClock2QPlus`` shards
behind one facade (the port's own copy of ``repro/shardcache/sharded.py``).

Concurrency model (the paper's multi-CPU story, §4/§5, adapted to a host
runtime): each shard owns its arrays and a lock; independent keys land on
independent shards, so threads contend only when they collide on a shard.
``access_many`` additionally amortizes dispatch: one vectorized hash
partition and one lock acquisition per shard per batch.

Capacity is elastic *across* shards: ``rebalance``/``set_shard_capacities``
move logical capacity from cold shards to hot ones using each shard's live
resize protocol (``begin_resize``/``resize_step``, §4.2) — no
stop-the-world rebuild, lookups stay correct mid-migration.

Payload handles are globalized as ``shard_idx * stride + local_block`` so
callers (e.g. ``repro_torch.kvcache.pool.BlockPool``) can back all shards with
one flat block array.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core.prodcache import (
    EMPTY, AccessResult, ProdClock2QPlus, drive_resize,
)
from repro_torch.obs import EV_REBALANCE, EV_RESIZE_DONE, FLOW_KINDS
from repro_torch.shardcache.hashing import shard_of, shard_of_np

MIN_SHARD_CAP = 2


def apportion(weights: Sequence[float], total: int, lo: int, hi: int) -> List[int]:
    """Largest-remainder apportionment of ``total`` capacity over shards
    proportionally to ``weights``, with every share clamped to [lo, hi].
    Always returns shares summing exactly to ``total``.
    """
    n = len(weights)
    if total < n * lo or total > n * hi:
        raise ValueError(f"total {total} not representable with {n} shards "
                         f"in [{lo}, {hi}]")
    wsum = float(sum(weights)) or 1.0
    raw = [total * w / wsum for w in weights]
    shares = [min(hi, max(lo, int(math.floor(r)))) for r in raw]
    # distribute the remainder by largest fractional part, then fix any
    # clamp-induced imbalance greedily
    order = sorted(range(n), key=lambda i: raw[i] - math.floor(raw[i]),
                   reverse=True)
    deficit = total - sum(shares)
    i = 0
    while deficit != 0:
        s = order[i % n]
        if deficit > 0 and shares[s] < hi:
            shares[s] += 1
            deficit -= 1
        elif deficit < 0 and shares[s] > lo:
            shares[s] -= 1
            deficit += 1
        i += 1
        if i > 4 * n * (hi - lo + 1):  # bounds guarantee termination above
            raise RuntimeError("apportion failed to converge")
    return shares


class ShardedClock2QPlus:
    """Hash-sharded Clock2Q+ cache service (thread-safe facade)."""

    # the registered lane engine that simulates each shard (OnlineTuner)
    engine_policy = "clock2q+"

    def __init__(self, capacity: int, n_shards: int = 4, *,
                 small_frac: float = 0.1, ghost_frac: float = 0.5,
                 window_frac: float = 0.5, skip_limit=None,
                 dirty_scan_limit: int = 16, max_capacity: int = 0,
                 track_io: bool = False, rebalance_headroom: float = 2.0,
                 max_small_frac: float = 0.0, max_ghost_frac: float = 0.0,
                 min_small_frac: float = 1.0, obs=None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if capacity < n_shards * MIN_SHARD_CAP:
            raise ValueError(
                f"capacity {capacity} too small for {n_shards} shards "
                f"(need >= {n_shards * MIN_SHARD_CAP})")
        self.n_shards = n_shards
        self.capacity = capacity
        total_max = max(capacity, max_capacity or capacity)
        self.max_capacity = total_max
        # Uniform per-shard preallocation (=> uniform block stride) with
        # headroom so a hot shard can grow past its even share.
        share = -(-total_max // n_shards)  # ceil
        self.shard_max = max(MIN_SHARD_CAP + 1,
                             int(math.ceil(share * rebalance_headroom)))
        caps = apportion([1.0] * n_shards, capacity,
                         MIN_SHARD_CAP, self.shard_max)
        # facade-level sink: cross-shard events (rebalance decisions,
        # migration completions).  Each shard builds its OWN sink (lock-
        # free within the shard lock) labeled shard=i; obs_snapshot()
        # merges them all.  Passing obs=NullSink() nulls the facade AND
        # every shard.
        self.obs = obs_mod.ObsSink(src="shardcache") if obs is None else obs
        mk_shard_obs = (obs_mod.NullSink if getattr(self.obs, "null", False)
                        else obs_mod.ObsSink)
        self.shards: List[ProdClock2QPlus] = [
            ProdClock2QPlus(c, small_frac=small_frac, ghost_frac=ghost_frac,
                            window_frac=window_frac, skip_limit=skip_limit,
                            dirty_scan_limit=dirty_scan_limit,
                            max_capacity=self.shard_max, track_io=track_io,
                            max_small_frac=max_small_frac,
                            max_ghost_frac=max_ghost_frac,
                            min_small_frac=min_small_frac, shard_id=i,
                            obs=mk_shard_obs(src=f"cache/shard{i}",
                                             labels={"shard": str(i)}))
            for i, c in enumerate(caps)]
        self.locks = [threading.Lock() for _ in range(n_shards)]
        self.stride = self.shards[0].max_small + self.shards[0].max_main
        self._resizing: set[int] = set()
        self._resize_lock = threading.Lock()  # guards _resizing itself
        # serializes capacity retargeting end-to-end: concurrent
        # rebalance()/set_shard_capacities() would otherwise interleave
        # per-shard begin_resize calls and leave targets that overcommit
        # the total budget (RLock: rebalance -> set_shard_capacities)
        self._mutate_lock = threading.RLock()
        self._miss_mark = [0] * n_shards  # miss counts at last rebalance

    # -- routing -----------------------------------------------------------------
    def shard_of(self, key: int) -> int:
        return shard_of(key, self.n_shards)

    def _globalize(self, sid: int, r: AccessResult) -> AccessResult:
        base = sid * self.stride
        if r.block != EMPTY:
            r.block += base
        if r.evicted_block != EMPTY:
            r.evicted_block += base
        return r

    # -- access ------------------------------------------------------------------
    def access(self, key: int, dirty: bool = False,
               pin: bool = False) -> AccessResult:
        sid = shard_of(key, self.n_shards)
        with self.locks[sid]:
            return self._globalize(sid, self.shards[sid].access(
                key, dirty=dirty, pin=pin))

    def access_many(self, keys, dirty: bool = False) -> np.ndarray:
        """Batched access: partition ``keys`` by shard (vectorized), then
        replay each shard's group under one lock acquisition.  Returns a
        bool hit array aligned with the input order.

        Within a shard the input order is preserved; *across* shards the
        interleaving is relaxed to per-shard runs — the Multi-step-LRU
        trade (PAPERS.md): per-access global ordering for dispatch
        throughput.  Keys on different shards never interact, so the only
        semantic delta vs. serial replay is the timestamp skew between
        shards inside one batch.

        Batched replay returns no payload handles, so on a ``track_io``
        cache the fill obligation of each miss is completed inline —
        otherwise the entries this batch admits would stay DOING-IO
        forever (unevictable) with no caller able to ``io_done`` them.
        In-flight entries admitted by ``access()`` callers are untouched.
        """
        keys = np.asarray(keys, dtype=np.int64)
        hits = np.zeros(keys.shape[0], dtype=bool)
        if keys.size == 0:
            return hits
        sid = shard_of_np(keys, self.n_shards)
        for s in range(self.n_shards):
            idx = np.nonzero(sid == s)[0]
            if idx.size == 0:
                continue
            shard = self.shards[s]
            group = keys[idx].tolist()
            with self.locks[s]:
                acc = shard.access
                track_io = shard.track_io
                for j, k in zip(idx.tolist(), group):
                    hit = acc(k, dirty=dirty).hit
                    hits[j] = hit
                    if track_io and not hit:
                        shard.io_done(k)
        return hits

    # -- per-key maintenance ops (routed) -----------------------------------------
    def _routed(self, key: int):
        sid = shard_of(key, self.n_shards)
        return sid, self.shards[sid], self.locks[sid]

    def io_done(self, key: int) -> None:
        _, sh, lk = self._routed(key)
        with lk:
            sh.io_done(key)

    def unpin(self, key: int) -> None:
        _, sh, lk = self._routed(key)
        with lk:
            sh.unpin(key)

    def clean(self, key: int) -> None:
        _, sh, lk = self._routed(key)
        with lk:
            sh.clean(key)

    def set_dirty(self, key: int) -> None:
        _, sh, lk = self._routed(key)
        with lk:
            sh.set_dirty(key)

    def contains(self, key: int) -> bool:
        _, sh, lk = self._routed(key)
        with lk:
            return sh.contains(key)

    def slot_of(self, key: int) -> int:
        """Global payload slot of a resident key, or EMPTY."""
        sid, sh, lk = self._routed(key)
        with lk:
            local = sh.slot_of(key)
        return EMPTY if local == EMPTY else sid * self.stride + local

    # -- aggregated views ----------------------------------------------------------
    @property
    def n_slots(self) -> int:
        """Size of the global payload-handle space."""
        return self.n_shards * self.stride

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self.shards)

    @property
    def misses(self) -> int:
        return sum(s.misses for s in self.shards)

    @property
    def io_waits(self) -> int:
        return sum(s.io_waits for s in self.shards)

    @property
    def flows(self) -> Dict[str, int]:
        """Aggregate queue-transition counters.  Derived from the same
        ``cache_flow_total`` obs family and canonical ``obs.FLOW_KINDS``
        order as each shard's ``flows`` — the aggregate and single-shard
        key sets are the same schema by construction."""
        agg = {k: 0 for k in FLOW_KINDS}
        for s in self.shards:
            for k, c in s._c_flow.items():
                agg[k] += c.value
        return agg

    def obs_snapshot(self) -> "obs_mod.Snapshot":
        """Point-in-time merged telemetry: every shard's counters/
        gauges/histograms under its ``shard`` label plus the facade's
        rebalance/resize events."""
        return obs_mod.merge([self.obs.snapshot()]
                             + [s.obs.snapshot() for s in self.shards])

    @property
    def hit_ratio(self) -> float:
        h, m = self.hits, self.misses
        return h / max(1, h + m)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def __contains__(self, key: int) -> bool:
        return self.contains(key)

    def dirty_keys(self) -> List[int]:
        out: List[int] = []
        for s, lk in zip(self.shards, self.locks):
            with lk:
                out.extend(s.dirty_keys())
        return out

    @property
    def shard_capacities(self) -> List[int]:
        return [s.capacity for s in self.shards]

    def shard_stats(self) -> List[Dict[str, int]]:
        """Per-shard occupancy/traffic snapshot (for rebalancing + benches)."""
        return [dict(shard=i, capacity=s.capacity, resident=len(s),
                     hits=s.hits, misses=s.misses)
                for i, s in enumerate(self.shards)]

    # -- shard failover (repro_torch.faults.recovery) --------------------------------
    def lose_shard(self, sid: int) -> "ProdClock2QPlus":
        """Simulate crash-loss of shard ``sid``: its entire state (resident
        entries, ghost ring, counters, pending resize) vanishes and a fresh
        empty shard with IDENTICAL preallocation takes its place, so every
        global payload handle keeps meaning ``sid * stride + local``.

        The replacement inherits the lost shard's logical capacity and
        current tuning fractions, its rebalance miss mark is zeroed (its
        counters restart from zero — a stale mark would make the next
        miss-delta negative), and any in-flight resize tracking for the
        shard is dropped.  Emits ``EV_SHARD_LOST`` with the resident count
        lost.  Returns the dead shard (post-mortem inspection only — its
        payload handles are no longer valid).

        ``repro_torch.faults.recovery.failover`` builds on this: lose,
        rewarm from the ghost journal, rejoin rebalancing.
        """
        if not (0 <= sid < self.n_shards):
            raise ValueError(f"no shard {sid}")
        with self._mutate_lock, self.locks[sid]:
            old = self.shards[sid]
            lost = len(old)
            mc = self.shard_max
            fresh = ProdClock2QPlus(
                old.capacity, small_frac=old._small_frac,
                ghost_frac=old._ghost_frac, window_frac=old._window_frac,
                skip_limit=old.skip_limit,
                dirty_scan_limit=old.dirty_scan_limit, max_capacity=mc,
                track_io=old.track_io,
                max_small_frac=old.max_small / mc,
                max_ghost_frac=old.max_ghost / mc,
                min_small_frac=(mc - old.max_main) / mc, shard_id=sid,
                obs=type(old.obs)(src=f"cache/shard{sid}",
                                  labels={"shard": str(sid)}))
            if (fresh.max_small, fresh.max_main, fresh.max_ghost) != \
                    (old.max_small, old.max_main, old.max_ghost):
                raise RuntimeError(
                    "replacement shard preallocation mismatch: "
                    f"{(fresh.max_small, fresh.max_main, fresh.max_ghost)}"
                    f" != {(old.max_small, old.max_main, old.max_ghost)}")
            self.shards[sid] = fresh
            self._miss_mark[sid] = 0
            with self._resize_lock:
                self._resizing.discard(sid)
        if self.obs.ring.enabled:
            self.obs.emit(obs_mod.EV_SHARD_LOST, shard=sid, a=lost)
        return old

    # -- cross-shard capacity rebalancing -------------------------------------------
    def set_shard_capacities(self, caps: Sequence[int],
                             steps_per_call: int = 64,
                             complete: bool = True) -> None:
        """Retarget per-shard capacities (must sum to ``self.capacity``).
        Shrinking shards release capacity via their live-resize protocol;
        with ``complete=False`` the migration is left to ``rebalance_step``
        (the background-thread analogue).

        ``complete=True`` drives all *migratable* work to completion and
        then returns: entries pinned or DOING-IO beyond a new boundary
        cannot be drained until released, so their shards simply stay
        pending (later ``rebalance_step`` calls finish them) rather than
        spinning — the release call may be waiting on this very thread."""
        caps = list(caps)
        if len(caps) != self.n_shards:
            raise ValueError("need one capacity per shard")
        for c in caps:
            if not (MIN_SHARD_CAP <= c <= self.shard_max):
                raise ValueError(f"shard capacity {c} not in "
                                 f"[{MIN_SHARD_CAP}, {self.shard_max}]")
        with self._mutate_lock:
            # the sum check must sit inside the lock: a concurrent
            # begin_resize may move self.capacity between check and apply
            if sum(caps) != self.capacity:
                raise ValueError(
                    f"shard capacities must sum to {self.capacity}")
            for i, (s, c) in enumerate(zip(self.shards, caps)):
                if s.capacity != c:
                    if self.obs.ring.enabled:
                        self.obs.emit(EV_REBALANCE, shard=i,
                                      a=s.capacity, b=c)
                    with self.locks[i]:
                        # begin_resize finishes any pending HASH migration
                        # itself (bounded pointer work); the out-of-bounds
                        # drain — which pinned/DOING-IO entries CAN block —
                        # simply continues under the new targets, so no
                        # spin-wait is needed and unpin/io_done from other
                        # threads can never be deadlocked out
                        s.begin_resize(c)
                    with self._resize_lock:
                        self._resizing.add(i)
            if complete:
                drive_resize(self, steps_per_call)

    def rehash_pending(self) -> bool:
        with self._resize_lock:
            pending = sorted(self._resizing)
        return any(self.shards[i].rehash_pending() for i in pending)

    def undrained_count(self) -> int:
        """Resident entries beyond pending shards' logical boundaries."""
        with self._resize_lock:
            pending = sorted(self._resizing)
        n = 0
        for i in pending:
            with self.locks[i]:
                n += self.shards[i].undrained_count()
        return n

    def rebalance_step(self, n_entries: int = 64) -> bool:
        """Advance pending shard resizes; True when all migrations done."""
        with self._resize_lock:
            pending = sorted(self._resizing)
        done = True
        for i in pending:
            # the discard must happen under the same shard-lock hold as
            # the completion check: a concurrent retarget (which also
            # takes locks[i] for its begin_resize) could otherwise re-add
            # i between our check and discard, and the discard would
            # permanently untrack the NEW migration
            with self.locks[i]:
                finished = self.shards[i].resize_step(n_entries)
                if finished:
                    with self._resize_lock:
                        self._resizing.discard(i)
            if finished:
                if self.obs.ring.enabled:
                    self.obs.emit(EV_RESIZE_DONE, shard=i)
            else:
                done = False
        return done

    def rebalance(self, steps_per_call: int = 64,
                  complete: bool = True) -> List[int]:
        """Miss-driven rebalance: shards that missed more since the last
        rebalance get proportionally more capacity (hot shards borrow from
        cold ones).  Returns the new per-shard capacity targets."""
        with self._mutate_lock:
            deltas = [s.misses - m
                      for s, m in zip(self.shards, self._miss_mark)]
            self._miss_mark = [s.misses for s in self.shards]
            weights = [d + 1.0 for d in deltas]  # +1: never starve a shard
            caps = apportion(weights, self.capacity, MIN_SHARD_CAP,
                             self.shard_max)
            self.set_shard_capacities(caps, steps_per_call=steps_per_call,
                                      complete=complete)
            return caps

    # -- runtime tuning (OnlineTuner hook) ------------------------------------------
    @property
    def tuning(self) -> Dict[str, float]:
        """Current tuning knobs (uniform across shards by construction;
        ``retune`` retargets every shard with the same values)."""
        return self.shards[0].tuning

    def retune(self, *, small_frac: Optional[float] = None,
               ghost_frac: Optional[float] = None,
               window_frac: Optional[float] = None,
               steps_per_call: int = 64, complete: bool = True) -> None:
        """Apply one tuning decision (made from AGGREGATED stats — the
        shards all serve slices of the same workload) to every shard via
        each shard's live-resize protocol.  Like ``set_shard_capacities``,
        ``complete=True`` drives all migratable work and leaves shards
        with pinned/DOING-IO strays pending for ``rebalance_step``."""
        with self._mutate_lock:
            for i, s in enumerate(self.shards):
                with self.locks[i]:
                    s.retune(small_frac=small_frac, ghost_frac=ghost_frac,
                             window_frac=window_frac)
                with self._resize_lock:
                    self._resizing.add(i)
            if complete:
                drive_resize(self, steps_per_call)

    # -- whole-service resize (BlockPool compatibility) -----------------------------
    def begin_resize(self, new_capacity: int) -> None:
        """Retarget the TOTAL capacity, split proportionally to current
        shard capacities (so prior rebalancing decisions persist)."""
        if not (self.n_shards * MIN_SHARD_CAP <= new_capacity
                <= self.n_shards * self.shard_max):
            raise ValueError(f"total capacity {new_capacity} out of range")
        with self._mutate_lock:
            weights = [float(s.capacity) for s in self.shards]
            self.capacity = new_capacity
            caps = apportion(weights, new_capacity, MIN_SHARD_CAP,
                             self.shard_max)
            self.set_shard_capacities(caps, complete=False)

    def resize_step(self, n_entries: int = 64) -> bool:
        return self.rebalance_step(n_entries)

"""Paged KV block pool with Clock2Q+-managed device residency.

The block table of a paged KV cache is a metadata structure mapping
logical (sequence, block-index) -> physical device block — exactly the
LBN->PBN mapping of the paper (DESIGN.md §2).  The pool is two-tiered:

    device (torch tensors) <- Clock2Q+ decides residency (ProdClock2QPlus)
    host (pinned CPU tensors) <- eviction target ("disk"); dirty = device-only

Block keys are content hashes for prefix-shared full blocks (identical
prompts share physical blocks) and (seq_id, block_idx) handles for
per-sequence tail blocks.  Correlated references arise naturally: request
admission touches all prefix blocks of a sequence back-to-back.

The port of ``repro.kvcache.pool``, with every knob of the reference:
the sharded policy (``n_shards``), fault-injected host IO (``faults``,
``io_retry``) with ghost-journal failover, hot-standby replication
(``replicate``, ``journal_dir``) and the online tuner (``autotune``,
``estimate_mrc``, whose sweeps launch ``cache_sim`` on ``device``).
Host copies are synchronous, so a slot is never overwritten before its
swap-out has landed.  One departure from the reference, in
``failover_shard``: a promotion keeps a block that was written after
its host copy was taken (``note_write``) instead of copying the older
copy back over it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.core.prodcache import EMPTY, ProdClock2QPlus, drive_resize
from repro_torch.faults import GhostJournal, HostIO, ShardReplicator, splitmix64
from repro_torch.faults.io import Clock
from repro_torch.faults.recovery import failover as _failover
from repro_torch.models.config import ModelConfig
from repro_torch.shardcache import ShardedClock2QPlus


@dataclasses.dataclass
class PoolStats:
    """Point-in-time view over the pool's obs counters (compat shim —
    the ``pool_*_total`` families are the source of truth)."""
    hits: int = 0
    misses: int = 0
    swap_in: int = 0       # host -> device copies
    swap_out: int = 0      # device -> host copies (dirty evictions)
    drops: int = 0         # clean evictions (host copy already existed)

    @property
    def hit_ratio(self) -> float:
        """Hits over lookups."""
        return self.hits / max(1, self.hits + self.misses)


class BlockPool:
    """Fixed device pool of KV blocks + host tier, Clock2Q+ replacement.

    ``kpool``/``vpool`` are (L, n_slots, block_size, H_kv, hd) tensors
    on ``device`` (the card unless the caller names another)."""

    def __init__(self, cfg: ModelConfig, n_hbm_blocks: int, block_size: int,
                 n_host_blocks: int = 0, dtype=torch.float32, *,
                 window_frac: float = 0.5, max_hbm_blocks: int = 0,
                 n_shards: int = 0, rebalance_headroom: float = 1.0,
                 autotune=False, faults=None, io_retry=None,
                 journal_every: int = 1024, replicate: bool = False,
                 journal_dir: Optional[str] = None,
                 lag_threshold: int = 4096, replica_poll: int = 256,
                 obs=None, device=None):
        self.cfg = cfg
        self.bs = block_size
        self.n_blocks = n_hbm_blocks
        self.device = resolve_device(device)
        L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        # n_shards > 1 selects the sharded concurrent policy backend
        # (repro_torch.shardcache); the pool API is identical either way.
        # rebalance_headroom=1.0 keeps the block arrays at the stated
        # budget (cross-shard borrowing then needs max_hbm_blocks slack);
        # >1 preallocates extra blocks per shard for rebalancing.
        tkw = dict(autotune) if isinstance(autotune, dict) else {}
        # queue-fraction candidates need preallocation headroom (extra
        # payload slots, hence extra device blocks) so the tuner's
        # choices are realizable instead of silently clamped
        seg_kw = dict(
            max_small_frac=max(tkw.get("small_fracs") or (0.0,)),
            min_small_frac=min(tkw.get("small_fracs") or (1.0,)),
            max_ghost_frac=max(tkw.get("ghost_fracs") or (0.0,)))
        if n_shards > 1:
            self.policy = ShardedClock2QPlus(
                n_hbm_blocks, n_shards=n_shards, track_io=True,
                window_frac=window_frac,
                max_capacity=max(n_hbm_blocks, max_hbm_blocks),
                rebalance_headroom=rebalance_headroom, **seg_kw)
        else:
            self.policy = ProdClock2QPlus(
                n_hbm_blocks, track_io=True, window_frac=window_frac,
                max_capacity=max(n_hbm_blocks, max_hbm_blocks), **seg_kw)
        # the block arrays cover the policy's full payload-handle space
        # (>= n_hbm_blocks when resize headroom / sharding is configured)
        self.kpool = torch.zeros((L, self.policy.n_slots, block_size, H, hd),
                                 dtype=dtype, device=self.device)
        self.vpool = torch.zeros_like(self.kpool)
        self.host: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # with a standby to promote (replicate=): keys whose host copy is
        # older than their device block, written in place (a decoded
        # token appended) after the copy was taken
        self._stale: Optional[set] = set() if replicate else None
        self.n_host_blocks = n_host_blocks or 4 * n_hbm_blocks
        self._pin_host = self.device.type == "cuda"
        # pool-tier telemetry (the policy keeps its own sink; merged by
        # obs_snapshot()).  ``stats`` is a compat view over these.
        self.obs = obs_mod.ObsSink(src="pool") if obs is None else obs
        lookup_fam = self.obs.counter("pool_lookups_total", ("result",),
                                      "block lookups by outcome")
        self._c_hit = lookup_fam.labels("hit")
        self._c_miss = lookup_fam.labels("miss")
        swap_fam = self.obs.counter("pool_swaps_total", ("dir",),
                                    "HBM<->host block copies")
        self._c_swap_in = swap_fam.labels("in")
        self._c_swap_out = swap_fam.labels("out")
        self._c_drop = self.obs.counter(
            "pool_drops_total", (), "clean evictions (host copy "
            "already existed)").labels()
        self._g_host = self.obs.gauge(
            "pool_host_blocks", (), "blocks mirrored in the host "
            "tier").labels()
        self.obs.on_collect(lambda: self._g_host.set(float(len(self.host))))
        # per-tenant lookup attribution (serving threads tenant labels
        # through admissions; None keeps the historical unlabeled keys)
        self._tenant_fam = self.obs.counter(
            "pool_tenant_lookups_total", ("tenant", "result"),
            "block lookups attributed to serving tenants")
        # hardened host IO (repro_torch.faults).  faults=None keeps the
        # direct swap path with zero instrumentation; passing a plan
        # (NullPlan in production) routes every host-block copy through
        # HostIO — retries/backoff/deadlines, a circuit breaker that
        # sheds to read-through under sustained failure, torn-write
        # quarantine, and (on a sharded policy) a GhostJournal captured
        # every ``journal_every`` lookups so SHARD_LOSS faults trigger
        # automatic failover.
        self._io: Optional[HostIO] = None
        self._journal: Optional[GhostJournal] = None
        self._corrupt: set = set()
        self._lookups = 0
        self.journal_every = journal_every
        if faults is not None:
            self._io = HostIO(plan=faults, retry=io_retry, obs=self.obs)
            self._c_torn = self.obs.counter(
                "pool_torn_writes_total", (), "swap-outs persisted torn "
                "(PARTIAL_WRITE) and quarantined").labels()
            self._c_corrupt = self.obs.counter(
                "pool_corrupt_dropped_total", (), "quarantined host "
                "copies dropped at swap-in (read repair: refill from "
                "origin)").labels()
            self._c_lost = self.obs.counter(
                "pool_lost_writes_total", (), "dirty evictions whose "
                "swap-out failed — content refills from origin").labels()
            g_deg = self.obs.gauge(
                "pool_degraded", (), "1 while the breaker has shed host "
                "IO (read-through mode)").labels()
            self.obs.on_collect(
                lambda: g_deg.set(1.0 if self._io.degraded else 0.0))
            if hasattr(self.policy, "shards"):
                self._journal = GhostJournal(self.policy)
        # hot-standby replication (repro_torch.faults.replica): a
        # write-ahead delta journal per shard plus a bounded-staleness
        # standby that tails it, polled from the lookup path every
        # ``replica_poll`` lookups.  On shard loss, failover_shard()
        # promotes the standby while its lag is within ``lag_threshold``;
        # past it, the ghost rewarm above is the fallback.
        # journal_dir=None replicates in memory.
        self._replicator: Optional[ShardReplicator] = None
        self.replica_poll = replica_poll
        if replicate:
            if not hasattr(self.policy, "shards"):
                raise ValueError("replicate= needs a sharded policy "
                                 "(n_shards > 1)")
            self._replicator = ShardReplicator(
                self.policy, journal_dir, lag_threshold=lag_threshold,
                clock=self._io.clock if self._io is not None else None,
                obs=self.obs)
        # autotune=True (defaults) or a dict of OnlineTuner kwargs: the
        # tuner observes the block-key stream through lookup() and
        # retargets the policy's window / queue fractions online via the
        # live-resize protocol; its profiling sweeps run on the pool's
        # device.  Retuning never changes the preallocated payload-handle
        # space, so the block arrays above stay valid.
        self.tuner = None
        if autotune:
            from repro_torch.tuning import OnlineTuner
            tkw.setdefault("retune_every", max(1024, 32 * n_hbm_blocks))
            self.tuner = OnlineTuner(self.policy, obs=self.obs,
                                     device=self.device, **tkw)

    @property
    def stats(self) -> PoolStats:
        """The historical stats surface, derived from the obs counters."""
        return PoolStats(hits=self._c_hit.value, misses=self._c_miss.value,
                         swap_in=self._c_swap_in.value,
                         swap_out=self._c_swap_out.value,
                         drops=self._c_drop.value)

    def obs_snapshot(self) -> "obs_mod.Snapshot":
        """Merged pool + replacement-policy (+ tuner, which shares the
        pool's sink) telemetry."""
        pol_snap = self.policy.obs_snapshot() \
            if hasattr(self.policy, "obs_snapshot") \
            else self.policy.obs.snapshot()
        return obs_mod.merge([self.obs.snapshot(), pol_snap])

    # -- residency ------------------------------------------------------------
    def lookup(self, key: int, pin: bool = True,
               tenant: Optional[str] = None) -> Tuple[int, bool]:
        """Returns (device_slot, needs_fill).  On miss, a slot is
        allocated (evicting per Clock2Q+); if the key has a host copy it
        is swapped in; otherwise the caller must fill the block
        (needs_fill=True).  A failed/shed/quarantined swap-in degrades
        to read-through: the caller refills from the origin exactly as
        for a cold miss.  ``tenant`` additionally attributes the lookup
        to a serving tenant (``pool_tenant_lookups_total``)."""
        if self._io is not None or self._replicator is not None:
            self._lookups += 1
            if self._io is not None and self._io.pending_shard_loss:
                self._drain_shard_loss()
            if self._journal is not None and \
                    self._lookups % self.journal_every == 0:
                self._journal.capture(self.policy)
            if self._replicator is not None and \
                    self._lookups % self.replica_poll == 0:
                self._replicator.poll()
        if self.tuner is not None:
            self.tuner.observe(key)
        r = self.policy.access(key, pin=pin)
        if tenant is not None:
            self._tenant_fam.labels(
                tenant, "hit" if r.hit else "miss").value += 1
        if r.hit:
            self._c_hit.value += 1
            return r.block, False
        self._c_miss.value += 1
        if r.evicted_key != EMPTY:
            self._on_evict(r.evicted_key, r.evicted_block)
        if key in self.host and self._swap_in(key, r.block):
            self.policy.io_done(key)
            return r.block, False
        # brand-new block (or unreadable host copy): contents will be
        # written by prefill/decode
        return r.block, True

    def _on_evict(self, key: int, slot: int) -> None:
        """Device eviction: dirty blocks (no host copy) are swapped out.
        A failed swap-out loses the content (the next access refills from
        origin); a torn one (PARTIAL_WRITE) is quarantined for read
        repair at the next swap-in."""
        if key in self.host:
            self._c_drop.value += 1
            return
        if len(self.host) >= self.n_host_blocks:
            return
        if self._io is None:
            self._copy_out(key, slot)
            self._c_swap_out.value += 1
            return
        res = self._io.run("swap_out", key,
                           lambda: self._copy_out(key, slot))
        if not res.ok:
            self._c_lost.value += 1
            return
        if res.corrupt:
            self._corrupt.add(key)
            self._c_torn.value += 1
        self._c_swap_out.value += 1

    def _copy_out(self, key: int, slot: int) -> None:
        """Copy a block to the host tier; returns once it has landed."""
        shape = self.kpool[:, slot].shape
        k = torch.empty(shape, dtype=self.kpool.dtype,
                        pin_memory=self._pin_host)
        v = torch.empty_like(k, pin_memory=self._pin_host)
        k.copy_(self.kpool[:, slot])
        v.copy_(self.vpool[:, slot])
        self.host[key] = (k, v)
        if self._stale:
            self._stale.discard(key)

    def _copy_in(self, key: int, slot: int) -> None:
        """Copy a block's host copy back into device slot ``slot``."""
        k, v = self.host[key]
        self.kpool[:, slot].copy_(k)
        self.vpool[:, slot].copy_(v)

    def _swap_in(self, key: int, slot: int) -> bool:
        """Host -> device copy through the hardened path.  False = the
        copy did not happen (IO gave up, breaker shed, or the host copy
        was quarantined): the caller serves the miss read-through."""
        if self._io is None:
            self._copy_in(key, slot)
            self._c_swap_in.value += 1
            return True
        if key in self._corrupt:
            # read repair: the torn copy is detected here (the digest-
            # mismatch path) and dropped; the block refills from origin
            del self.host[key]
            self._corrupt.discard(key)
            if self._stale:
                self._stale.discard(key)
            self._c_corrupt.value += 1
            return False
        res = self._io.run("swap_in", key, lambda: self._copy_in(key, slot))
        if not res.ok:
            return False
        self._c_swap_in.value += 1
        return True

    def write_block(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                    key: Optional[int] = None) -> None:
        """k/v: (L, block_size, H, hd) — fill a block after prefill."""
        self.kpool[:, slot] = k
        self.vpool[:, slot] = v
        if key is not None:
            self.policy.io_done(key)
            self.policy.set_dirty(key)  # device-only content until flushed

    def note_write(self, key: int) -> None:
        """The device block of ``key`` is being written in place after
        ``lookup`` handed it out (``PagedKVManager.slot_for_pos`` says so
        for each decoded token): from now on a host copy of it is older
        than the block, and a promotion must not copy it back over the
        block.  A no-op without a standby (``replicate=False``)."""
        if self._stale is not None and key in self.host:
            self._stale.add(key)

    def write_token(self, slot: int, offset: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """k/v: (L, H, hd) — append one decoded token into a block."""
        self.kpool[:, slot, offset] = k
        self.vpool[:, slot, offset] = v

    def unpin(self, key: int) -> None:
        """Drop one pin of ``key`` (the block stays cached)."""
        self.policy.unpin(key)

    def flush(self, key: int) -> None:
        """Mirror a dirty block to host (background flusher).  Under the
        hardened path a failed mirror leaves the block dirty, so the
        watermark flusher naturally retries it; a torn mirror is
        quarantined like any other swap-out."""
        slot = self.policy.slot_of(key)
        if slot == EMPTY:
            return
        if key not in self.host and len(self.host) < self.n_host_blocks:
            if self._io is not None:
                res = self._io.run("swap_out", key,
                                   lambda: self._copy_out(key, slot))
                if not res.ok:
                    return  # still dirty: retried by the next flusher pass
                if res.corrupt:
                    self._corrupt.add(key)
                    self._c_torn.value += 1
            else:
                self._copy_out(key, slot)
            self._c_swap_out.value += 1
        self.policy.clean(key)

    def run_flusher(self, max_blocks: int = 4) -> int:
        """Watermark flusher (paper §4.1.3): mirror oldest dirty blocks."""
        dirty = self.policy.dirty_keys()[:max_blocks]
        for k in dirty:
            self.flush(k)
        return len(dirty)

    # -- backpressure (serving scheduler) -----------------------------------------
    def pinned_count(self) -> int:
        """Resident blocks currently pinned (unevictable) — the hard
        part of occupancy: unpinned blocks are reclaimable by Clock2Q+
        on demand, pinned ones are held by live sequences."""
        if hasattr(self.policy, "shards"):
            return sum(int((s.pin > 0).sum()) for s in self.policy.shards)
        return int((self.policy.pin > 0).sum())

    def free_fraction(self) -> float:
        """Fraction of the device budget not pinned — the scheduler's
        free-block watermark signal (1.0 = nothing held)."""
        return 1.0 - self.pinned_count() / max(1, self.n_blocks)

    def io_clock(self) -> Clock:
        """The virtual tick clock the serving scheduler should run on:
        the hardened host-IO path's clock when fault injection is armed
        (so IO backoff time and scheduler time share one axis), a fresh
        one otherwise."""
        return self._io.clock if self._io is not None else Clock()

    # -- faults / failover (repro_torch.faults) -----------------------------------
    @property
    def degraded(self) -> bool:
        """True while host IO is shed (read-through mode).  Always False
        on the uninstrumented path."""
        return self._io is not None and self._io.degraded

    def replication_lag(self, sid: int) -> int:
        """Standby lag for shard ``sid`` in journal records (0 when
        replication is off)."""
        return self._replicator.lag(sid) if self._replicator else 0

    def failover_shard(self, sid: int) -> Tuple[int, int]:
        """Lose shard ``sid`` and rebuild it.

        With replication armed (``replicate=True``) and the standby's
        lag within threshold, the standby is *promoted*: the journal
        tail is replayed past its applied LSN, its exact replacement
        state is loaded into the fresh shard, and only payloads refill
        — no synthetic re-accesses (``repro_torch.faults.replica``).  A
        too-stale standby (or no replication) falls back to the ghost-
        journal rewarm (``repro_torch.faults.recovery.failover``), after
        which the shard's journal is reattached at the next epoch so
        replication resumes.  Either way, readmitted keys whose payloads
        survive in the host tier are copied straight into device slot
        ``sid * stride + local`` (the recovery scan reads local copies,
        not the faulted swap path); the rest end up in the ghost ring
        and refill from origin on their next touch.  Returns (residents,
        ghosts) for rewarm, (refilled, demoted) for promotion.

        One departure from the reference: the shard loss drops the
        shard's replacement state, not the pool's device blocks, and a
        promoted key keeps its slot.  So a block written since its host
        copy was taken (``note_write``: a live sequence's decode tail)
        keeps its device content at promotion; the reference copies the
        older host copy over it, which rolls back the sequence's newest
        tokens.  Keys, slots and every counter are the reference's.
        """
        if self._journal is None and self._replicator is None:
            raise RuntimeError("failover needs faults= (or replicate=) "
                               "and a sharded policy (n_shards > 1)")
        base = sid * self.policy.stride

        def fill(key, promote=False):
            if key not in self.host or key in self._corrupt:
                return None
            if promote and key in self._stale:
                return lambda local: None  # the device block is newer
            return lambda local: self._copy_in(key, base + local)

        rep = self._replicator
        if rep is not None and rep.should_promote(sid):
            res = rep.promote(sid, fill=lambda key: fill(key, promote=True))
            return (res.refilled, res.demoted)
        if self._journal is None:
            raise RuntimeError("standby for shard %d is %d records "
                               "stale (threshold %d) and no ghost "
                               "journal is armed (faults=)"
                               % (sid, rep.lag(sid), rep.lag_threshold))
        out = _failover(self.policy, sid, self._journal, fill=fill)
        if rep is not None:
            rep.reattach(sid)  # resume journaling the rewarmed shard
        return out

    def _drain_shard_loss(self) -> None:
        """Apply SHARD_LOSS faults the plan injected on the IO stream.
        ``shard=-1`` specs pick the victim by hashing the op sequence the
        fault fired at (deterministic per seed)."""
        pending, self._io.pending_shard_loss = \
            self._io.pending_shard_loss, []
        if self._journal is None:
            return  # unsharded policy: nothing to lose a shard from
        n = self.policy.n_shards
        for f in pending:
            sid = f.shard if f.shard >= 0 else \
                splitmix64(self._io.plan.seed ^ f.op_seq) % n
            self.failover_shard(sid)

    # -- what-if analysis --------------------------------------------------------
    def estimate_mrc(self, capacities=None, *, rate_shift: int = 4,
                     window_fracs=None) -> Dict[int, float]:
        """Sampled MRC estimate of the recent block-key stream at
        alternative device budgets — what-if input for ``resize()``.
        Requires ``autotune=`` (the tuner's ring buffer is the key
        history); one ``cache_sim`` sweep on the pool's device over the
        live policy's lane engine, so the estimates describe the exact
        replacement machine this pool runs.  Returns {capacity: est.
        miss ratio} (NaN when the sample is empty)."""
        from repro_torch.tuning import profiler

        if self.tuner is None:
            raise RuntimeError(
                "estimate_mrc needs autotune= — the OnlineTuner's access "
                "ring buffer is the key history it profiles")
        caps = [int(c) for c in
                (capacities or (max(1, self.n_blocks // 2), self.n_blocks,
                                2 * self.n_blocks))]
        live = self.tuner._live_config()
        wfs = tuple(window_fracs) if window_fracs else (live.window_frac,)
        configs = [dataclasses.replace(live, capacity=c, window_frac=wf)
                   for c in caps for wf in wfs]
        trace = self.tuner.recent()
        if trace.size == 0:
            return {c: float("nan") for c in caps}
        est = profiler.estimate_sweep(trace, configs, rate_shift,
                                      device=self.device)
        # best window per capacity: the pool would retune after a resize
        per_cap = est.reshape(len(caps), len(wfs))
        out = {c: float(np.nanmin(per_cap[i])) for i, c in enumerate(caps)}
        # what-if MRC as a gauge family: the last estimate at each
        # alternative budget stays scrapeable between calls
        fam = self.obs.gauge("pool_est_miss_ratio", ("capacity",),
                             "sampled-MRC estimate at alternative HBM "
                             "budgets (last estimate_mrc call)")
        for c, mr in out.items():
            fam.labels(str(c)).set(mr)
        return out

    # -- elastic resize (paper §4.2 -> device budget changes) -----------------------
    def resize(self, new_n_blocks: int, steps_per_call: int = 64) -> None:
        """Retarget the device budget and drive all *migratable* work to
        completion.  Blocks pinned or DOING-IO beyond a shrink boundary
        cannot be drained until released — those are left pending (later
        ``resize_step``/``resize`` calls finish them) instead of spinning:
        the unpin/io_done may be waiting on this very thread."""
        self.policy.begin_resize(new_n_blocks)
        drive_resize(self.policy, steps_per_call)

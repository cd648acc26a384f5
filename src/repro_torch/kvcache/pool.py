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

The port of ``repro.kvcache.pool`` with one ``ProdClock2QPlus`` policy.
Host copies are synchronous, so a slot is never overwritten before its
swap-out has landed.  The sharded policy (``n_shards``), fault-injected
host IO (``faults``, ``io_retry``), replication (``replicate``,
``journal_dir``) and the online tuner (``autotune``, ``estimate_mrc``)
are not taken yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.core.prodcache import EMPTY, ProdClock2QPlus, drive_resize
from repro_torch.faults.io import Clock
from repro_torch.models.config import ModelConfig


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
                 obs=None, device=None):
        self.cfg = cfg
        self.bs = block_size
        self.n_blocks = n_hbm_blocks
        self.device = resolve_device(device)
        L, H, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        # the preallocation fractions of a pool without the tuner
        self.policy = ProdClock2QPlus(
            n_hbm_blocks, track_io=True, window_frac=window_frac,
            max_capacity=max(n_hbm_blocks, max_hbm_blocks),
            max_small_frac=0.0, min_small_frac=1.0, max_ghost_frac=0.0)
        # the block arrays cover the policy's full payload-handle space
        # (>= n_hbm_blocks when resize headroom is configured)
        self.kpool = torch.zeros((L, self.policy.n_slots, block_size, H, hd),
                                 dtype=dtype, device=self.device)
        self.vpool = torch.zeros_like(self.kpool)
        self.host: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
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

    @property
    def stats(self) -> PoolStats:
        """The historical stats surface, derived from the obs counters."""
        return PoolStats(hits=self._c_hit.value, misses=self._c_miss.value,
                         swap_in=self._c_swap_in.value,
                         swap_out=self._c_swap_out.value,
                         drops=self._c_drop.value)

    def obs_snapshot(self) -> "obs_mod.Snapshot":
        """Merged pool + replacement-policy telemetry."""
        return obs_mod.merge([self.obs.snapshot(),
                              self.policy.obs.snapshot()])

    # -- residency ------------------------------------------------------------
    def lookup(self, key: int, pin: bool = True,
               tenant: Optional[str] = None) -> Tuple[int, bool]:
        """Returns (device_slot, needs_fill).  On miss, a slot is
        allocated (evicting per Clock2Q+); if the key has a host copy it
        is swapped in; otherwise the caller must fill the block
        (needs_fill=True).  ``tenant`` additionally attributes the
        lookup to a serving tenant (``pool_tenant_lookups_total``)."""
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
        if key in self.host:
            self._copy_in(key, r.block)
            self._c_swap_in.value += 1
            self.policy.io_done(key)
            return r.block, False
        # brand-new block: contents will be written by prefill/decode
        return r.block, True

    def _on_evict(self, key: int, slot: int) -> None:
        """Device eviction: dirty blocks (no host copy) are swapped out."""
        if key in self.host:
            self._c_drop.value += 1
            return
        if len(self.host) >= self.n_host_blocks:
            return
        self._copy_out(key, slot)
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

    def _copy_in(self, key: int, slot: int) -> None:
        """Copy a block's host copy back into device slot ``slot``."""
        k, v = self.host[key]
        self.kpool[:, slot].copy_(k)
        self.vpool[:, slot].copy_(v)

    def write_block(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                    key: Optional[int] = None) -> None:
        """k/v: (L, block_size, H, hd) — fill a block after prefill."""
        self.kpool[:, slot] = k
        self.vpool[:, slot] = v
        if key is not None:
            self.policy.io_done(key)
            self.policy.set_dirty(key)  # device-only content until flushed

    def write_token(self, slot: int, offset: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """k/v: (L, H, hd) — append one decoded token into a block."""
        self.kpool[:, slot, offset] = k
        self.vpool[:, slot, offset] = v

    def unpin(self, key: int) -> None:
        """Drop one pin of ``key`` (the block stays cached)."""
        self.policy.unpin(key)

    def flush(self, key: int) -> None:
        """Mirror a dirty block to host (background flusher)."""
        slot = self.policy.slot_of(key)
        if slot == EMPTY:
            return
        if key not in self.host and len(self.host) < self.n_host_blocks:
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
        return int((self.policy.pin > 0).sum())

    def free_fraction(self) -> float:
        """Fraction of the device budget not pinned — the scheduler's
        free-block watermark signal (1.0 = nothing held)."""
        return 1.0 - self.pinned_count() / max(1, self.n_blocks)

    def io_clock(self) -> Clock:
        """The virtual tick clock the serving scheduler runs on: a fresh
        one (host IO here has no fault injection, hence no backoff time
        to share an axis with)."""
        return Clock()

    @property
    def degraded(self) -> bool:
        """True while host IO is shed (read-through mode); always False
        on this uninstrumented pool."""
        return False

    # -- elastic resize (paper §4.2 -> device budget changes) -----------------------
    def resize(self, new_n_blocks: int, steps_per_call: int = 64) -> None:
        """Retarget the device budget and drive all *migratable* work to
        completion.  Blocks pinned or DOING-IO beyond a shrink boundary
        cannot be drained until released — those are left pending (later
        ``resize_step``/``resize`` calls finish them) instead of spinning:
        the unpin/io_done may be waiting on this very thread."""
        self.policy.begin_resize(new_n_blocks)
        drive_resize(self.policy, steps_per_call)

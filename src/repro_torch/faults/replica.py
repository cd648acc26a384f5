"""Hot-standby shard replication over the write-ahead delta journal.

The port's own copy of ``repro/faults/replica.py``.

A ``ShardReplica`` is a metadata mirror of one live shard: a private
``ProdClock2QPlus`` built from the journal's base snapshot that tails
the journal — applying records past its ``applied_lsn`` — so at any
instant it holds the shard's exact state as of some recent LSN.  The
staleness is *bounded* and *measured*: ``lag`` is exactly how many
journal records the standby is behind, exported as the
``cache_replica_lag_lsn{shard}`` gauge.

``ShardReplicator`` runs one journal + replica pair per shard of a
sharded service (duck-typed: anything with ``n_shards`` / ``shards`` /
``locks`` / ``lose_shard`` — no shardcache import, per the layering
rules).  ``poll()`` is the replication tick, driven from the pool's
lookup path on the virtual IO clock.  On shard loss, ``promote()``
replaces the cold ghost-rewarm of ``recovery``: the standby first drains the journal
tail (so its state is bit-exact at the moment of loss), its state is
loaded wholesale into the fresh shard, and only the *payloads* need
refilling — keys whose payloads cannot be recovered are demoted to the
Ghost ring, where the paper's readmission machinery picks them up.
Because the full replacement-state structure (queues, clock hand,
recency bits, correlation-window seqs) survives, the post-failover miss
ratio matches the uninterrupted run far closer than a rewarm, which
must rebuild all of it through synthetic re-accesses.

The promote-vs-rewarm decision belongs to the caller (the pool): when
replication lag exceeds its threshold — the standby fell too far behind
to be worth promoting — fall back to ghost rewarm and ``reattach`` the
journal afterwards.  Either path bumps the journal epoch, starting a
fresh base + segment chain for the shard's new incarnation.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

from repro_torch.core.prodcache import EMPTY
from repro_torch.faults.io import Clock
from repro_torch.faults.journal import JRecord, ShardJournal, apply_record
from repro_torch.faults.snapshot import (
    load_state_dict, policy_from_snapshot, state_dict,
)
from repro_torch.obs.events import EV_PROMOTE
from repro_torch.obs.export import NullSink


class ShardReplica:
    """A bounded-staleness mirror of one journaled shard."""

    def __init__(self, journal: ShardJournal):
        self.journal = journal
        base = journal.base_state()
        self.mirror = policy_from_snapshot(base, obs=NullSink())
        self.applied_lsn = int(base["meta"].get("journal_lsn", 0))

    @property
    def lag(self) -> int:
        """Records the standby is behind the journal head (0 = caught up)."""
        return self.journal.lsn - self.applied_lsn

    def apply(self, rec: JRecord) -> bool:
        """Apply one record to the mirror.  Records at or below
        ``applied_lsn`` are skipped (idempotent — re-delivery after a
        resume is harmless); an LSN *gap* raises, because skipping a
        record would silently fork the mirror."""
        if rec.lsn <= self.applied_lsn:
            return False
        if rec.lsn != self.applied_lsn + 1:
            raise ValueError(
                f"replica at lsn {self.applied_lsn} handed record "
                f"{rec.lsn}: journal gap")
        apply_record(self.mirror, rec)
        self.applied_lsn = rec.lsn
        return True

    def catch_up(self, upto: Optional[int] = None) -> int:
        """Drain the journal tail into the mirror (optionally only up to
        LSN ``upto``); returns records applied."""
        n = 0
        for rec in self.journal.records_since(self.applied_lsn):
            if upto is not None and rec.lsn > upto:
                break
            if self.apply(rec):
                n += 1
        return n


class PromoteResult(NamedTuple):
    """What ``ShardReplicator.promote`` did."""

    replayed: int      # journal records drained into the standby at loss
    lag_at_loss: int   # how stale the standby was when the shard died
    refilled: int      # resident keys whose payloads were recovered
    demoted: int       # residents demoted to ghost (payload unrecoverable)


def _demote_to_ghost(sh, key: int) -> None:
    """Drop a resident entry whose payload is gone: remove it from the
    hash + payload maps (clearing pins — the payload no longer exists to
    stay pinned) and seed the key into the Ghost ring so its next touch
    readmits it through normal ghost promotion."""
    eid = sh._hash_lookup(key)
    if eid == EMPTY:
        eid = sh._find_stray(key)
    if eid == EMPTY:
        return
    sh._hash_remove(eid)
    sh.free_blocks.append(int(sh.block[eid]))
    sh.key[eid] = EMPTY
    sh.block[eid] = EMPTY
    sh.ref[eid] = False
    sh.pin[eid] = 0
    sh.io[eid] = False
    sh.dirty[eid] = False
    sh._ghost_push(key)


class ShardReplicator:
    """One journal + hot-standby replica per shard of a sharded service.

    ``directory=None`` keeps every journal in memory (pure hot-standby);
    a path gives each shard its own durable journal under
    ``directory/shard{i}``.  ``lag_threshold`` is advisory state for the
    caller's promote-vs-rewarm decision (``should_promote``); ``clock``
    is the virtual tick clock replication time is measured on (shared
    with the pool's ``HostIO`` when faults are wired).
    """

    def __init__(self, svc, directory: Optional[str] = None, *,
                 lag_threshold: int = 4096, segment_records: int = 4096,
                 sync_every: int = 0, clock: Optional[Clock] = None,
                 obs=None, plan=None):
        self.svc = svc
        self.directory = directory
        self.lag_threshold = int(lag_threshold)
        self.clock = clock if clock is not None else Clock()
        self.obs = obs
        self._segment_records = int(segment_records)
        self._sync_every = int(sync_every)
        self._plan = plan
        self.journals: List[ShardJournal] = []
        self.replicas: List[ShardReplica] = []
        self._g_lag = (obs.gauge("cache_replica_lag_lsn", ("shard",))
                       if obs is not None else None)
        self._lag_cells = []
        for i in range(svc.n_shards):
            jr = self._new_journal(i, epoch=0)
            with svc.locks[i]:
                jr.attach(svc.shards[i])
            self.journals.append(jr)
            self.replicas.append(ShardReplica(jr))
            self._lag_cells.append(
                self._g_lag.labels(str(i)) if self._g_lag is not None
                else None)

    def _new_journal(self, sid: int, epoch: int) -> ShardJournal:
        d = (os.path.join(self.directory, f"shard{sid}")
             if self.directory is not None else None)
        return ShardJournal(d, shard_id=sid, epoch=epoch,
                            segment_records=self._segment_records,
                            sync_every=self._sync_every, plan=self._plan)

    def lag(self, sid: int) -> int:
        """Current replication lag of shard ``sid`` in journal records."""
        return self.replicas[sid].lag

    def should_promote(self, sid: int) -> bool:
        """The promote-vs-rewarm decision: promote while the standby's
        lag is within threshold (it can replay the tail and be exact);
        past it, a ghost rewarm is the better recovery."""
        return self.lag(sid) <= self.lag_threshold

    def poll(self) -> int:
        """One replication tick: export pre-drain lag, catch every
        standby up to its journal head, advance the virtual clock.
        Returns total records applied."""
        applied = 0
        for i, rep in enumerate(self.replicas):
            cell = self._lag_cells[i]
            if cell is not None:
                cell.value = float(rep.lag)
            applied += rep.catch_up()
        self.clock.advance(1)
        return applied

    def reattach(self, sid: int) -> None:
        """Start the next journal epoch for shard ``sid``'s current
        incarnation: seal the old journal, open a fresh one (new base,
        new segment chain) and rebuild the standby from it.  Called
        after promote AND after a rewarm fallback, so journaling always
        resumes on the shard that is actually serving."""
        old = self.journals[sid]
        old.close()
        jr = self._new_journal(sid, epoch=old.epoch + 1)
        with self.svc.locks[sid]:
            jr.attach(self.svc.shards[sid])
        self.journals[sid] = jr
        self.replicas[sid] = ShardReplica(jr)

    def promote(self, sid: int, fill=None) -> PromoteResult:
        """Fail shard ``sid`` over to its hot standby.

        Drains the journal tail into the standby (making it bit-exact at
        the moment of loss), swaps the dead shard for a fresh one
        (``svc.lose_shard``), loads the standby's full replacement state
        into it, and refills payloads: ``fill(key)`` returns a
        ``filler(local_slot)`` when the payload is recoverable (host
        tier) or None when it is not — those keys are demoted to the
        Ghost ring for organic readmission.  ``fill=None`` (the whole
        callback absent) means payloads are not modeled at all —
        metadata-only callers, same convention as
        ``GhostJournal.rewarm`` — and every resident is kept.  Finally
        ``reattach`` bumps the journal epoch and emits ``EV_PROMOTE``.
        """
        rep = self.replicas[sid]
        lag_at_loss = rep.lag
        replayed = rep.catch_up()  # exact state at loss, from the tail
        self.svc.lose_shard(sid)
        refilled = 0
        demoted = 0
        with self.svc.locks[sid]:
            sh = self.svc.shards[sid]
            load_state_dict(sh, state_dict(rep.mirror))
            if fill is not None:
                for key in sh.resident_keys():
                    filler = fill(key)
                    if filler is None:
                        _demote_to_ghost(sh, key)
                        demoted += 1
                    else:
                        filler(sh.slot_of(key))
                        sh.io_done(key)
                        refilled += 1
        self.reattach(sid)
        if self.obs is not None and self.obs.ring.enabled:
            self.obs.emit(EV_PROMOTE, shard=sid, a=replayed, b=lag_at_loss)
        return PromoteResult(replayed=replayed, lag_at_loss=lag_at_loss,
                             refilled=refilled, demoted=demoted)

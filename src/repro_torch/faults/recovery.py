"""Shard failover: rebuild a lost shard's working set from ghost entries.

The port's own copy of ``repro/faults/recovery.py``.

The Ghost ring is the key asymmetry this module exploits: it is *pure
metadata* (keys only, no payloads — §4.1), small enough to journal
continuously at negligible cost, while the resident payloads are exactly
what a crashed shard loses.  So recovery works like this:

  * a ``GhostJournal`` periodically captures, under each shard's lock,
    the shard's resident keys (coldest first) and ghost-ring keys — a
    few KB per shard;
  * on shard loss (``ShardedClock2QPlus.lose_shard`` swaps in a fresh
    empty shard), ``failover`` seeds the replacement's Ghost ring from
    the journal and then *re-admits* the journaled working set through
    the normal ghost-promotion path — each key ghost-hits straight into
    the Main Clock, precisely the paper's readmission machinery, so the
    rebuilt shard has the same structure organic traffic would produce;
  * keys whose payloads survive elsewhere (the pool's host tier) are
    refilled via the ``fill`` callback; the rest stay seeded in the
    Ghost ring, where their next touch readmits them with a single
    fill miss.

The shard then rejoins cross-shard rebalancing with a clean miss mark.
The chaos suite asserts recovery lands within 1pp of an uninjured run's
miss ratio on three SUITE traces.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs import EV_SHARD_REWARM


class GhostJournal:
    """Per-shard metadata journal (resident + ghost keys) for failover.

    ``capture`` refreshes the journal from the live service; how often
    to call it is a durability/staleness trade the operator makes (see
    docs/operations.md).  The journal never references payloads, so a
    capture is a few microseconds of key copying per shard.
    """

    def __init__(self, svc=None):
        self.meta: Dict[int, Dict[str, List[int]]] = {}
        self.captures = 0
        if svc is not None:
            self.capture(svc)

    def capture(self, svc, sid: Optional[int] = None) -> None:
        """Record the current working-set metadata of every shard (or
        one shard), each captured atomically under its shard lock."""
        sids = range(svc.n_shards) if sid is None else (sid,)
        for i in sids:
            with svc.locks[i]:
                sh = svc.shards[i]
                self.meta[i] = {"resident": sh.resident_keys(),
                                "ghost": sh.ghost_keys()}
        self.captures += 1

    def rewarm(self, svc, sid: int,
               fill: Optional[Callable[[int], Optional[Callable[[int], None]]]]
               = None) -> Tuple[int, int]:
        """Warm the (fresh) shard ``sid`` from the last captured journal.

        Ghost keys are re-seeded oldest-first; journaled resident keys
        are pushed into the Ghost ring and immediately re-accessed, so
        they readmit to the Main Clock through the normal ghost-
        promotion path.  ``fill(key)`` (optional) returns a
        ``filler(local_slot)`` callback when the key's payload can be
        recovered (e.g. from the pool's host tier) or None when it
        cannot — unrecoverable keys stay seeded in the Ghost ring and
        readmit with one fill miss on their next organic touch.

        Returns ``(residents_readmitted, ghosts_seeded)``.
        """
        meta = self.meta.get(sid)
        if meta is None:
            return (0, 0)
        sh = svc.shards[sid]
        n_res = 0
        n_ghost = 0
        with svc.locks[sid]:
            # residents first: each is pushed into the ghost ring and
            # immediately re-accessed, so its ghost entry is consumed on
            # the spot and the ring is free for the journaled ghosts below
            unfilled = []
            for k in meta["resident"]:
                k = int(k)
                filler = None
                if fill is not None:
                    filler = fill(k)
                    if filler is None:
                        # payload unrecoverable: defer to the ghost
                        # seeding below, so the next organic touch
                        # readmits it with one fill miss
                        unfilled.append(k)
                        continue
                sh._ghost_push(k)
                r = sh.access(k)
                if filler is not None:
                    filler(r.block)
                sh.io_done(k)
                n_res += 1
            # then the ghost seeds: journaled ghosts oldest first, then
            # unfillable residents (warmer — they were resident at
            # capture), so the warmest keys land farthest from the
            # overwrite cursor.  A consistent capture has disjoint
            # resident/ghost sets, so none of these can shadow an entry
            # readmitted above.
            for k in meta["ghost"] + unfilled:
                sh._ghost_push(int(k))
                n_ghost += 1
        return (n_res, n_ghost)


def failover(svc, sid: int, journal: GhostJournal,
             fill: Optional[Callable] = None) -> Tuple[int, int]:
    """Full shard failover: drop the dead shard, rewarm its replacement
    from the journal, and let it rejoin rebalancing.

    ``svc.lose_shard(sid)`` swaps in an empty shard with identical
    preallocation (payload handles stay valid for the backing arrays)
    and resets the shard's rebalance miss mark; the journal then
    rebuilds the working set as described on ``GhostJournal.rewarm``.
    Emits ``EV_SHARD_REWARM`` with the readmission counts.
    """
    svc.lose_shard(sid)
    n_res, n_ghost = journal.rewarm(svc, sid, fill=fill)
    if svc.obs.ring.enabled:
        svc.obs.emit(EV_SHARD_REWARM, shard=sid, a=n_res, b=n_ghost)
    return (n_res, n_ghost)

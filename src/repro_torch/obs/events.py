"""Fixed-capacity ring-buffer event trace.

Events record the *state transitions* of the cache stack — evictions,
ghost promotions, correlation-window entries/exits, tuner retune
decisions, shard rebalance / live-resize steps, IO waits, and periodic
replay snapshot rows.  Pure cache hits never emit (hit-path-cheap
telemetry — hits are the line-rate path the paper optimizes).

A record is deliberately compact: parallel preallocated numpy columns
(seq, kind, shard, a, b int64; c float64) written by scalar stores — an
``emit`` is six array-cell assignments, no object allocation, no
formatting.  ``seq`` is a monotonic per-ring sequence number: total
events ever emitted is ``ring.n``, the ring retains the last
``capacity`` of them, and ``dropped = n - capacity`` tells a reader
exactly how much history wrapped away.

Like the metric registries, rings are lock-free within their owner (one
ring per shard / component) and merged only at snapshot time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# event kinds (int8 codes in the ring; names in exports)
EV_EVICT = 1            # a=key, b=1 main-clock victim / 0 small->ghost demote
EV_GHOST_PROMOTE = 2    # a=key   (ghost hit readmitted straight to main)
EV_WINDOW_ENTER = 3     # a=key   (inserted into the Small FIFO: window opens)
EV_WINDOW_EXIT = 4      # a=key, b=age  (first re-reference past the window)
EV_IO_WAIT = 5          # a=key   (access landed on a DOING-IO entry)
EV_RETUNE = 6           # a/b=window before/after (slots or 1e4*frac), c=gain
EV_REBALANCE = 7        # a/b=shard capacity before/after
EV_RESIZE = 8           # a/b=total capacity before/after (begin_resize)
EV_RESIZE_DONE = 9      # live-resize migration drained for this shard
EV_SNAPSHOT = 10        # a=accesses so far, b=hits so far, c=miss ratio

# fault-injection / recovery vocabulary (repro.faults).  These are the
# incident-timeline records: every injected fault, every retry, every
# degraded-mode flip, shard loss/rewarm, and state snapshot/restore
# emits exactly one event, so `tools/obsreport.py --incidents` can
# reconstruct what happened to a wounded cache from the ring alone.
EV_FAULT = 11           # a=fault kind code (faults.plan), b=key/op seq
EV_IO_RETRY = 12        # a=attempt number (1-based), b=backoff ticks
EV_IO_ERROR = 13        # a=key, b=attempts made (op gave up)
EV_DEGRADED = 14        # a=1 entered read-through / 0 recovered
EV_SHARD_LOST = 15      # shard=sid, a=resident entries lost
EV_SHARD_REWARM = 16    # shard=sid, a=residents readmitted, b=ghosts
EV_RESTORE = 17         # a=snapshot step restored, b=resident entries

# write-ahead journal / hot-standby replication vocabulary
# (repro.faults.journal / repro.faults.replica)
EV_JOURNAL_TRUNCATED = 22  # shard=sid, a=last durable LSN, b=torn bytes cut
EV_PROMOTE = 23            # shard=sid, a=journal records replayed, b=lag
                           # (LSNs the standby was behind at loss)

# serving-scheduler vocabulary (repro.serving.scheduler).  The scheduler
# runs on a virtual tick clock, so `shard` carries the tick the decision
# was made at — the events ARE the schedule, and the simulation-test
# harness asserts the stream is bit-identical per seed.
EV_ADMIT = 18           # shard=tick, a=req_id, b=priority class
EV_REJECT = 19          # shard=tick, a=req_id, b=reason code
EV_SHED = 20            # shard=tick, a=req_id, b=reason code
EV_BATCH = 21           # shard=tick, a=prefills, b=decodes, c=token budget used

EVENT_NAMES: Dict[int, str] = {
    EV_EVICT: "evict",
    EV_GHOST_PROMOTE: "ghost_promote",
    EV_WINDOW_ENTER: "window_enter",
    EV_WINDOW_EXIT: "window_exit",
    EV_IO_WAIT: "io_wait",
    EV_RETUNE: "retune",
    EV_REBALANCE: "rebalance",
    EV_RESIZE: "resize",
    EV_RESIZE_DONE: "resize_done",
    EV_SNAPSHOT: "snapshot",
    EV_FAULT: "fault_inject",
    EV_IO_RETRY: "io_retry",
    EV_IO_ERROR: "io_error",
    EV_DEGRADED: "degraded",
    EV_SHARD_LOST: "shard_lost",
    EV_SHARD_REWARM: "shard_rewarm",
    EV_RESTORE: "restore",
    EV_JOURNAL_TRUNCATED: "journal_truncated",
    EV_PROMOTE: "promote",
    EV_ADMIT: "admit",
    EV_REJECT: "reject",
    EV_SHED: "shed",
    EV_BATCH: "batch",
}

# the subset obsreport's --incidents view keeps: fault/recovery flow
# (plus scheduler load-shedding/rejection — the serving half of an
# incident timeline: a degraded flip is usually followed by sheds)
INCIDENT_KINDS = frozenset((
    "fault_inject", "io_retry", "io_error", "degraded", "shard_lost",
    "shard_rewarm", "restore", "rebalance", "resize", "resize_done",
    "shed", "reject", "journal_truncated", "promote",
))


class EventRing:
    """Preallocated ring of structured event records."""

    enabled = True

    def __init__(self, capacity: int = 4096, src: str = ""):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        self.capacity = capacity
        self.src = src
        self.n = 0  # total emitted == next sequence number
        self._seq = np.zeros(capacity, np.int64)
        self._kind = np.zeros(capacity, np.int8)
        self._shard = np.zeros(capacity, np.int64)
        self._a = np.zeros(capacity, np.int64)
        self._b = np.zeros(capacity, np.int64)
        self._c = np.zeros(capacity, np.float64)

    def emit(self, kind: int, shard: int = -1, a: int = 0, b: int = 0,
             c: float = 0.0) -> None:
        """Record one event (dropped when the sink is off)."""
        i = self.n % self.capacity
        self._seq[i] = self.n
        self._kind[i] = kind
        self._shard[i] = shard
        self._a[i] = a
        self._b[i] = b
        self._c[i] = c
        self.n += 1

    @property
    def dropped(self) -> int:
        """Events that wrapped out of the ring."""
        return max(0, self.n - self.capacity)

    def records(self) -> List[dict]:
        """Retained events, oldest first, as plain dicts (export form)."""
        n_live = min(self.n, self.capacity)
        start = self.n - n_live
        out = []
        for s in range(start, self.n):
            i = s % self.capacity
            kind = int(self._kind[i])
            out.append(dict(seq=int(self._seq[i]), src=self.src,
                            kind=EVENT_NAMES.get(kind, str(kind)),
                            shard=int(self._shard[i]), a=int(self._a[i]),
                            b=int(self._b[i]), c=float(self._c[i])))
        return out


class NullRing(EventRing):
    """Event trace disabled: ``emit`` is a no-op, nothing is retained.
    The ``enabled`` flag lets instrumentation skip event-payload
    computation entirely (``if ring.enabled: ...``)."""

    enabled = False

    def __init__(self, src: str = ""):
        self.capacity = 0
        self.src = src
        self.n = 0

    def emit(self, kind: int, shard: int = -1, a: int = 0, b: int = 0,
             c: float = 0.0) -> None:
        """Record one event (dropped when the sink is off)."""
        return None

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return 0

    def records(self) -> List[dict]:
        """The surviving events, oldest first."""
        return []

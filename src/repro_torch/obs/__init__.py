"""``repro.obs`` — the observability subsystem (metrics, events, export).

Bottom layer of the repo, sealed: imports only stdlib + numpy, is
imported by every cache subsystem (core, shardcache, kvcache, tuning,
serving) — see tools/check_layering.py.

    sink = ObsSink(src="shard0", labels={"shard": "0"})
    hits = sink.counter("cache_hits_total", ("shard", "queue"))
    c = hits.labels("0", "small")   # bind once at init ...
    c.value += 1                    # ... increment directly on the hot path
    sink.emit(EV_EVICT, shard=0, a=key)          # state transitions only
    print(to_prometheus(sink.snapshot()))
"""

from repro_torch.obs.events import (  # noqa: F401
    EV_ADMIT, EV_BATCH, EV_DEGRADED, EV_EVICT, EV_FAULT, EV_GHOST_PROMOTE,
    EV_IO_ERROR, EV_IO_RETRY, EV_IO_WAIT, EV_JOURNAL_TRUNCATED,
    EV_PROMOTE, EV_REBALANCE, EV_REJECT, EV_RESIZE, EV_RESIZE_DONE,
    EV_RESTORE, EV_RETUNE, EV_SHARD_LOST, EV_SHARD_REWARM, EV_SHED,
    EV_SNAPSHOT, EV_WINDOW_ENTER, EV_WINDOW_EXIT, EVENT_NAMES,
    INCIDENT_KINDS, EventRing, NullRing,
)
from repro_torch.obs.export import (  # noqa: F401
    NullSink, ObsSink, Snapshot, delta, merge, snapshot, to_prometheus,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Family, Gauge, Histogram, Registry, parse_sample_key,
    sample_key,
)

# canonical Clock2Q+ flow-counter schema: every implementation's
# ``flows()`` dict is derived from the ``cache_flow_total{flow=...}``
# counter family iterated in THIS order, so the single-shard and
# sharded-aggregate key sets can never drift.
FLOW_KINDS = ("small_to_main", "small_to_ghost", "ghost_to_main",
              "evict_main", "small_bypass")

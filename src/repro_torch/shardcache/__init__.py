"""Sharded concurrent cache service — the multi-CPU scalability subsystem
(the port of ``repro.shardcache``).

The paper's Clock2Q+ "scales efficiently to multiple CPUs" (§4, §5) by
keeping the hot path short and lock hold times small.  This package is
the repo's counterpart: N hash-partitioned ``ProdClock2QPlus`` shards
behind one facade (``ShardedClock2QPlus``), with

  * ``access_many`` — batched dispatch that groups keys by shard and
    amortizes per-request overhead,
  * per-shard locks + a multi-threaded replay harness
    (``repro_torch.shardcache.replay``) that measures real throughput
    scaling,
  * cross-shard capacity rebalancing built on the live-resize protocol
    (§4.2): hot shards borrow capacity from cold ones without a stop-the-
    world rebuild,
  * aggregated stats/flows across shards.

Its simulation on the card is ``core.torch_engine.sharded_replay``: the
same hash partition, each shard a lane of one ``cache_sim`` launch.
"""

from repro_torch.shardcache.hashing import shard_of, shard_of_np  # noqa: F401
from repro_torch.shardcache.sharded import ShardedClock2QPlus  # noqa: F401
from repro_torch.shardcache.replay import (  # noqa: F401
    ReplayReport, replay_threaded, scalability_sweep, unsharded_miss_ratio,
)

"""Fault injection & crash-consistent recovery for the serving cache.

The port of ``repro.faults``, module for module, with the same names,
signatures, event kinds and byte formats.

Four pieces, layered bottom-up (each importable alone):

  * ``plan``     — deterministic seeded fault schedules (``FaultPlan`` /
    ``NullPlan``): which op faults, decided by a splitmix64 hash of
    (seed, op sequence) so every chaos run replays bit-identically;
  * ``io``       — the hardened host-block IO path (``HostIO``): retry /
    exponential backoff / per-op deadlines on a virtual ``Clock``, plus
    a ``CircuitBreaker`` that sheds the pool to degraded read-through
    under sustained failure;
  * ``snapshot`` — crash-consistent snapshot/restore of full engine
    state (layout arrays + ghost ring + correlation-window cursors),
    as an in-memory ``state_dict``, a versioned byte format
    (``pack``/``unpack``, magic ``C2QSNAP1``), and a ``SnapshotManager``
    riding the checkpoint store;
  * ``recovery`` — shard failover: a ``GhostJournal`` of per-shard key
    metadata rebuilds a lost shard's working set through the normal
    ghost-promotion path before it rejoins rebalancing;
  * ``journal``  — the append-only write-ahead delta journal
    (``ShardJournal``): CRC-per-record segments with monotonic LSNs,
    torn-tail truncating ``recover``, and base-snapshot compaction —
    every policy mutation is replayable bit-exactly;
  * ``replica``  — hot-standby replication over the journal
    (``ShardReplica`` / ``ShardReplicator``): bounded-staleness shard
    mirrors that ``promote()`` on shard loss instead of cold-rewarming,
    falling back to the ghost rewarm only past the lag threshold.

Layering: ``repro_torch.faults`` sits beside the policy engines (layer 2) and
may import only ``repro_torch.core`` and ``repro_torch.obs``; the pool/serving
layers above thread it through their swap paths (``BlockPool(faults=...)``,
``ServingEngine(faults=...)``).  Everything here is host-side numpy,
so chaos tests run anywhere (``SnapshotManager`` lazily pulls in the
checkpoint store only when used).
"""

from repro_torch.faults.io import (  # noqa: F401
    CircuitBreaker, Clock, HostIO, IOResult, RetryPolicy,
)
from repro_torch.faults.journal import (  # noqa: F401
    JournalCrash, JRecord, RecoveryResult, ReplayDivergence, ShardJournal,
    apply_record, recover,
)
from repro_torch.faults.plan import (  # noqa: F401
    CRASH, FAULT_NAMES, IO_DELAY, IO_ERROR, OP_ANY, OP_JOURNAL_APPEND,
    OP_SWAP_IN, OP_SWAP_OUT, PARTIAL_WRITE, SHARD_LOSS, Fault, FaultPlan,
    FaultSpec, NullPlan, splitmix64,
)
from repro_torch.faults.recovery import GhostJournal, failover  # noqa: F401
from repro_torch.faults.replica import (  # noqa: F401
    PromoteResult, ShardReplica, ShardReplicator,
)
from repro_torch.faults.snapshot import (  # noqa: F401
    MAGIC, VERSION, SnapshotManager, load_state_dict, pack,
    policy_from_snapshot, read_snapshot, state_dict, unpack,
    write_snapshot,
)

__all__ = [
    "CircuitBreaker", "Clock", "HostIO", "IOResult", "RetryPolicy",
    "CRASH", "FAULT_NAMES", "IO_DELAY", "IO_ERROR", "OP_ANY",
    "OP_JOURNAL_APPEND", "OP_SWAP_IN", "OP_SWAP_OUT", "PARTIAL_WRITE",
    "SHARD_LOSS", "Fault", "FaultPlan", "FaultSpec", "NullPlan",
    "splitmix64",
    "GhostJournal", "failover",
    "JournalCrash", "JRecord", "RecoveryResult", "ReplayDivergence",
    "ShardJournal", "apply_record", "recover",
    "PromoteResult", "ShardReplica", "ShardReplicator",
    "MAGIC", "VERSION", "SnapshotManager", "load_state_dict", "pack",
    "policy_from_snapshot", "read_snapshot", "state_dict", "unpack",
    "write_snapshot",
]

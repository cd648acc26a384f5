"""Shard-selection hash, shared by the concurrent service and the
engine's sharded-simulation mode (``core.torch_engine.sharded_replay``;
both must partition identically for the fidelity comparisons to be
apples-to-apples).  The port's own copy of ``repro/shardcache/
hashing.py``: the same multiplier and shifts.

Deliberately a *different* mix than ``ProdClock2QPlus._h`` (the intra-shard
bucket hash) so shard id and bucket id are uncorrelated — a shared hash
would funnel each shard's keys into a subset of its buckets.
"""

from __future__ import annotations

import numpy as np

_MASK64 = 0xFFFFFFFFFFFFFFFF
_MUL = 0xD1B54A32D192ED03  # pseudo-golden-ratio multiplier (distinct from _h's)


def shard_of(key: int, n_shards: int) -> int:
    """Shard index for a scalar key."""
    x = (key * _MUL) & _MASK64
    x ^= x >> 29
    return (x >> 16) % n_shards


def shard_of_np(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Vectorized ``shard_of`` for a key array (int64 in, int64 out)."""
    x = (np.asarray(keys, dtype=np.uint64) * np.uint64(_MUL))
    x ^= x >> np.uint64(29)
    return ((x >> np.uint64(16)) % np.uint64(n_shards)).astype(np.int64)

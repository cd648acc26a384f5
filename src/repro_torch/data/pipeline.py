"""Deterministic synthetic token pipeline with a Clock2Q+-managed shard-
index cache.

The port of ``repro.data.pipeline``, on the port's own
``core.prodcache.ProdClock2QPlus``: the same batches, bit for bit, and
the same index-cache hits and misses.

A large virtual dataset is split into shards; reading a global batch
requires resolving (shard -> index-block -> token offsets) through an
index cache — the literal metadata-cache use case of the paper (index
blocks pack many entries, so one batch touches each block several times
in a burst: correlated references).  Misses are counted as simulated host
I/O; the cache keeps the pipeline off the host-I/O critical path.

The stream is a pure function of (seed, step, host_id) — restart-safe
(resume from any step without replaying) and elastic (hosts can be
re-assigned disjoint slices).  Batches are numpy arrays; the trainer
moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.core.prodcache import ProdClock2QPlus


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1 << 14
    docs_per_shard: int = 128
    index_entries_per_block: int = 64   # fan-out of the index structure
    index_cache_blocks: int = 256
    seed: int = 0


class TokenPipeline:
    def __init__(self, dc: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.dc = dc
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.index_cache = ProdClock2QPlus(dc.index_cache_blocks)
        self.io_misses = 0
        self.lookups = 0

    # -- index resolution (through the Clock2Q+ cache) -------------------------
    def _resolve(self, shard: int, doc: int) -> int:
        """Resolve a (shard, doc) to its seed via the index cache.  The
        index block id = global doc number // fan-out (paper §2.3)."""
        gdoc = shard * self.dc.docs_per_shard + doc
        block = gdoc // self.dc.index_entries_per_block
        self.lookups += 1
        r = self.index_cache.access(block)
        if not r.hit:
            self.io_misses += 1  # simulated host/index I/O
        return gdoc

    def _doc_tokens(self, gdoc: int, n: int, rng_salt: int) -> np.ndarray:
        rng = np.random.default_rng((self.dc.seed, gdoc, rng_salt))
        # skewed unigram stream with local repetition structure
        base = rng.integers(0, self.dc.vocab, size=n)
        rep = rng.random(n) < 0.3
        base[1:][rep[1:]] = base[:-1][rep[1:]]
        return base.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Host-local slice of the global batch for ``step``."""
        dc = self.dc
        per_host = dc.global_batch // self.n_hosts
        rng = np.random.default_rng((dc.seed, step))
        # data loaders read shards from a sliding window (shuffle buffer):
        # index blocks are re-touched across adjacent batches — the
        # correlated-reference pattern the Clock2Q+ cache absorbs.
        window = max(8, dc.global_batch // 2)
        base = (step * max(1, window // 8)) % dc.n_shards
        shards = (base + rng.integers(0, window, size=dc.global_batch)) \
            % dc.n_shards
        docs = rng.integers(0, dc.docs_per_shard, size=dc.global_batch)
        lo = self.host_id * per_host
        toks = np.empty((per_host, dc.seq_len + 1), np.int32)
        for i in range(per_host):
            gdoc = self._resolve(int(shards[lo + i]), int(docs[lo + i]))
            toks[i] = self._doc_tokens(gdoc, dc.seq_len + 1, rng_salt=step)
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    @property
    def index_hit_ratio(self) -> float:
        return 1.0 - self.io_misses / max(1, self.lookups)

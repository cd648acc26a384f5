"""Multi-threaded replay harness — the paper's multi-CPU scalability
experiment (§5) against ``ShardedClock2QPlus`` (the port's own copy of
``repro/shardcache/replay.py``; ``lane_miss_ratio`` runs the port's lane
engine, on the card unless the caller passes ``device="cpu"``).

The trace is cut into contiguous batches; worker ``t`` of ``T`` owns
batches ``t, t+T, t+2T, ...`` (static round-robin: zero coordination on
the hot path, deterministic ownership).  Each worker replays its batches
with ``access_many``, so lock traffic is one acquisition per (batch,
shard) pair.  Reported throughput is wall-clock real: it includes lock
contention, shard imbalance, and Python dispatch — exactly what the
paper's scalability figure measures on real CPUs.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, List, Optional

import numpy as np

from repro_torch.core.prodcache import ProdClock2QPlus
from repro_torch.obs import EV_SNAPSHOT
from repro_torch.shardcache.sharded import ShardedClock2QPlus


def unsharded_miss_ratio(trace, capacity: int, **kw) -> float:
    """Serial ProdClock2QPlus replay — the baseline the sharded service's
    fidelity is measured against (benchmarks and parity tests share it)."""
    pol = ProdClock2QPlus(capacity, **kw)
    acc = pol.access
    for k in np.asarray(trace).tolist():
        acc(k)
    return pol.misses / max(1, pol.hits + pol.misses)


def lane_miss_ratio(trace, capacity: int, *, policy: str = "clock2q+",
                    universe: Optional[int] = None, device=None,
                    **kw) -> float:
    """The lane counterpart of ``unsharded_miss_ratio``: replay through
    the registered masked engine (``repro_torch.core.engine``, one kernel
    launch on ``device``) instead of the Python service.  Keys must be
    dense ids in [0, universe).  Used to cross-check the threaded service
    against the lane zoo for ANY registered policy, not just Clock2Q+."""
    from repro_torch.core.engine import get_engine

    trace = np.asarray(trace)
    if universe is None:
        universe = int(trace.max()) + 1
    eng = get_engine(policy)
    st = eng.init(capacity, int(universe), device=device, **kw)
    _, hits = eng.replay(st, np.asarray(trace, np.int32))
    h = int(hits.sum())
    return 1.0 - h / max(1, trace.size)


@dataclasses.dataclass
class ReplayReport:
    n_threads: int
    n_shards: int
    n_requests: int
    seconds: float
    hits: int

    @property
    def throughput(self) -> float:
        """Requests per wall-second."""
        return self.n_requests / max(1e-12, self.seconds)

    @property
    def us_per_access(self) -> float:
        return 1e6 * self.seconds / max(1, self.n_requests)

    @property
    def miss_ratio(self) -> float:
        return 1.0 - self.hits / max(1, self.n_requests)


def replay_threaded(cache: ShardedClock2QPlus, trace: np.ndarray,
                    n_threads: int = 1, batch_size: int = 1024,
                    obs=None) -> ReplayReport:
    """Replay ``trace`` through ``cache`` with ``n_threads`` workers.

    With an ``obs`` sink, each worker observes its per-batch dispatch
    latency into a thread-labeled histogram (per-thread instruments —
    lock-free, merged at snapshot time like per-shard registries)."""
    trace = np.asarray(trace, dtype=np.int64)
    n = trace.shape[0]
    batches = [trace[i:i + batch_size] for i in range(0, n, batch_size)]
    hit_counts = [0] * n_threads
    # per-thread instruments, created BEFORE the workers start (family
    # get-or-create is not thread-safe; binding is, by construction)
    hists = [None] * n_threads
    if obs is not None:
        fam = obs.histogram("replay_batch_seconds", ("thread",),
                            "access_many dispatch latency per batch")
        hists = [fam.labels(str(t)) for t in range(n_threads)]

    def worker(t: int) -> None:
        total = 0
        hist = hists[t]
        for b in range(t, len(batches), n_threads):
            if hist is None:
                total += int(cache.access_many(batches[b]).sum())
            else:
                tb = time.perf_counter()
                total += int(cache.access_many(batches[b]).sum())
                hist.observe(time.perf_counter() - tb)
        hit_counts[t] = total

    t0 = time.perf_counter()
    if n_threads == 1:
        worker(0)
    else:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    dt = time.perf_counter() - t0
    return ReplayReport(n_threads=n_threads, n_shards=cache.n_shards,
                        n_requests=n, seconds=dt, hits=sum(hit_counts))


def replay_store(cache: ShardedClock2QPlus, store, *, n_threads: int = 1,
                 batch_size: int = 1024, chunk_size: int = 1 << 20,
                 obs=None) -> ReplayReport:
    """Chunked state-carry replay of an on-disk trace (``TraceStore``,
    ndarray, or any iterable of key chunks) through a sharded cache.

    The cache is stateful, so feeding chunks sequentially IS the
    state-carry; and because ``access_many`` preserves per-shard request
    order regardless of batch boundaries (shards are independent),
    single-threaded streaming is bit-identical to a single-shot
    ``replay_threaded`` of the whole trace, for any chunk_size (asserted
    in the tests).  With ``n_threads > 1`` the harness's
    relaxed cross-batch ordering applies exactly as in the single-shot
    path: workers race on per-shard order across batches, so hit counts
    can drift by a few per million vs serial — a property of threaded
    replay itself, not of chunking.  Peak memory holds one chunk.

    With an ``obs`` sink, this function emits one periodic snapshot row per
    chunk — an ``EV_SNAPSHOT`` event (accesses, hits, running miss
    ratio) plus progress gauges — and the per-thread batch-latency
    histograms of ``replay_threaded``, so a long stream leaves a
    scrapeable progress trail instead of one end-of-run number."""
    from repro_torch.traceio.store import iter_chunks

    g_n = g_mr = None
    if obs is not None:
        g_n = obs.gauge("replay_accesses", (),
                        "accesses replayed so far").labels()
        g_mr = obs.gauge("replay_miss_ratio", (),
                         "running miss ratio").labels()
    hits = 0
    n = 0
    seconds = 0.0
    for chunk in iter_chunks(store, chunk_size):
        rep = replay_threaded(cache, chunk, n_threads=n_threads,
                              batch_size=batch_size, obs=obs)
        hits += rep.hits
        n += rep.n_requests
        seconds += rep.seconds
        if obs is not None:
            mr = 1.0 - hits / max(1, n)
            g_n.set(float(n))
            g_mr.set(mr)
            obs.emit(EV_SNAPSHOT, a=n, b=hits, c=mr)
    return ReplayReport(n_threads=n_threads, n_shards=cache.n_shards,
                        n_requests=n, seconds=seconds, hits=hits)


def scalability_sweep(trace: np.ndarray, capacity: int, *,
                      n_shards: int = 8,
                      threads: Iterable[int] = (1, 2, 4, 8),
                      batch_size: int = 1024,
                      cache_kw: Optional[dict] = None) -> List[ReplayReport]:
    """Fresh cache per thread count (equal-work comparison), matching the
    paper's per-core-count runs."""
    out = []
    for t in threads:
        cache = ShardedClock2QPlus(capacity, n_shards=n_shards,
                                   **(cache_kw or {}))
        out.append(replay_threaded(cache, trace, n_threads=t,
                                   batch_size=batch_size))
    return out

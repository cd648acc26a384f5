"""Replay drivers on the PyTorch engine: the port of
``repro/core/jax_engine.py``'s ``init_state``, ``replay_np``,
``replay_store``, ``replay_batch`` and the sharded simulation
(``sharded_replay``, ``sharded_replay_np``).

The state machines live in ``repro_torch.core.engine``; on CUDA every
replay here runs its family's Hopper kernel (``cache_sim``,
``s3fifo_sim`` or ``simple_sim``).  Keys must be int ids in
``[0, universe)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (
    get_engine, grid_init, replay, replay_chunked,
)


def init_state(policy: str, capacity: int, universe: int, device=None,
               **kw) -> Dict[str, torch.Tensor]:
    """One-lane state for ``policy`` at ``capacity`` on ``device``."""
    return get_engine(policy).init(capacity, int(universe), device=device,
                                   **kw)


def replay_np(policy: str, trace: np.ndarray, capacity: int,
              universe: int | None = None, device=None,
              **kw) -> Tuple[int, float]:
    """Host-side convenience wrapper returning a hit count + miss ratio."""
    trace = np.asarray(trace)
    if universe is None:
        universe = int(trace.max()) + 1
    st = init_state(policy, capacity, int(universe), device=device, **kw)
    _, hits = replay(policy, st, trace)
    h = int(hits.sum())
    return h, 1.0 - h / max(1, len(trace))


def replay_batch(policy: str, states: Dict[str, torch.Tensor],
                 traces) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One trace per lane: ``traces`` (L, T) against the L lanes of
    ``states`` (advanced in place).  Returns ``(states, hits (L, T))``."""
    if not isinstance(traces, torch.Tensor):
        traces = np.asarray(traces)
    if traces.ndim != 2:
        raise ValueError(f"replay_batch takes one trace per lane, (L, T); "
                         f"got shape {tuple(traces.shape)}")
    return replay(policy, states, traces)


def replay_store(policy: str, store, capacity: int,
                 universe: int | None = None,
                 chunk_size: int = 1 << 20, obs=None, device=None,
                 **kw) -> Tuple[int, float]:
    """``replay_np`` for an on-disk trace: stream a ``TraceStore`` (or
    anything ``repro_torch.traceio.iter_chunks`` accepts) in
    ``chunk_size`` pieces, one launch a chunk.  Returns (hit count, miss
    ratio), bit-identical to loading the whole trace and calling
    ``replay_np``.

    With an ``obs`` sink, each chunk leaves a periodic snapshot row:
    progress gauges (accesses so far, running miss ratio) plus one
    ``EV_SNAPSHOT`` event, via the engine's ``on_chunk`` hook — the
    engine package itself stays telemetry-free."""
    from repro_torch.traceio.store import TraceStore, iter_chunks

    if universe is None:
        if isinstance(store, TraceStore):
            universe = store.universe(chunk_size)
        elif isinstance(store, np.ndarray):
            universe = int(store.max()) + 1
        else:
            raise ValueError("pass universe= explicitly when streaming "
                             "from a one-shot chunk iterable")
    if obs is not None:
        from repro_torch.obs import EV_SNAPSHOT
        g_n = obs.gauge("replay_accesses", (),
                        "accesses replayed so far").labels()
        g_mr = obs.gauge("replay_miss_ratio", (),
                         "running miss ratio").labels()

        def on_chunk(n_done, hits_done):
            mr = 1.0 - hits_done / max(1, n_done)
            g_n.set(float(n_done))
            g_mr.set(mr)
            obs.emit(EV_SNAPSHOT, a=n_done, b=hits_done, c=mr)

        kw["on_chunk"] = on_chunk
    h, n, _ = replay_chunked(policy, iter_chunks(store, chunk_size),
                             capacity, int(universe), device=device, **kw)
    return h, 1.0 - h / max(1, n)


# =============================================================================
# sharded simulation (repro_torch.shardcache's partitioning, as lanes)
# =============================================================================

def sharded_replay(policy: str, trace: np.ndarray, capacity: int,
                   n_shards: int, universe: int | None = None, device=None,
                   **kw) -> np.ndarray:
    """Simulate the hash-sharded service: partition ``trace`` by the
    shardcache key hash into ``n_shards`` subtraces, replay them as the
    lanes of one ``replay_batch`` launch at ``round(capacity / n_shards)``
    each, and merge the per-lane hit arrays back into request order.

    Returns a bool hit array aligned with ``trace``.  Lanes are (L, T)
    rows padded to the longest shard with the no-op key -1, after every
    real access in their lane: real hits cannot change, and the kernel
    does no work for the padding.

    Lanes of one launch share one state layout, so every shard gets the
    SAME capacity ``round(capacity / n_shards)`` — the total simulated
    capacity can differ from ``capacity`` by up to ``n_shards // 2``
    slots in either direction (``ShardedClock2QPlus`` apportions the
    remainder instead).  Pass a capacity divisible by ``n_shards`` for
    an exact equal-total comparison with the unsharded baseline.
    """
    from repro_torch.shardcache.hashing import shard_of_np

    trace = np.asarray(trace)
    if universe is None:
        universe = int(trace.max()) + 1
    cap_shard = int(round(capacity / n_shards))
    if cap_shard < 2:
        raise ValueError(f"capacity {capacity} too small for {n_shards} shards")
    sid = shard_of_np(trace, n_shards)
    idx = [np.nonzero(sid == s)[0] for s in range(n_shards)]
    lane_len = max((len(ix) for ix in idx), default=1) or 1
    lanes = np.full((n_shards, lane_len), -1, dtype=np.int32)
    for s, ix in enumerate(idx):
        lanes[s, :len(ix)] = trace[ix]
    eng = get_engine(policy)
    states = grid_init([eng.config(cap_shard, **kw)] * n_shards,
                       int(universe), device=device)
    _, hits = replay_batch(policy, states, lanes)
    hits = hits.cpu().numpy()
    merged = np.zeros(trace.shape[0], dtype=bool)
    for s, ix in enumerate(idx):
        merged[ix] = hits[s, :len(ix)]
    return merged


def sharded_replay_np(policy: str, trace: np.ndarray, capacity: int,
                      n_shards: int, universe: int | None = None,
                      device=None, **kw) -> Tuple[int, float]:
    """Host-side convenience wrapper: (hit count, miss ratio)."""
    merged = sharded_replay(policy, trace, capacity, n_shards,
                            universe=universe, device=device, **kw)
    h = int(merged.sum())
    return h, 1.0 - h / max(1, merged.shape[0])

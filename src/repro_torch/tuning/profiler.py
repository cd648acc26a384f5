"""Spatially-sampled mini-simulation MRC profiler (the SHARDS idea).

The port's own copy of ``repro/tuning/profiler.py``: the same hash, the
same sample, and every sweep one ``sweep_grid`` call on ``device`` (one
kernel launch a step family on the card unless the caller passes
``device="cpu"``).

Exact MRC estimation replays every request; continuous online profiling
can't afford that.  Instead, sample the KEY SPACE with a hash: a key is
in the sample iff ``mix64(key) mod 2**rate_shift == 0``, so roughly a
``1/2**rate_shift`` fraction of the stream survives — and, crucially,
every surviving key keeps its FULL access sequence (spatial sampling
preserves per-key temporal patterns, unlike request subsampling).  The
sampled stream is then simulated at capacities scaled by the sampling
rate; the resulting miss ratios estimate the full-trace miss ratios at
the original capacities.

The mix is a splitmix64 finalizer — deliberately distinct from both the
shard-selection hash (``shardcache.hashing``) and the bucket hash
(``ProdClock2QPlus._h``) so the sample is uncorrelated with shard or
bucket placement.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.tuning.sweep import (
    SweepConfig, make_grid, surface_shape, sweep_grid,
)

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def mix64(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in/out)."""
    z = np.asarray(keys).astype(np.uint64)
    z = (z + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
    return z ^ (z >> np.uint64(31))


def sample_mask(keys: np.ndarray, rate_shift: int = 6) -> np.ndarray:
    """True for keys in the spatial sample (~``2**-rate_shift`` of the
    key space; ``rate_shift=0`` keeps everything)."""
    if rate_shift <= 0:
        return np.ones(np.asarray(keys).shape, dtype=bool)
    return (mix64(keys) & np.uint64((1 << rate_shift) - 1)) == 0


def sample_trace(trace: np.ndarray, rate_shift: int = 6) -> np.ndarray:
    """The subsequence of ``trace`` whose keys fall in the sample, in
    request order (~1/64 of the stream at the default shift)."""
    trace = np.asarray(trace)
    return trace[sample_mask(trace, rate_shift)]


def scale_capacity(capacity: int, rate_shift: int, floor: int = 4) -> int:
    """Cache size for the mini-simulation: capacity x sampling rate."""
    return max(floor, int(round(capacity / (1 << rate_shift))))


def scaled_configs(configs: Sequence[SweepConfig],
                   rate_shift: int) -> list:
    # replace() keeps every other knob — including policy and bits — so
    # the profiler works for any registered lane policy, not just
    # clock2q+
    return [dataclasses.replace(
        c, capacity=scale_capacity(c.capacity, rate_shift))
        for c in configs]


def estimate_sweep(trace: np.ndarray, configs: Sequence[SweepConfig],
                   rate_shift: int = 6, device=None) -> np.ndarray:
    """Estimated full-trace miss ratio for each (full-scale) config, from
    one batched mini-simulation of the sampled stream."""
    sampled = sample_trace(trace, rate_shift)
    if sampled.size == 0:
        return np.full(len(configs), np.nan)
    return sweep_grid(sampled, scaled_configs(configs, rate_shift),
                      device=device)


def sample_stream(chunks, rate_shift: int = 6) -> np.ndarray:
    """Spatial sample of a CHUNKED stream: the mask is a pure per-key
    function, so sampling each chunk and concatenating is bit-identical
    to ``sample_trace`` of the concatenated trace — this is what makes
    SHARDS-style profiling streamable.  The returned sample (~1/2**shift
    of the stream) is the only thing held in memory."""
    parts = [c[sample_mask(c, rate_shift)]
             for c in (np.asarray(c) for c in chunks)]
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(parts)


def estimate_sweep_stream(chunks, configs: Sequence[SweepConfig],
                          rate_shift: int = 6, device=None) -> np.ndarray:
    """``estimate_sweep`` over a chunk iterable (e.g. ``TraceStore.
    chunks()``): bounded memory in the trace length, bit-identical to
    the whole-trace estimate."""
    sampled = sample_stream(chunks, rate_shift)
    if sampled.size == 0:
        return np.full(len(configs), np.nan)
    return sweep_grid(sampled, scaled_configs(configs, rate_shift),
                      device=device)


def estimate_sweep_store(store, configs: Sequence[SweepConfig],
                         rate_shift: int = 6,
                         chunk_size: int = 1 << 20,
                         device=None) -> np.ndarray:
    """Sampled sweep straight off an on-disk trace (TraceStore/ndarray)."""
    from repro_torch.traceio.store import iter_chunks

    return estimate_sweep_stream(iter_chunks(store, chunk_size), configs,
                                 rate_shift, device=device)


def estimate_mrc(trace: np.ndarray, capacities: Sequence[int],
                 window_fracs: Sequence[float] = (0.5,),
                 rate_shift: int = 6, device=None, **kw) -> np.ndarray:
    """Sampled MRC estimate, shaped like ``sweep.mrc_grid``'s output."""
    grid = make_grid(capacities, window_fracs, **kw)
    est = estimate_sweep(trace, grid, rate_shift, device=device)
    return est.reshape(surface_shape(len(grid), capacities, window_fracs))

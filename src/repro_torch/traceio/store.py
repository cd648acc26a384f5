"""``TraceStore`` — mmap-backed streaming access to an on-disk trace.

The port's own copy of ``repro/traceio/store.py``.  The store never
loads the trace into RAM: the ``oracle`` (structured 24-byte records)
and ``npy`` (raw int64 keys) formats are memory-mapped, and ``chunks()``
materializes one fixed-size int64 chunk at a time, so a replay's peak
host memory is bounded by the chunk size no matter how long the trace
is.  CSV/npz traces have no random-access record layout; convert them
once with ``repro_torch.traceio.convert`` and stream the result.

``iter_chunks`` is the shared chunk-source adapter used by every chunked
replay: it accepts an in-memory array, a ``TraceStore``, or any
iterable of key arrays, so callers write one loop for all three.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from repro_torch.traceio.formats import ORACLE_DTYPE, sniff_format

DEFAULT_CHUNK = 1 << 20  # 1M accesses / 8 MiB of int64 keys per chunk


class TraceStore:
    """Memory-mapped on-disk trace with bounded-memory chunk iteration."""

    def __init__(self, path: str | os.PathLike, fmt: str | None = None):
        self.path = str(path)
        self.fmt = sniff_format(path, fmt)
        if self.fmt == "oracle":
            if os.path.getsize(self.path) == 0:  # mmap rejects empty files
                self._rec = None
                self._keys = np.empty(0, dtype=np.int64)
            else:
                self._rec = np.memmap(self.path, dtype=ORACLE_DTYPE, mode="r")
                self._keys = self._rec["obj_id"]  # strided view on the mmap
        elif self.fmt == "npy":
            self._rec = None
            self._keys = np.load(self.path, mmap_mode="r")
        else:
            raise ValueError(
                f"TraceStore streams 'oracle' or 'npy' traces; {self.fmt!r} "
                "has no mmap-able record layout — convert it first "
                "(python -m repro_torch.traceio.convert)")

    def __len__(self) -> int:
        return int(self._keys.shape[0])

    def chunk(self, start: int, stop: int) -> np.ndarray:
        """Materialize ``[start, stop)`` as an int64 array (a copy — the
        only bytes this touches are the chunk's own pages)."""
        return np.asarray(self._keys[start:stop]).astype(np.int64)

    def chunks(self, chunk_size: int = DEFAULT_CHUNK) -> Iterator[np.ndarray]:
        """Yield consecutive fixed-size key chunks (last one may be short).
        Concatenating the yields reproduces the trace exactly."""
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        for start in range(0, len(self), chunk_size):
            yield self.chunk(start, min(start + chunk_size, len(self)))

    def keys(self) -> np.ndarray:
        """Whole-trace load (int64).  Defeats the bounded-memory point —
        for tests/small traces only."""
        return self.chunk(0, len(self))

    def max_key(self, chunk_size: int = DEFAULT_CHUNK) -> int:
        """Streaming max over the key column (bounded memory)."""
        best = -1
        for c in self.chunks(chunk_size):
            if c.size:
                best = max(best, int(c.max()))
        return best

    def universe(self, chunk_size: int = DEFAULT_CHUNK) -> int:
        """Dense-id universe bound: max key + 1 (0 for an empty trace)."""
        return self.max_key(chunk_size) + 1


def iter_chunks(source, chunk_size: int = DEFAULT_CHUNK
                ) -> Iterator[np.ndarray]:
    """Uniform chunk iteration over an ndarray, a TraceStore, or any
    iterable of key arrays.  Arrays/stores are cut to ``chunk_size``;
    pre-chunked iterables are passed through as-is."""
    if isinstance(source, TraceStore):
        yield from source.chunks(chunk_size)
    elif isinstance(source, np.ndarray):
        src = source.ravel()
        for start in range(0, src.size, chunk_size):
            yield src[start:start + chunk_size]
    elif isinstance(source, Iterable):
        for c in source:
            yield np.asarray(c).ravel()
    else:
        raise TypeError(f"cannot iterate trace chunks from {type(source)!r}")

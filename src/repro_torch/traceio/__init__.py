"""Trace I/O + streaming subsystem (the port of ``repro.traceio``).

On-disk trace formats (the libCacheSim-compatible ``oracleGeneral``
binary layout, CSV, npz, raw npy), a ``TraceStore`` that mmaps a trace
and yields fixed-size chunks so replay runs in bounded memory regardless
of trace length, and a ``convert`` CLI (``python -m
repro_torch.traceio.convert``) that translates between formats and
materializes any registered scenario (``repro_torch.core.traces.
SCENARIOS``) to disk.

Chunked *state-carry* replays live next to their engines
(``core.torch_engine.replay_chunked``/``replay_store``,
``shardcache.replay.replay_store``, ``tuning.profiler.
estimate_sweep_stream``, ``ProdClock2QPlus.replay``); each is
bit-identical to its single-shot path.
"""

from repro_torch.traceio.formats import (  # noqa: F401
    ORACLE_DTYPE, load_trace, relabel, save_trace, sniff_format,
    read_csv, read_npy, read_npz, read_oracle,
    write_csv, write_npy, write_npz, write_oracle,
)
from repro_torch.traceio.store import TraceStore, iter_chunks  # noqa: F401

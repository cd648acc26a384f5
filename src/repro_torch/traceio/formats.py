"""On-disk trace formats: oracleGeneral (binary), CSV, npz, raw npy.

The port's own copy of ``repro/traceio/formats.py``: the same records,
byte for byte.

``oracleGeneral`` is the libCacheSim binary layout — the lingua franca of
the cache-research tooling the paper's evaluation sits on — so real
production traces (CloudPhysics/Meta/Tencent releases) drop straight in:
packed little-endian 24-byte records

    uint32 real_time | uint64 obj_id | uint32 obj_size | int64 next_access_vtime

where ``next_access_vtime`` is the virtual time (request index) of the
key's next access, or -1 if never re-referenced (the "oracle" used by
Belady-family baselines).  The writer computes it in one vectorized
stable-argsort pass.

Readers return the int64 KEY column only — replacement decisions depend
only on key identity, and that is all the replay engines consume.
Writers accept optional ``times``/``sizes`` arrays (synthesizing
``arange``/1 otherwise), but a format conversion rewrites just the keys:
real timestamps and object sizes are NOT carried through ``convert``.
``load_trace``/``save_trace`` dispatch on an explicit format name or the
file suffix.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# packed little-endian, itemsize 24 — matches libCacheSim's oracleGeneral
ORACLE_DTYPE = np.dtype([
    ("time", "<u4"),
    ("obj_id", "<u8"),
    ("size", "<u4"),
    ("next_access_vtime", "<i8"),
])
assert ORACLE_DTYPE.itemsize == 24

CSV_HEADER = "time,obj_id,obj_size"

_SUFFIXES = {
    ".bin": "oracle", ".oracle": "oracle", ".oraclegeneral": "oracle",
    ".csv": "csv", ".npz": "npz", ".npy": "npy",
}


def sniff_format(path: str | os.PathLike, fmt: str | None = None) -> str:
    """Resolve a format name: explicit ``fmt`` wins, else file suffix."""
    if fmt:
        fmt = fmt.lower()
        if fmt not in ("oracle", "csv", "npz", "npy"):
            raise ValueError(f"unknown trace format {fmt!r}")
        return fmt
    suffix = Path(path).suffix.lower()
    if suffix not in _SUFFIXES:
        raise ValueError(
            f"cannot infer trace format from suffix {suffix!r} "
            f"(known: {sorted(_SUFFIXES)}); pass an explicit format")
    return _SUFFIXES[suffix]


def next_access_vtime(keys: np.ndarray) -> np.ndarray:
    """next_access_vtime[i] = index of the next access to keys[i] after i,
    or -1 (vectorized: stable sort groups each key's accesses in request
    order, so its successor within the group IS the next access)."""
    keys = np.asarray(keys)
    n = keys.size
    nxt = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return nxt
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    same = sk[1:] == sk[:-1]
    nxt[order[:-1][same]] = order[1:][same]
    return nxt


def relabel(trace: np.ndarray) -> "tuple[np.ndarray, int]":
    """Dense relabelling: raw (possibly hashed 64-bit) keys ->
    ``[0, n_unique)`` int32 ids, preserving request order.  Replacement
    is label-invariant, so miss ratios are unchanged; the dense-table
    replay engines require it.  The single implementation shared by
    ``repro_torch.tuning.sweep.relabel`` and the convert CLI's
    ``--relabel``."""
    uniq, inv = np.unique(np.asarray(trace), return_inverse=True)
    return inv.astype(np.int32), int(uniq.size)


def _as_keys(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.int64).ravel()
    if keys.size and keys.min() < 0:
        raise ValueError("trace keys must be non-negative")
    return keys


# -- oracleGeneral ------------------------------------------------------------

def write_oracle(path: str | os.PathLike, keys: np.ndarray,
                 times: np.ndarray | None = None,
                 sizes: np.ndarray | None = None) -> None:
    """Write ``keys`` as oracleGeneral records (``next_access_vtime``
    computed here)."""
    keys = _as_keys(keys)
    rec = np.empty(keys.size, dtype=ORACLE_DTYPE)
    rec["time"] = np.arange(keys.size, dtype=np.uint32) if times is None \
        else np.asarray(times, dtype=np.uint32)
    rec["obj_id"] = keys.astype(np.uint64)
    rec["size"] = 1 if sizes is None else np.asarray(sizes, dtype=np.uint32)
    rec["next_access_vtime"] = next_access_vtime(keys)
    rec.tofile(str(path))


def read_oracle(path: str | os.PathLike) -> np.ndarray:
    """Whole-file load of the key column (stream with TraceStore instead
    for traces that should not live in RAM)."""
    rec = np.fromfile(str(path), dtype=ORACLE_DTYPE)
    return rec["obj_id"].astype(np.int64)


# -- CSV ----------------------------------------------------------------------

def write_csv(path: str | os.PathLike, keys: np.ndarray,
              times: np.ndarray | None = None,
              sizes: np.ndarray | None = None) -> None:
    """Write ``time,obj_id,obj_size`` rows under a header."""
    keys = _as_keys(keys)
    t = np.arange(keys.size, dtype=np.int64) if times is None \
        else np.asarray(times, dtype=np.int64)
    s = np.ones(keys.size, dtype=np.int64) if sizes is None \
        else np.asarray(sizes, dtype=np.int64)
    cols = np.stack([t, keys, s], axis=1)
    np.savetxt(str(path), cols, fmt="%d", delimiter=",",
               header=CSV_HEADER, comments="")


def read_csv(path: str | os.PathLike) -> np.ndarray:
    """Reads ``time,obj_id,obj_size`` (with or without header) or bare
    one-key-per-line files."""
    with open(path) as f:
        first = f.readline()
        skip = 1 if any(c.isalpha() for c in first) else 0
        has_data = bool(first.strip()) and skip == 0
        if not has_data:  # scan past blank lines (loadtxt skips them too)
            has_data = any(line.strip() for line in f)
    if not has_data:  # empty / header-only file: loadtxt would warn
        return np.empty(0, dtype=np.int64)
    data = np.loadtxt(str(path), delimiter=",", skiprows=skip,
                      dtype=np.int64, ndmin=2)
    if data.size == 0:
        return np.empty(0, dtype=np.int64)
    return data[:, 1] if data.shape[1] >= 2 else data[:, 0]


# -- npz / npy ----------------------------------------------------------------

def write_npz(path: str | os.PathLike, keys: np.ndarray,
              times: np.ndarray | None = None,
              sizes: np.ndarray | None = None) -> None:
    """Write a compressed npz with a ``keys`` array (and ``times``/
    ``sizes`` where given)."""
    arrays = {"keys": _as_keys(keys)}
    if times is not None:
        arrays["times"] = np.asarray(times, dtype=np.int64)
    if sizes is not None:
        arrays["sizes"] = np.asarray(sizes, dtype=np.int64)
    np.savez_compressed(str(path), **arrays)


def read_npz(path: str | os.PathLike) -> np.ndarray:
    """The ``keys`` array of an npz trace, int64."""
    with np.load(str(path)) as z:
        if "keys" not in z:
            raise ValueError(f"{path}: npz trace must contain a 'keys' array")
        return z["keys"].astype(np.int64)


def write_npy(path: str | os.PathLike, keys: np.ndarray, **_ignored) -> None:
    """Write the keys as a raw int64 npy array."""
    np.save(str(path), _as_keys(keys))


def read_npy(path: str | os.PathLike) -> np.ndarray:
    """An npy trace's keys, int64."""
    return np.load(str(path)).astype(np.int64)


# -- dispatch -----------------------------------------------------------------

_READERS = {"oracle": read_oracle, "csv": read_csv,
            "npz": read_npz, "npy": read_npy}
_WRITERS = {"oracle": write_oracle, "csv": write_csv,
            "npz": write_npz, "npy": write_npy}


def load_trace(path: str | os.PathLike, fmt: str | None = None) -> np.ndarray:
    """Whole-file load -> int64 key array (format from suffix unless given)."""
    return _READERS[sniff_format(path, fmt)](path)


def save_trace(path: str | os.PathLike, keys: np.ndarray,
               fmt: str | None = None, times: np.ndarray | None = None,
               sizes: np.ndarray | None = None) -> None:
    """Write ``keys`` in the format named by ``fmt`` or the suffix."""
    _WRITERS[sniff_format(path, fmt)](path, keys, times=times, sizes=sizes)

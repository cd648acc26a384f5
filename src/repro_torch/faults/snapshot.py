"""Crash-consistent snapshot/restore of the full replacement-engine state.

The port's own copy of ``repro/faults/snapshot.py``: ``pack`` writes the
reference's bytes (``tests/test_torch_faults.py`` holds it to both
goldens), so a snapshot taken by either package restores in the other.

A snapshot captures EVERYTHING the paper's engine carries between
accesses — the layout arrays (keys, ref/dirty/pin/DOING-IO bits, payload
handles, both hash tables), the ghost ring with its hash and cursor, the
correlation-window state (per-entry insertion sequence numbers + the
global ``small_seq`` counter), the clock hand / small cursor, the
live-resize migration state, and the free payload-handle stack — so a
restored cache resumes a replay **hit for hit** against the uninjured
run (the chaos suite asserts this).  Telemetry (obs counters/rings) is
deliberately NOT state: a warm-restarted process starts fresh counters.

Three layers, lowest first:

  * ``state_dict(cache)`` / ``load_state_dict(cache, d)`` — plain-data
    capture/restore for ``ProdClock2QPlus`` and (duck-typed, captured
    under every shard lock) ``ShardedClock2QPlus``.
  * ``pack(d)`` / ``unpack(b)`` — the versioned on-disk byte format
    (documented in docs/operations.md, byte-pinned by
    ``tests/test_faults.py::test_snapshot_golden_bytes``), plus
    ``write_snapshot``/``read_snapshot`` single-file atomic IO.
  * ``SnapshotManager`` — retention/atomic-commit/digest-verified store
    built on ``repro_torch.checkpoint.ckpt.CheckpointManager`` (the snapshot
    becomes a pytree checkpoint; version + scalars ride as a packed
    meta leaf), for periodic background snapshots of a serving cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import EV_RESTORE

MAGIC = b"C2QSNAP1"
VERSION = 2   # newest format this module can read/write
_V1 = 1       # plain engine-state snapshots (no journal linkage)

# meta keys restored as plain attributes of a ProdClock2QPlus
_PROD_SCALARS = (
    "capacity", "small_cap", "main_cap", "ghost_cap", "window",
    "spos", "hand", "gpos", "small_seq",
    "n_buckets", "g_n_buckets", "old_n_buckets",
    "max_capacity", "max_small", "max_main", "max_ghost",
    "skip_limit", "dirty_scan_limit", "track_io", "shard_id",
)
_PROD_ARRAYS = ("key", "ref", "dirty", "pin", "io", "block", "seq",
                "buckets", "nxt", "gkey", "gbuckets", "gnxt")


def _is_sharded(cache) -> bool:
    return hasattr(cache, "shards")


# -- capture -------------------------------------------------------------------

def _prod_state(pol) -> Dict:
    meta = {k: getattr(pol, k) for k in _PROD_SCALARS}
    meta.update(version=_V1, kind="prod",
                rehash_cursor=pol._rehash_cursor,
                small_frac=pol._small_frac, ghost_frac=pol._ghost_frac,
                window_frac=pol._window_frac)
    arrays = {name: getattr(pol, name).copy() for name in _PROD_ARRAYS}
    arrays["free_blocks"] = np.asarray(pol.free_blocks, dtype=np.int64)
    if pol.old_buckets is not None:
        arrays["old_buckets"] = pol.old_buckets.copy()
    return {"meta": meta, "arrays": arrays}


def state_dict(cache, journal_meta=None) -> Dict:
    """Point-in-time plain-data state of a cache.

    For a sharded service every shard lock is held while its shard is
    captured AND the facade scalars are read, so the snapshot is a
    crash-consistent cut: no access can interleave with the capture.

    ``journal_meta=(epoch, lsn)`` stamps the snapshot as a v2 journal
    *base*: the meta additionally records the write-ahead journal epoch
    and the last LSN folded into this state, so recovery knows exactly
    where journal replay must resume (``repro_torch.faults.journal``).
    Without it the output is a plain v1 snapshot, byte-identical to what
    earlier readers pin.
    """
    d = _prod_state(cache) if not _is_sharded(cache) else None
    if d is not None:
        if journal_meta is not None:
            epoch, lsn = journal_meta
            d["meta"].update(version=VERSION, journal_epoch=int(epoch),
                             journal_lsn=int(lsn))
        return d
    meta = {"version": _V1, "kind": "sharded",
            "n_shards": cache.n_shards, "capacity": cache.capacity,
            "max_capacity": cache.max_capacity,
            "shard_max": cache.shard_max, "stride": cache.stride,
            "miss_mark": list(cache._miss_mark),
            "resizing": sorted(cache._resizing)}
    arrays: Dict[str, np.ndarray] = {}
    for i, (sh, lk) in enumerate(zip(cache.shards, cache.locks)):
        with lk:
            sub = _prod_state(sh)
        meta[f"s{i}"] = sub["meta"]
        for name, arr in sub["arrays"].items():
            arrays[f"s{i}/{name}"] = arr
    if journal_meta is not None:
        epoch, lsn = journal_meta
        meta.update(version=VERSION, journal_epoch=int(epoch),
                    journal_lsn=int(lsn))
    return {"meta": meta, "arrays": arrays}


# -- restore -------------------------------------------------------------------

def _load_prod(pol, meta: Dict, arrays: Dict[str, np.ndarray]) -> None:
    if (meta["max_small"], meta["max_main"], meta["max_ghost"]) != \
            (pol.max_small, pol.max_main, pol.max_ghost):
        raise ValueError(
            "snapshot preallocation (max_small/max_main/max_ghost="
            f"{meta['max_small']}/{meta['max_main']}/{meta['max_ghost']}) "
            f"does not match the target cache "
            f"({pol.max_small}/{pol.max_main}/{pol.max_ghost}); construct "
            "the target via policy_from_snapshot() for a cold restore")
    for name in _PROD_ARRAYS:
        src = arrays[name]
        dst = getattr(pol, name)
        if dst.shape == src.shape:
            np.copyto(dst, src)
        else:  # the resident hash array is re-sized by live resizes
            setattr(pol, name, src.copy())
    pol.free_blocks = arrays["free_blocks"].astype(np.int64).tolist()
    ob = arrays.get("old_buckets")
    pol.old_buckets = None if ob is None else ob.copy()
    for k in ("capacity", "small_cap", "main_cap", "ghost_cap", "window",
              "spos", "hand", "gpos", "small_seq", "n_buckets",
              "g_n_buckets", "old_n_buckets", "dirty_scan_limit",
              "track_io", "shard_id"):
        setattr(pol, k, meta[k])
    pol.skip_limit = meta["skip_limit"]
    pol._rehash_cursor = meta["rehash_cursor"]
    pol._small_frac = meta["small_frac"]
    pol._ghost_frac = meta["ghost_frac"]
    pol._window_frac = meta["window_frac"]
    g = pol._g_cap
    g["total"].value = float(pol.capacity)
    g["small"].value = float(pol.small_cap)
    g["main"].value = float(pol.main_cap)
    g["ghost"].value = float(pol.ghost_cap)
    g["window"].value = float(pol.window)


def load_state_dict(cache, d: Dict, step: int = -1) -> None:
    """Restore a ``state_dict`` into a compatibly-preallocated cache.

    The target must have the same preallocated maxima (and, for a
    sharded service, the same shard count) as the snapshot source;
    logical capacities, cursors, and every entry's residency state are
    overwritten wholesale.  Emits ``EV_RESTORE`` on the cache's sink.
    """
    meta = d["meta"]
    if meta.get("version", 0) > VERSION:
        raise ValueError(f"snapshot version {meta['version']} is newer "
                         f"than this reader (max {VERSION})")
    if _is_sharded(cache):
        if meta["kind"] != "sharded":
            raise ValueError("snapshot is not of a sharded cache")
        if meta["n_shards"] != cache.n_shards:
            raise ValueError(f"snapshot has {meta['n_shards']} shards, "
                             f"target has {cache.n_shards}")
        for i, (sh, lk) in enumerate(zip(cache.shards, cache.locks)):
            sub = {n[len(f"s{i}/"):]: a for n, a in d["arrays"].items()
                   if n.startswith(f"s{i}/")}
            with lk:
                _load_prod(sh, meta[f"s{i}"], sub)
        cache.capacity = meta["capacity"]
        cache._miss_mark = list(meta["miss_mark"])
        with cache._resize_lock:
            cache._resizing = set(meta["resizing"])
    else:
        if meta["kind"] != "prod":
            raise ValueError("snapshot is not of a single-instance cache")
        _load_prod(cache, meta, d["arrays"])
    obs = getattr(cache, "obs", None)
    if obs is not None and obs.ring.enabled:
        n = sum(len(s) for s in cache.shards) if _is_sharded(cache) \
            else len(cache)
        obs.emit(EV_RESTORE, a=step, b=n)


def policy_from_snapshot(d: Dict, obs=None):
    """Cold restore: construct a fresh ``ProdClock2QPlus`` shaped like
    the snapshot (same preallocated maxima), then load the state.
    ``obs`` overrides the new instance's sink (a ``NullSink`` keeps a
    replica mirror telemetry-free)."""
    from repro_torch.core.prodcache import ProdClock2QPlus

    meta = d["meta"]
    if meta["kind"] != "prod":
        raise ValueError("policy_from_snapshot restores single instances; "
                         "build the sharded service and use "
                         "load_state_dict")
    mc = meta["max_capacity"]
    pol = ProdClock2QPlus(
        meta["capacity"], small_frac=meta["small_frac"],
        ghost_frac=meta["ghost_frac"], window_frac=meta["window_frac"],
        skip_limit=meta["skip_limit"],
        dirty_scan_limit=meta["dirty_scan_limit"], max_capacity=mc,
        track_io=bool(meta["track_io"]),
        max_small_frac=meta["max_small"] / mc,
        max_ghost_frac=meta["max_ghost"] / mc,
        min_small_frac=max(0.0, mc - meta["max_main"]) / mc,
        shard_id=meta["shard_id"], obs=obs)
    load_state_dict(pol, d)
    return pol


# -- the on-disk byte format (v1/v2) -------------------------------------------
#
#   offset  size  field
#        0     8  magic  b"C2QSNAP1"
#        8     4  u32 version (1 or 2), little-endian (as are all ints below)
#       12     4  u32 n_arrays
#       16     8  u64 meta_len
#       24     .  meta: canonical JSON (sorted keys, compact separators),
#                 UTF-8 — the scalar state + per-shard sub-metas
#        .     .  n_arrays sections, sorted by name:
#                   u32 name_len, name utf-8
#                   u32 dtype_len, numpy dtype str (little-endian codes)
#                   u32 ndim, ndim x u64 shape
#                   u64 data_len, raw C-order array bytes
#        .    20  sha1 of every preceding byte (corruption detection)
#
# Compat policy: readers accept version <= their own and must reject
# newer; adding scalars is a same-version change (readers ignore unknown
# meta keys), adding/renaming arrays or changing any encoding bumps the
# version.  tests/test_faults.py pins the layout byte-for-byte against
# tests/golden/c2qp_snapshot_v1.bin.
#
# v2 (journal bases): identical encoding; the meta additionally carries
# ``journal_epoch`` + ``journal_lsn`` — the write-ahead-journal position
# this state is a prefix fold of (``repro_torch.faults.journal``).  Plain
# captures keep writing version 1, so the v1 golden stays byte-exact;
# tests/golden/c2qp_snapshot_v2.bin pins the v2 layout.

def _canon_meta(meta: Dict) -> bytes:
    return json.dumps(meta, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def pack(d: Dict) -> bytes:
    """Serialize a ``state_dict`` to the versioned byte format (the
    header version field mirrors ``meta["version"]``: 1 for plain state,
    2 for journal-base snapshots carrying epoch/LSN meta).

    Fully deterministic: the same engine state always packs to the same
    bytes (canonical JSON meta, name-sorted little-endian arrays,
    trailing sha1) — which is what makes golden-file pinning and
    content-addressed snapshot dedup possible.
    """
    meta_b = _canon_meta(d["meta"])
    arrays = d["arrays"]
    version = int(d["meta"].get("version", VERSION))
    out = [MAGIC, struct.pack("<II", version, len(arrays)),
           struct.pack("<Q", len(meta_b)), meta_b]
    for name in sorted(arrays):
        arr = np.ascontiguousarray(arrays[name])
        if arr.dtype.byteorder == ">":  # normalize to little-endian
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        nb = name.encode("utf-8")
        db = arr.dtype.str.encode("ascii")
        raw = arr.tobytes()
        out.append(struct.pack("<I", len(nb)) + nb)
        out.append(struct.pack("<I", len(db)) + db)
        out.append(struct.pack("<I", arr.ndim)
                   + struct.pack(f"<{arr.ndim}Q", *arr.shape))
        out.append(struct.pack("<Q", len(raw)) + raw)
    payload = b"".join(out)
    return payload + hashlib.sha1(payload).digest()


def unpack(buf: bytes) -> Dict:
    """Parse snapshot bytes (v1 or v2) back into a ``state_dict``
    (verifying the magic, version, and trailing digest)."""
    if len(buf) < len(MAGIC) + 36 or buf[:8] != MAGIC:
        raise ValueError("not a Clock2Q+ snapshot (bad magic)")
    payload, digest = buf[:-20], buf[-20:]
    if hashlib.sha1(payload).digest() != digest:
        raise IOError("snapshot corrupt: digest mismatch")
    version, n_arrays = struct.unpack_from("<II", buf, 8)
    if version > VERSION:
        raise ValueError(f"snapshot version {version} is newer than this "
                         f"reader (max {VERSION})")
    (meta_len,) = struct.unpack_from("<Q", buf, 16)
    off = 24
    meta = json.loads(buf[off:off + meta_len].decode("utf-8"))
    off += meta_len
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(n_arrays):
        (nl,) = struct.unpack_from("<I", buf, off)
        off += 4
        name = buf[off:off + nl].decode("utf-8")
        off += nl
        (dl,) = struct.unpack_from("<I", buf, off)
        off += 4
        dtype = np.dtype(buf[off:off + dl].decode("ascii"))
        off += dl
        (ndim,) = struct.unpack_from("<I", buf, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}Q", buf, off)
        off += 8 * ndim
        (raw_len,) = struct.unpack_from("<Q", buf, off)
        off += 8
        arrays[name] = np.frombuffer(
            buf[off:off + raw_len], dtype=dtype).reshape(shape).copy()
        off += raw_len
    return {"meta": meta, "arrays": arrays}


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename/create inside it is itself durable
    (a crashed host may otherwise forget the rename even though the file
    contents were fsync'd).  No-op where directories can't be opened."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return  # e.g. non-POSIX: directory fsync unsupported
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, buf: bytes) -> None:
    """Write ``buf`` to ``path`` crash-durably: temp file + fsync +
    rename + parent-directory fsync (the rename itself must survive a
    crash, not just the bytes)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def write_snapshot(path: str, cache, journal_meta=None) -> bytes:
    """Capture ``cache`` and atomically write the packed snapshot to
    ``path`` (write-to-temp + fsync + rename + directory fsync: a crash
    mid-write never leaves a torn snapshot where a restore might find
    it, and the rename itself is durable).  ``journal_meta=(epoch,
    lsn)`` writes a v2 journal-base snapshot.  Returns the bytes."""
    buf = pack(state_dict(cache, journal_meta=journal_meta))
    _atomic_write(path, buf)
    return buf


def read_snapshot(path: str) -> Dict:
    """Read + verify a packed snapshot file into a ``state_dict``."""
    with open(path, "rb") as f:
        return unpack(f.read())


# -- retention-managed store (on checkpoint/ckpt.py) ---------------------------

class SnapshotManager:
    """Periodic engine snapshots with retention, built on
    ``repro_torch.checkpoint.ckpt.CheckpointManager``.

    Each ``save`` commits the snapshot as a checkpoint step: arrays are
    the pytree leaves (one digest-verified ``.npy`` each), the scalar
    meta rides as a packed uint8 leaf, and CheckpointManager supplies
    the atomic manifest commit, retention of the last ``keep`` steps,
    and per-leaf corruption detection.  The checkpoint import is lazy so
    ``repro_torch.faults`` stays importable without JAX.
    """

    def __init__(self, directory: str, keep: int = 3):
        from repro_torch.checkpoint.ckpt import CheckpointManager

        self._mgr = CheckpointManager(directory, keep=keep)

    def save(self, cache, step: int) -> None:
        """Snapshot ``cache`` and commit it as checkpoint ``step``."""
        d = state_dict(cache)
        tree = {f"a/{n}": a for n, a in d["arrays"].items()}
        tree["meta"] = np.frombuffer(_canon_meta(d["meta"]),
                                     dtype=np.uint8).copy()
        self._mgr.save(step, tree, blocking=True)

    def steps(self):
        """Committed snapshot steps, oldest first."""
        return self._mgr.all_steps()

    def latest_step(self) -> Optional[int]:
        """Newest committed snapshot step, or None."""
        return self._mgr.latest_step()

    def load(self, step: Optional[int] = None,
             verify: bool = True) -> Dict:
        """Read a committed snapshot back into a ``state_dict``."""
        if step is None:
            step = self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no snapshots in {self._mgr.dir}")
        d = self._mgr.dir / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        like = {path: np.zeros(m["shape"],
                               dtype=np.dtype(m["dtype"]))
                for path, m in manifest["leaves"].items()}
        tree = self._mgr.restore(step, like, verify=verify)
        meta = json.loads(bytes(tree.pop("meta")).decode("utf-8"))
        arrays = {n[len("a/"):]: a for n, a in tree.items()}
        return {"meta": meta, "arrays": arrays}

    def restore(self, cache, step: Optional[int] = None,
                verify: bool = True) -> int:
        """Restore the latest (or a specific) snapshot into ``cache``;
        returns the step restored."""
        if step is None:
            step = self._mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no snapshots in {self._mgr.dir}")
        load_state_dict(cache, self.load(step, verify=verify), step=step)
        return step

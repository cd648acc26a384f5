"""Append-only write-ahead delta journal for one Clock2Q+ shard.

The port's own copy of ``repro/faults/journal.py``: records, segment
headers, file names and recovery are byte for byte the reference's,
so a journal directory written by either package recovers in both.

The journal records the *inputs* of every state-mutating policy call
(access / io_done / unpin / clean / set_dirty / retune / begin_resize /
resize_step) as compact fixed-size binary records with a monotonic LSN
and a CRC32 per record.  Because the Clock2Q+ engine is deterministic —
same starting state + same call sequence = bit-identical arrays — a
*physiological* log of the call stream is enough to reconstruct a shard
exactly: replaying the journal on top of its base snapshot yields the
pre-crash state up to the last durable record.  Access records carry the
observed outcome (hit / evicted key / block / bypass) purely as a
cross-check: replay verifies them and raises ``ReplayDivergence`` if the
engine ever disagrees with the log, instead of silently rebuilding a
different cache.

On-disk layout (one directory per shard):

  ``base-EEEEEEEE-LLLLLLLLLLLL.c2qsnap``  — snapshot v2 (journal base):
      the state with every record up to LSN L of epoch E folded in
      (``repro_torch.faults.snapshot`` format; meta carries journal_epoch /
      journal_lsn).
  ``seg-EEEEEEEE-LLLLLLLLLLLL.c2qj``      — a journal segment: a 36-byte
      CRC-guarded header (magic ``C2QJSEG1``, version, shard id, epoch,
      start LSN) followed by consecutive 38-byte records.

Records are 38 bytes: ``<QBBqqq`` body (lsn u64, op u8, flags u8, three
i64 payload words) + u32 CRC32 of the body.  A torn tail — a record cut
mid-write by a crash — fails its CRC (or is short), and ``recover``
truncates the file back to the last whole record rather than applying
garbage; crash-point fuzzing in ``tests/test_recovery_fuzz.py`` kills
the writer at every record boundary and at random intra-record byte
offsets to prove it.

Epochs number shard incarnations: a promote/reattach bumps the epoch and
starts a fresh base + segment chain (LSNs restart at 0 per epoch), so a
recovering reader always picks the newest base by (epoch, lsn) and
replays only that epoch's segments.  ``compact()`` folds all sealed
segments into a new base and deletes them, bounding replay length.

Durability: ``sync_every=N`` fsyncs every N records; segment rotation
and ``close``/``sync`` always fsync (file then directory, the same
rename-barrier discipline ``write_snapshot`` uses).  ``directory=None``
keeps everything in process memory — zero-IO journaling for hot-standby
replication (``repro_torch.faults.replica``) and for tests.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import struct
import zlib
from collections import deque
from typing import List, NamedTuple, Optional

from repro_torch.faults.plan import CRASH, OP_JOURNAL_APPEND
from repro_torch.faults.snapshot import (
    _atomic_write, _fsync_dir, pack, policy_from_snapshot, state_dict,
    unpack,
)
from repro_torch.obs.events import EV_JOURNAL_TRUNCATED
from repro_torch.obs.export import NullSink

# -- record encoding -----------------------------------------------------------

# journal op codes (the u8 `op` field)
J_ACCESS = 1       # p0=key, p1=evicted_key, p2=block; flags carry the rest
J_IO_DONE = 2      # p0=key
J_UNPIN = 3        # p0=key
J_CLEAN = 4        # p0=key
J_SET_DIRTY = 5    # p0=key
J_RETUNE = 6       # p0/p1/p2 = float64 bit patterns of the absolute
                   # post-retune small/ghost/window fractions
J_RESIZE = 7       # p0=new_capacity (begin_resize)
J_RESIZE_STEP = 8  # p0=n_entries

# J_ACCESS flag bits: inputs (dirty/pin) and observed outcomes (hit/
# bypass) — outcomes exist so replay can detect divergence, not to
# steer it
JF_DIRTY = 1
JF_PIN = 2
JF_HIT = 4
JF_BYPASS = 8

_BODY = "<QBBqqq"                       # lsn, op, flags, p0, p1, p2
_BODY_SIZE = struct.calcsize(_BODY)     # 34
RECORD_SIZE = _BODY_SIZE + 4            # + u32 crc32(body) = 38

SEG_MAGIC = b"C2QJSEG1"
SEG_VERSION = 1
_SEG_HDR = "<8sIIQQI"                   # magic, version, shard, epoch,
_SEG_HDR_SIZE = struct.calcsize(_SEG_HDR)  # start_lsn, crc = 36 bytes


class JRecord(NamedTuple):
    """One decoded journal record."""

    lsn: int
    op: int
    flags: int
    p0: int
    p1: int
    p2: int


class JournalCrash(RuntimeError):
    """The (simulated) process died mid-append — raised by a CRASH
    ``FaultSpec`` targeting ``OP_JOURNAL_APPEND``; whatever prefix of the
    record the spec's ``ticks`` allowed is already flushed to disk."""


class ReplayDivergence(RuntimeError):
    """Journal replay produced a different outcome than the log recorded
    (hit/miss, victim, or block mismatch) — the recovered state cannot be
    trusted and recovery must fall back to the base snapshot."""


def _f_bits(f: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(f)))[0]


def _bits_f(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


def encode_record(lsn: int, op: int, flags: int = 0, p0: int = 0,
                  p1: int = 0, p2: int = 0) -> bytes:
    """Serialize one record: 34-byte body + CRC32 trailer (38 bytes)."""
    body = struct.pack(_BODY, lsn, op, flags, p0, p1, p2)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def decode_record(buf: bytes, off: int = 0) -> Optional[JRecord]:
    """Decode the record at ``off``; None when short or CRC-corrupt
    (a torn tail, never an exception — torn tails are expected)."""
    if off + RECORD_SIZE > len(buf):
        return None
    body = buf[off:off + _BODY_SIZE]
    (crc,) = struct.unpack_from("<I", buf, off + _BODY_SIZE)
    if crc != (zlib.crc32(body) & 0xFFFFFFFF):
        return None
    return JRecord(*struct.unpack(_BODY, body))


def _seg_header(shard_id: int, epoch: int, start_lsn: int) -> bytes:
    head = struct.pack("<8sIIQQ", SEG_MAGIC, SEG_VERSION, shard_id, epoch,
                       start_lsn)
    return head + struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF)


def _parse_seg_header(buf: bytes):
    """(shard_id, epoch, start_lsn) or None if the header is torn."""
    if len(buf) < _SEG_HDR_SIZE:
        return None
    magic, ver, shard, epoch, start, crc = struct.unpack_from(_SEG_HDR, buf)
    if magic != SEG_MAGIC or ver != SEG_VERSION:
        return None
    if crc != (zlib.crc32(buf[:_SEG_HDR_SIZE - 4]) & 0xFFFFFFFF):
        return None
    return shard, epoch, start


def _decode_segment(buf: bytes):
    """Decode a segment buffer into (records, good_end, header).

    ``good_end`` is the byte offset of the last whole valid record —
    everything past it is a torn tail (or, when the header itself is
    torn, 0: the whole file is garbage).  Decoding stops at the first
    short / CRC-failed / LSN-discontinuous record.
    """
    hdr = _parse_seg_header(buf)
    if hdr is None:
        return [], 0, None
    _, _, start_lsn = hdr
    recs: List[JRecord] = []
    off = _SEG_HDR_SIZE
    expect = start_lsn
    while True:
        rec = decode_record(buf, off)
        if rec is None or rec.lsn != expect:
            break
        recs.append(rec)
        off += RECORD_SIZE
        expect += 1
    return recs, off, hdr


# -- the journal ---------------------------------------------------------------

class ShardJournal:
    """Append-only WAL for one shard (see module docstring).

    ``directory=None`` journals to process memory (hot-standby feed);
    a path journals to ``base-*/seg-*`` files with fsync barriers.
    ``segment_records`` bounds segment length (rotation point),
    ``sync_every=N`` fsyncs every N appends (0 = only on rotate/close),
    ``plan`` is an optional ``FaultPlan`` whose CRASH specs (targeting
    ``OP_JOURNAL_APPEND``) kill the writer mid-record, and ``tail_cap``
    bounds the decoded in-memory tail serving ``records_since``.
    """

    def __init__(self, directory: Optional[str] = None, shard_id: int = 0,
                 *, epoch: int = 0, segment_records: int = 4096,
                 sync_every: int = 0, plan=None, tail_cap: int = 65536):
        if segment_records < 1:
            raise ValueError("segment_records must be >= 1")
        self.directory = directory
        self.shard_id = int(shard_id)
        self.epoch = int(epoch)
        self.segment_records = int(segment_records)
        self.sync_every = int(sync_every)
        self.plan = plan
        self._lsn = 0          # last assigned LSN (0 = nothing journaled)
        self._durable = 0      # last LSN known flushed+fsynced
        self._base_lsn = 0
        self._base_bytes: Optional[bytes] = None
        self._base_path: Optional[str] = None
        self._tail: deque = deque(maxlen=int(tail_cap))
        self._seg_count = 0    # records in the current segment
        self._seg_start = 1
        self._f = None                       # dir mode: open segment file
        self._seg_paths: List[str] = []      # dir mode: sealed + current
        self._segments: List[bytearray] = []  # memory mode
        self._closed = False
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    # -- positions ------------------------------------------------------------
    @property
    def lsn(self) -> int:
        """Last assigned LSN (the newest record, durable or not)."""
        return self._lsn

    @property
    def durable_lsn(self) -> int:
        """Last LSN guaranteed on stable storage (== ``lsn`` in memory
        mode, where there is no volatile page cache to lose)."""
        return self._durable

    @property
    def base_lsn(self) -> int:
        """LSN already folded into the base snapshot."""
        return self._base_lsn

    # -- lifecycle ------------------------------------------------------------
    def attach(self, pol) -> "ShardJournal":
        """Write the base snapshot of ``pol`` and start journaling its
        mutations (sets ``pol._journal``).  Returns self."""
        self._write_base(pol)
        self._open_segment(self._lsn + 1)
        pol._journal = self
        return self

    def _write_base(self, pol) -> None:
        buf = pack(state_dict(pol, journal_meta=(self.epoch, self._lsn)))
        self._base_bytes = buf
        self._base_lsn = self._lsn
        if self.directory is not None:
            path = os.path.join(
                self.directory,
                f"base-{self.epoch:08d}-{self._lsn:012d}.c2qsnap")
            _atomic_write(path, buf)
            old = self._base_path
            self._base_path = path
            if old is not None and old != path and os.path.exists(old):
                os.unlink(old)
                _fsync_dir(self.directory)

    def _open_segment(self, start_lsn: int) -> None:
        hdr = _seg_header(self.shard_id, self.epoch, start_lsn)
        self._seg_start = start_lsn
        self._seg_count = 0
        if self.directory is None:
            self._segments.append(bytearray(hdr))
            return
        path = os.path.join(
            self.directory, f"seg-{self.epoch:08d}-{start_lsn:012d}.c2qj")
        self._f = open(path, "wb")
        self._f.write(hdr)
        self._f.flush()
        self._seg_paths.append(path)

    def sync(self) -> None:
        """Flush + fsync the current segment (durability barrier)."""
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
        self._durable = self._lsn

    def close(self) -> None:
        """Seal the journal: fsync the open segment (and its directory)
        and stop accepting appends."""
        if self._closed:
            return
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None
            _fsync_dir(self.directory)
        self._durable = self._lsn
        self._closed = True

    def _rotate(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None
            _fsync_dir(self.directory)
        self._durable = self._lsn
        self._open_segment(self._lsn + 1)

    # -- the append hot path --------------------------------------------------
    def _write(self, data: bytes) -> None:
        if self._f is not None:
            self._f.write(data)
        else:
            self._segments[-1] += data

    def append(self, op: int, flags: int = 0, p0: int = 0, p1: int = 0,
               p2: int = 0) -> int:
        """Append one record; returns its LSN.  A CRASH fault on the
        plan's ``journal_append`` stream flushes a record *prefix*
        (``ticks`` bytes) and raises ``JournalCrash`` — the torn tail the
        recovery fuzzer then has to detect."""
        if self._closed:
            raise ValueError("journal is closed")
        lsn = self._lsn + 1
        rec = encode_record(lsn, op, flags, p0, p1, p2)
        plan = self.plan
        if plan is not None and plan.enabled:
            f = plan.next_op(OP_JOURNAL_APPEND)
            if f is not None and f.kind == CRASH:
                cut = max(0, min(RECORD_SIZE, int(f.ticks)))
                self._write(rec[:cut])
                if self._f is not None:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                self._closed = True
                raise JournalCrash(
                    f"journal writer killed mid-append: lsn {lsn}, "
                    f"{cut}/{RECORD_SIZE} bytes reached disk")
        self._write(rec)
        self._lsn = lsn
        self._seg_count += 1
        self._tail.append(JRecord(lsn, op, flags, p0, p1, p2))
        if self._f is None:
            self._durable = lsn
        elif self.sync_every and self._seg_count % self.sync_every == 0:
            self.sync()
        if self._seg_count >= self.segment_records:
            self._rotate()
        return lsn

    # -- policy-facing hooks (duck-typed from ProdClock2QPlus._journal) -------
    def on_access(self, key: int, dirty: bool, pin: bool, r) -> None:
        """Journal one ``access`` with its observed outcome flags."""
        flags = ((JF_DIRTY if dirty else 0) | (JF_PIN if pin else 0)
                 | (JF_HIT if r.hit else 0)
                 | (JF_BYPASS if r.bypassed_to_main else 0))
        self.append(J_ACCESS, flags, int(key), int(r.evicted_key),
                    int(r.block))

    def on_io_done(self, key: int) -> None:
        """Journal an ``io_done``."""
        self.append(J_IO_DONE, 0, int(key))

    def on_unpin(self, key: int) -> None:
        """Journal an ``unpin``."""
        self.append(J_UNPIN, 0, int(key))

    def on_clean(self, key: int) -> None:
        """Journal a ``clean``."""
        self.append(J_CLEAN, 0, int(key))

    def on_set_dirty(self, key: int) -> None:
        """Journal a ``set_dirty``."""
        self.append(J_SET_DIRTY, 0, int(key))

    def on_retune(self, small_frac: float, ghost_frac: float,
                  window_frac: float) -> None:
        """Journal a ``retune`` as ONE record of absolute post-values
        (the retune's internal ``begin_resize`` is suppressed)."""
        self.append(J_RETUNE, 0, _f_bits(small_frac), _f_bits(ghost_frac),
                    _f_bits(window_frac))

    def on_resize(self, new_capacity: int) -> None:
        """Journal a direct ``begin_resize``."""
        self.append(J_RESIZE, 0, int(new_capacity))

    def on_resize_step(self, n_entries: int) -> None:
        """Journal a ``resize_step`` drive."""
        self.append(J_RESIZE_STEP, 0, int(n_entries))

    # -- readers --------------------------------------------------------------
    def base_state(self):
        """The base snapshot as a ``state_dict`` (fresh unpack — callers
        may mutate the result freely)."""
        if self._base_bytes is None:
            raise ValueError("journal has no base (attach() not called)")
        return unpack(self._base_bytes)

    def records_since(self, from_lsn: int) -> List[JRecord]:
        """All records with ``lsn > from_lsn``, in order.  Served from
        the decoded in-memory tail when it reaches back far enough,
        otherwise re-decoded from the segment store."""
        if from_lsn >= self._lsn:
            return []
        if self._tail and self._tail[0].lsn <= from_lsn + 1:
            return [r for r in self._tail if r.lsn > from_lsn]
        return self._scan(from_lsn)

    def _segment_buffers(self) -> List[bytes]:
        if self.directory is None:
            return [bytes(s) for s in self._segments]
        if self._f is not None:
            self._f.flush()
        out = []
        for path in self._seg_paths:
            with open(path, "rb") as f:
                out.append(f.read())
        return out

    def _scan(self, from_lsn: int) -> List[JRecord]:
        out: List[JRecord] = []
        for buf in self._segment_buffers():
            recs, _, hdr = _decode_segment(buf)
            if hdr is None:
                continue
            out.extend(r for r in recs if r.lsn > from_lsn)
        return out

    # -- compaction -----------------------------------------------------------
    def compact(self) -> int:
        """Fold every *sealed* segment into a fresh base snapshot and
        delete them (replay-length bound).  The open segment is left
        alone.  Returns the number of records folded."""
        n_sealed = (len(self._seg_paths) if self.directory is not None
                    else len(self._segments)) - 1
        if n_sealed < 1:
            return 0
        bufs = self._segment_buffers()[:n_sealed]
        mirror = policy_from_snapshot(self.base_state(), obs=NullSink())
        folded = 0
        for buf in bufs:
            recs, _, hdr = _decode_segment(buf)
            if hdr is None:
                raise ValueError("sealed journal segment has a torn header")
            for rec in recs:
                if rec.lsn <= self._base_lsn:
                    continue
                apply_record(mirror, rec)
                self._base_lsn = rec.lsn
                folded += 1
        self._base_bytes = pack(
            state_dict(mirror, journal_meta=(self.epoch, self._base_lsn)))
        if self.directory is not None:
            path = os.path.join(
                self.directory,
                f"base-{self.epoch:08d}-{self._base_lsn:012d}.c2qsnap")
            _atomic_write(path, self._base_bytes)
            old = self._base_path
            self._base_path = path
            for sealed in self._seg_paths[:n_sealed]:
                os.unlink(sealed)
            del self._seg_paths[:n_sealed]
            if old is not None and old != path and os.path.exists(old):
                os.unlink(old)
            _fsync_dir(self.directory)
        else:
            del self._segments[:n_sealed]
        return folded


# -- replay --------------------------------------------------------------------

def apply_record(pol, rec: JRecord, verify: bool = True) -> None:
    """Apply one journal record to a policy instance.

    ``verify=True`` cross-checks J_ACCESS outcomes (hit, victim, block,
    bypass) against what the log recorded and raises
    ``ReplayDivergence`` on any mismatch — replay must reproduce the
    original run bit-exactly or fail loudly, never silently drift.
    """
    op = rec.op
    if op == J_ACCESS:
        r = pol.access(rec.p0, dirty=bool(rec.flags & JF_DIRTY),
                       pin=bool(rec.flags & JF_PIN))
        if verify:
            hit = bool(rec.flags & JF_HIT)
            if (r.hit != hit
                    or r.bypassed_to_main != bool(rec.flags & JF_BYPASS)
                    or int(r.block) != rec.p2
                    or (not hit and int(r.evicted_key) != rec.p1)):
                raise ReplayDivergence(
                    f"replay of lsn {rec.lsn} (access key {rec.p0}) "
                    f"diverged: got hit={r.hit} block={int(r.block)} "
                    f"evicted={int(r.evicted_key)} "
                    f"bypass={r.bypassed_to_main}, journal says "
                    f"hit={hit} block={rec.p2} evicted={rec.p1} "
                    f"bypass={bool(rec.flags & JF_BYPASS)}")
    elif op == J_IO_DONE:
        pol.io_done(rec.p0)
    elif op == J_UNPIN:
        pol.unpin(rec.p0)
    elif op == J_CLEAN:
        pol.clean(rec.p0)
    elif op == J_SET_DIRTY:
        pol.set_dirty(rec.p0)
    elif op == J_RETUNE:
        pol.retune(small_frac=_bits_f(rec.p0), ghost_frac=_bits_f(rec.p1),
                   window_frac=_bits_f(rec.p2))
    elif op == J_RESIZE:
        pol.begin_resize(rec.p0)
    elif op == J_RESIZE_STEP:
        pol.resize_step(rec.p0)
    else:
        raise ReplayDivergence(f"unknown journal op {op} at lsn {rec.lsn}")


@dataclasses.dataclass
class RecoveryResult:
    """What ``recover`` reconstructed from a journal directory."""

    policy: object          # the recovered ProdClock2QPlus
    epoch: int              # journal epoch recovered
    lsn: int                # last durable LSN applied
    applied: int            # records replayed past the base
    truncated_bytes: int    # torn-tail bytes cut (0 = clean shutdown)


def recover(directory: str, *, obs=None, verify: bool = True,
            truncate: bool = True) -> RecoveryResult:
    """Rebuild a shard from its journal directory.

    Picks the newest base snapshot by (epoch, lsn), replays that epoch's
    segments in LSN order, stops at the first torn record (short bytes /
    CRC failure / LSN discontinuity) and — with ``truncate=True`` —
    physically truncates the torn tail off the segment file and emits
    ``EV_JOURNAL_TRUNCATED`` on ``obs``.  A torn record is NEVER
    applied; the recovered state is bit-exact at the last durable LSN.
    """
    bases = glob.glob(os.path.join(directory, "base-*.c2qsnap"))
    if not bases:
        raise FileNotFoundError(f"no journal base snapshot in {directory}")

    def _base_key(p: str):
        stem = os.path.basename(p)[len("base-"):-len(".c2qsnap")]
        e, l = stem.split("-")
        return int(e), int(l)

    base_path = max(bases, key=_base_key)
    with open(base_path, "rb") as f:
        d = unpack(f.read())
    pol = policy_from_snapshot(d, obs=obs)
    epoch = int(d["meta"].get("journal_epoch", 0))
    applied_lsn = int(d["meta"].get("journal_lsn", 0))
    applied = 0
    torn = 0

    def _seg_key(p: str):
        stem = os.path.basename(p)[len("seg-"):-len(".c2qj")]
        _, start = stem.split("-")
        return int(start)

    segs = sorted(glob.glob(
        os.path.join(directory, f"seg-{epoch:08d}-*.c2qj")), key=_seg_key)
    for path in segs:
        with open(path, "rb") as f:
            buf = f.read()
        recs, good_end, hdr = _decode_segment(buf)
        for rec in recs:
            if rec.lsn <= applied_lsn:
                continue
            if rec.lsn != applied_lsn + 1:  # gap: a segment is missing
                good_end = _SEG_HDR_SIZE if hdr is not None else 0
                recs = []
                break
            apply_record(pol, rec, verify=verify)
            applied_lsn = rec.lsn
            applied += 1
        if good_end < len(buf):  # torn tail (or torn header: good_end=0)
            torn = len(buf) - good_end
            if truncate:
                os.truncate(path, good_end)
                _fsync_dir(directory)
            if obs is not None and obs.ring.enabled:
                obs.emit(EV_JOURNAL_TRUNCATED, shard=pol.shard_id,
                         a=applied_lsn, b=torn)
            break  # nothing after a torn tail is trustworthy
    return RecoveryResult(policy=pol, epoch=epoch, lsn=applied_lsn,
                          applied=applied, truncated_bytes=torn)

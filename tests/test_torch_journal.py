"""The port's write-ahead journal and hot-standby replicas
(``repro_torch.faults.journal``, ``.replica``) against the reference's, on
the CPU.

The command stream is ``tests/test_recovery_fuzz.py``'s ``_drive`` (every
journaled op kind), run on a port policy and a reference policy alike.
Everything is held exactly: the records and segment bytes in memory and
on disk (base snapshots included, file for file), ``recover`` at every
record boundary and at seeded byte offsets inside records (the state
bytes, the LSN, the torn bytes cut and the truncated files), a CRASH
spec killing the writer mid-record, compaction, and promotion of a
standby against the reference's shard state.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest

from repro import faults as J
from repro.faults import journal as jj
from repro.core.prodcache import ProdClock2QPlus as JProd
from repro.obs import NullSink as JNullSink
from repro.obs import ObsSink as JObsSink
from repro.shardcache import ShardedClock2QPlus as JSharded
from repro_torch import faults as P
from repro_torch.faults import journal as pj
from repro_torch.core.prodcache import ProdClock2QPlus as PProd
from repro_torch.obs import NullSink as PNullSink
from repro_torch.obs import ObsSink as PObsSink
from repro_torch.shardcache import ShardedClock2QPlus as PSharded
from test_recovery_fuzz import _crash_copy, _drive


def _policies():
    return (JProd(48, max_capacity=64, obs=JNullSink()),
            PProd(48, max_capacity=64, obs=PNullSink()))


def _files(directory) -> dict:
    """{file name: bytes} of a journal directory."""
    d = pathlib.Path(directory)
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _state(pkg, pol) -> bytes:
    return pkg.pack(pkg.state_dict(pol))


def test_record_and_header_encoding_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        lsn = int(rng.integers(0, 1 << 62))
        op, flags = int(rng.integers(1, 9)), int(rng.integers(0, 16))
        ps = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, 3)]
        buf = pj.encode_record(lsn, op, flags, *ps)
        assert buf == jj.encode_record(lsn, op, flags, *ps)
        assert len(buf) == pj.RECORD_SIZE == jj.RECORD_SIZE == 38
        assert tuple(pj.decode_record(buf)) == tuple(jj.decode_record(buf))
        torn = buf[:int(rng.integers(0, 38))]
        assert pj.decode_record(torn) is None is jj.decode_record(torn)
        bad = bytearray(buf)
        bad[int(rng.integers(0, 34))] ^= 1
        assert pj.decode_record(bytes(bad)) is None
    hdr = pj._seg_header(3, 7, 4097)
    assert hdr == jj._seg_header(3, 7, 4097)
    assert pj._parse_seg_header(hdr) == jj._parse_seg_header(hdr)
    for f in (0.05, 0.1, 1.0 / 3, 2.5, -0.0):
        assert pj._f_bits(f) == jj._f_bits(f)
        assert pj._bits_f(pj._f_bits(f)) == f


@pytest.mark.parametrize("segment_records", [16, 64, 4096])
def test_memory_segments_equal_reference(segment_records):
    jpol, ppol = _policies()
    jjr = J.ShardJournal(None, segment_records=segment_records).attach(jpol)
    pjr = P.ShardJournal(None, segment_records=segment_records).attach(ppol)
    _drive(jpol)
    _drive(ppol)
    assert pjr.lsn == jjr.lsn > 300
    assert pjr.durable_lsn == jjr.durable_lsn == pjr.lsn
    assert [bytes(s) for s in pjr._segments] == \
        [bytes(s) for s in jjr._segments]
    assert pjr._base_bytes == jjr._base_bytes
    assert [tuple(r) for r in pjr.records_since(0)] == \
        [tuple(r) for r in jjr.records_since(0)]
    assert _state(P, ppol) == _state(J, jpol)
    # a port replica over the reference-identical journal is exact
    rep = P.ShardReplica(pjr)
    assert rep.lag == pjr.lsn and rep.catch_up() == pjr.lsn
    assert _state(P, rep.mirror) == _state(J, jpol)


def _journaled(pkg, pol, directory, **kw):
    """Drive ``pol`` under an on-disk journal; {lsn: state bytes}."""
    jr = pkg.ShardJournal(str(directory), segment_records=64, **kw)
    jr.attach(pol)
    states = {jr.lsn: _state(pkg, pol)}
    _drive(pol, each=lambda: states.__setitem__(jr.lsn, _state(pkg, pol)))
    jr.close()
    return jr, states


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """The same command stream journaled on disk by each package."""
    root = tmp_path_factory.mktemp("journals")
    jpol, ppol = _policies()
    jjr, jstates = _journaled(J, jpol, root / "ref")
    pjr, pstates = _journaled(P, ppol, root / "port")
    return root, jjr, pjr, jstates, pstates


def test_disk_segments_equal_reference(journals):
    root, jjr, pjr, jstates, pstates = journals
    assert pstates == jstates
    files = _files(root / "port")
    assert files == _files(root / "ref")
    assert sum(n.startswith("seg-") for n in files) > 4  # rotations ran
    assert pjr.lsn == jjr.lsn and pjr.durable_lsn == pjr.lsn
    # each package recovers the other's directory to the same state
    for pkg, d in ((P, "ref"), (J, "port")):
        res = pkg.recover(str(root / d), truncate=False)
        assert (res.lsn, res.applied, res.truncated_bytes) == \
            (pjr.lsn, pjr.lsn, 0)
        assert _state(pkg, res.policy) == pstates[pjr.lsn]


def _recover_both(src, dst_root, name, k, extra=0):
    """Crash-copy ``src`` at LSN ``k`` (+ ``extra`` torn bytes) twice and
    recover one copy with each package; returns the two results and the
    two directories' files after recovery."""
    out = []
    for pkg in (J, P):
        dst = dst_root / f"{name}-{pkg.__name__}"
        _crash_copy(str(src), str(dst), k, extra=extra)
        sink = (JObsSink if pkg is J else PObsSink)(src="recover")
        res = pkg.recover(str(dst), obs=sink)
        cuts = [(e["a"], e["b"]) for e in sink.ring.records()
                if e["kind"] == "journal_truncated"]
        out.append((res.lsn, res.applied, res.epoch, res.truncated_bytes,
                    _state(pkg, res.policy), cuts, _files(dst)))
        shutil.rmtree(dst)
    return out


def test_recover_at_every_record_boundary(journals, tmp_path):
    root, _, pjr, _, pstates = journals
    for k in range(pjr.lsn + 1):
        want, got = _recover_both(root / "port", tmp_path, f"b{k}", k)
        assert got == want, k
        assert got[0] == k and got[3] == 0 and got[4] == pstates[k]


def test_recover_at_seeded_intra_record_offsets(journals, tmp_path):
    root, _, pjr, _, pstates = journals
    rng = np.random.default_rng(7)
    for i in range(60):
        k = int(rng.integers(0, pjr.lsn))
        extra = int(rng.integers(1, pj.RECORD_SIZE))
        want, got = _recover_both(root / "port", tmp_path, f"r{i}", k, extra)
        assert got == want, (k, extra)
        assert got[0] == k and got[3] == extra and got[4] == pstates[k]
        assert got[5] == [(k, extra)]


@pytest.mark.parametrize("at,ticks", [(137, 17), (99, 10_000), (0, 0)])
def test_crash_spec_kills_writer_as_reference(tmp_path, at, ticks):
    out = []
    for pkg in (J, P):
        pol = (JProd if pkg is J else PProd)(
            48, max_capacity=64,
            obs=(JNullSink if pkg is J else PNullSink)())
        plan = pkg.FaultPlan(7, [pkg.FaultSpec(
            pkg.CRASH, ops=(pkg.OP_JOURNAL_APPEND,), at=(at,), ticks=ticks)])
        d = tmp_path / pkg.__name__
        jr = pkg.ShardJournal(str(d), segment_records=64, plan=plan)
        jr.attach(pol)
        with pytest.raises(pkg.JournalCrash):
            _drive(pol)
        with pytest.raises(ValueError):
            jr.append(1)
        before = _files(d)
        res = pkg.recover(str(d))
        out.append((before, _files(d), res.lsn, res.truncated_bytes,
                    _state(pkg, res.policy)))
    assert out[1] == out[0]
    assert out[1][2] == (at + 1 if ticks >= pj.RECORD_SIZE else at)


def test_compaction_equals_reference(tmp_path):
    out = []
    for pkg, pol in zip((J, P), _policies()):
        d = tmp_path / pkg.__name__
        jr = pkg.ShardJournal(str(d), segment_records=32)
        jr.attach(pol)
        _drive(pol, n=150)
        folded = jr.compact()
        mem = pkg.ShardJournal(None, segment_records=32)
        mirror = (JProd if pkg is J else PProd)(
            48, max_capacity=64, obs=(JNullSink if pkg is J else PNullSink)())
        mem.attach(mirror)
        _drive(mirror, n=150)
        mem_folded = mem.compact()
        jr.close()
        res = pkg.recover(str(d))
        out.append((folded, jr.base_lsn, _files(d), res.lsn,
                    _state(pkg, res.policy), mem_folded, mem._base_bytes,
                    [bytes(s) for s in mem._segments]))
    assert out[1] == out[0]
    assert out[1][0] > 0 and len(out[1][2]) == 2  # one base + open segment


def test_records_since_past_the_tail_equals_reference():
    out = []
    for pkg, pol in zip((J, P), _policies()):
        jr = pkg.ShardJournal(None, segment_records=32, tail_cap=8)
        jr.attach(pol)
        _drive(pol, n=100)
        out.append([tuple(r) for r in jr.records_since(0)]
                   + [tuple(r) for r in jr.records_since(jr.lsn - 3)])
    assert out[1] == out[0]


def test_replay_divergence_raises_as_reference():
    for pkg, pol in zip((J, P), _policies()):
        jr = pkg.ShardJournal(None).attach(pol)
        _drive(pol, n=40)
        recs = jr.records_since(0)
        rep = pkg.ShardReplica(jr)
        acc = next(i for i, r in enumerate(recs) if r.op == pj.J_ACCESS)
        for r in recs[:acc]:
            rep.apply(r)
        lie = recs[acc]._replace(flags=recs[acc].flags ^ pj.JF_HIT)
        with pytest.raises(pkg.ReplayDivergence):
            rep.apply(lie)
        with pytest.raises(ValueError):  # an LSN gap
            pkg.ShardReplica(jr).apply(recs[3])


def _serve(svc, rng, n):
    for k in rng.integers(0, 600, n):
        r = svc.access(int(k))
        if not r.hit:
            svc.io_done(int(k))


@pytest.mark.parametrize("on_disk", [False, True])
def test_replicator_promote_equals_reference(tmp_path, on_disk):
    mk = dict(n_shards=4, max_capacity=512)
    jsvc = JSharded(256, obs=JNullSink(), **mk)
    psvc = PSharded(256, obs=PNullSink(), **mk)
    jobs, pobs = JObsSink(src="replicator"), PObsSink(src="replicator")
    d = (lambda tag: str(tmp_path / tag)) if on_disk else (lambda tag: None)
    jrep = J.ShardReplicator(jsvc, d("ref"), lag_threshold=600, obs=jobs)
    prep = P.ShardReplicator(psvc, d("port"), lag_threshold=600, obs=pobs)
    rj, rp = np.random.default_rng(5), np.random.default_rng(5)
    _serve(jsvc, rj, 5000), _serve(psvc, rp, 5000)
    assert [prep.lag(i) for i in range(4)] == [jrep.lag(i) for i in range(4)]
    assert [prep.should_promote(i) for i in range(4)] == \
        [jrep.should_promote(i) for i in range(4)]
    assert prep.poll() == jrep.poll()
    _serve(jsvc, rj, 500), _serve(psvc, rp, 500)
    want = _state(J, jsvc.shards[1])
    res = prep.promote(1)
    assert tuple(res) == tuple(jrep.promote(1))
    assert res.replayed == res.lag_at_loss > 0
    assert _state(P, psvc.shards[1]) == want == _state(J, jsvc.shards[1])
    # payloads modelled: odd keys are unrecoverable and demoted
    fill = lambda key: None if key % 2 else (lambda local: None)
    assert tuple(prep.promote(2, fill=fill)) == \
        tuple(jrep.promote(2, fill=fill))
    prep.reattach(3), jrep.reattach(3)
    assert [j.epoch for j in prep.journals] == \
        [j.epoch for j in jrep.journals] == [0, 1, 1, 1]
    _serve(jsvc, rj, 500), _serve(psvc, rp, 500)
    assert prep.poll() == jrep.poll()
    assert prep.clock.now == jrep.clock.now == 2
    assert _state(P, psvc) == _state(J, jsvc)
    jsn, psn = jobs.snapshot(), pobs.snapshot()
    assert psn.gauges == jsn.gauges
    assert [(e["kind"], e["shard"], e["a"], e["b"]) for e in psn.events] == \
        [(e["kind"], e["shard"], e["a"], e["b"]) for e in jsn.events]
    if on_disk:
        for r in (jrep, prep):
            for jr in r.journals:
                jr.close()
        for i in range(4):
            assert _files(tmp_path / "port" / f"shard{i}") == \
                _files(tmp_path / "ref" / f"shard{i}")
            res = P.recover(os.path.join(tmp_path, "port", f"shard{i}"))
            assert _state(P, res.policy) == _state(P, psvc.shards[i])

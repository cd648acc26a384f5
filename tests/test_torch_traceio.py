"""The port's trace I/O (``repro_torch.traceio``) against the reference's
(``repro.traceio``), on the CPU.

The same keys, made with numpy from a seed, are written and read by both
packages: every format reads back identically across the two, and the
oracle, csv and npy files are byte-identical.  ``TraceStore`` chunks and
universes, ``iter_chunks`` over each kind of source, and the ``convert``
CLI's outputs are held equal too.
"""

import numpy as np
import pytest

from repro.traceio import convert as jconvert
from repro.traceio import formats as jfmt
from repro.traceio import store as jstore
from repro_torch.traceio import convert as pconvert
from repro_torch.traceio import formats as pfmt
from repro_torch.traceio import store as pstore

FORMATS = ["oracle", "csv", "npz", "npy"]
BYTE_EQUAL = ("oracle", "csv", "npy")  # npz: zip entries carry a date
_EXT = {"oracle": "bin", "csv": "csv", "npz": "npz", "npy": "npy"}


def _keys(n=3_000, seed=5, high=1 << 40):
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 64, n)
    cold = rng.integers(0, high, n)
    return np.where(rng.random(n) < 0.5, hot, cold).astype(np.int64)


def _both_paths(tmp_path, fmt, tag=""):
    return (str(tmp_path / f"ref{tag}.{_EXT[fmt]}"),
            str(tmp_path / f"port{tag}.{_EXT[fmt]}"))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("extras", [False, True])
def test_files_cross_read_and_match(tmp_path, fmt, extras):
    keys = _keys()
    kw = {}
    if extras:
        rng = np.random.default_rng(3)
        kw = dict(times=rng.integers(0, 1 << 31, keys.size),
                  sizes=rng.integers(1, 1 << 20, keys.size))
    ref_p, port_p = _both_paths(tmp_path, fmt)
    jfmt.save_trace(ref_p, keys, **kw)
    pfmt.save_trace(port_p, keys, **kw)
    for p in (ref_p, port_p):
        for load in (jfmt.load_trace, pfmt.load_trace):
            got = load(p)
            assert got.dtype == np.int64 and np.array_equal(got, keys)
    if fmt in BYTE_EQUAL:
        with open(ref_p, "rb") as a, open(port_p, "rb") as b:
            assert a.read() == b.read()


def test_empty_and_headerless_csv_read_alike(tmp_path):
    cases = {"empty.csv": "", "header.csv": "time,obj_id,obj_size\n",
             "bare.csv": "5\n\n7\n5\n", "pairs.csv": "0,9\n1,4\n"}
    for name, text in cases.items():
        p = tmp_path / name
        p.write_text(text)
        assert np.array_equal(pfmt.read_csv(p), jfmt.read_csv(p)), name
    for name in ("e.bin", "e.npy"):
        p = str(tmp_path / name)
        jfmt.save_trace(p, np.empty(0, np.int64))
        assert pfmt.load_trace(p).size == 0


def test_layout_helpers_equal_reference():
    assert pfmt.ORACLE_DTYPE == jfmt.ORACLE_DTYPE
    assert pfmt.CSV_HEADER == jfmt.CSV_HEADER
    keys = _keys(n=2_000, high=300)
    assert np.array_equal(pfmt.next_access_vtime(keys),
                          jfmt.next_access_vtime(keys))
    d, n = pfmt.relabel(keys)
    d_ref, n_ref = jfmt.relabel(keys)
    assert n == n_ref and d.dtype == d_ref.dtype and np.array_equal(d, d_ref)
    for path, fmt in (("x.bin", None), ("x.ORACLE", None), ("x.csv", "npy"),
                      ("x.npz", None), ("x.oraclegeneral", None)):
        assert pfmt.sniff_format(path, fmt) == jfmt.sniff_format(path, fmt)
    for path, fmt in (("x.dat", None), ("x.bin", "nope")):
        with pytest.raises(ValueError):
            jfmt.sniff_format(path, fmt)
        with pytest.raises(ValueError):
            pfmt.sniff_format(path, fmt)
    with pytest.raises(ValueError):
        pfmt.write_npy("x.npy", np.asarray([1, -2]))


@pytest.mark.parametrize("fmt", ["oracle", "npy"])
@pytest.mark.parametrize("chunk", [1, 7, 1_000, 5_000])
def test_store_chunks_and_universe_equal(tmp_path, fmt, chunk):
    keys = _keys(n=3_001, high=1 << 20)
    p = str(tmp_path / f"t.{_EXT[fmt]}")
    jfmt.save_trace(p, keys)
    ref, port = jstore.TraceStore(p), pstore.TraceStore(p)
    assert len(port) == len(ref) == keys.size and port.fmt == ref.fmt
    ref_chunks, port_chunks = list(ref.chunks(chunk)), list(port.chunks(chunk))
    assert len(port_chunks) == len(ref_chunks)
    for a, b in zip(port_chunks, ref_chunks):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    assert port.universe(chunk) == ref.universe(chunk) == keys.max() + 1
    assert port.max_key(chunk) == ref.max_key(chunk)
    assert np.array_equal(port.keys(), ref.keys())
    assert np.array_equal(port.chunk(5, 17), ref.chunk(5, 17))


def test_store_refusals_and_empty_file(tmp_path):
    p = str(tmp_path / "t.csv")
    jfmt.save_trace(p, _keys(n=10))
    for Store in (jstore.TraceStore, pstore.TraceStore):
        with pytest.raises(ValueError, match="convert"):
            Store(p)
    e = str(tmp_path / "e.bin")
    open(e, "wb").close()
    for Store in (jstore.TraceStore, pstore.TraceStore):
        s = Store(e)
        assert len(s) == 0 and s.universe() == 0 and list(s.chunks(4)) == []
        with pytest.raises(ValueError):
            list(s.chunks(0))
    assert pstore.DEFAULT_CHUNK == jstore.DEFAULT_CHUNK


def test_iter_chunks_equal_on_every_source(tmp_path):
    keys = _keys(n=2_503, high=1 << 16)
    p = str(tmp_path / "t.bin")
    jfmt.save_trace(p, keys)
    pieces = [keys[i:i + 300] for i in range(0, keys.size, 300)]
    sources = [
        (keys, keys), (keys.reshape(-1, 1), keys.reshape(-1, 1)),
        (jstore.TraceStore(p), pstore.TraceStore(p)),
        ((c for c in pieces), (c for c in pieces)),
        ([c.tolist() for c in pieces], [c.tolist() for c in pieces]),
    ]
    for ref_src, port_src in sources:
        ref = list(jstore.iter_chunks(ref_src, 97))
        port = list(pstore.iter_chunks(port_src, 97))
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert np.array_equal(a, b)
    with pytest.raises(TypeError):
        list(pstore.iter_chunks(42))


def _convert_both(tmp_path, capsys, args, out_name):
    """Run both CLIs with ``args`` (``OUT`` names the output file); returns
    (reference, port) stdout and output paths."""
    res = []
    for tag, main in (("ref", jconvert.main), ("port", pconvert.main)):
        out = str(tmp_path / f"{tag}_{out_name}") if out_name else None
        argv = [out if a == "OUT" else a for a in args]
        assert main(argv) == 0
        text = capsys.readouterr().out
        res.append((text.replace(out, "OUT") if out else text, out))
    return res


@pytest.mark.parametrize("scenario,out", [
    ("ghost-thrash", "s.bin"), ("w02-balanced", "s.npy"),
    ("cyclic-loop", "s.csv"), ("zipf", "s.npz")])
def test_convert_scenario_outputs_equal(tmp_path, capsys, scenario, out):
    (ref_text, ref_p), (port_text, port_p) = _convert_both(
        tmp_path, capsys, ["--scenario", scenario, "--n", "1500", "--seed",
                           "4", "OUT"], out)
    assert port_text == ref_text
    assert np.array_equal(pfmt.load_trace(port_p), jfmt.load_trace(ref_p))
    if not out.endswith(".npz"):
        with open(ref_p, "rb") as a, open(port_p, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("out", ["d.npy", "d.bin", "d.csv"])
def test_convert_relabel_and_format_outputs_equal(tmp_path, capsys, out):
    src = str(tmp_path / "sparse.bin")
    jfmt.save_trace(src, _keys(n=1_200, high=1 << 62))
    for args in (["--relabel", src, "OUT"], [src, "OUT"],
                 ["--in-format", "oracle", "--relabel", src, "OUT"]):
        (ref_text, ref_p), (port_text, port_p) = _convert_both(
            tmp_path, capsys, args, out)
        assert port_text == ref_text
        with open(ref_p, "rb") as a, open(port_p, "rb") as b:
            assert a.read() == b.read()
    (ref_text, _), (port_text, _) = _convert_both(
        tmp_path, capsys, ["--info", src], None)
    assert port_text == ref_text


def test_convert_listing_equal(capsys):
    assert jconvert.main(["--list-scenarios"]) == 0
    ref = capsys.readouterr().out
    assert pconvert.main(["--list-scenarios"]) == 0
    assert capsys.readouterr().out == ref and "ghost-thrash" in ref

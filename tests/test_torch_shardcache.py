"""The port's sharded service and streamed replays against the
reference's, on the CPU (the port's lanes on their plain versions).

* ``repro_torch.shardcache`` (``ShardedClock2QPlus``, ``apportion``, the
  threaded harness) against ``repro.shardcache``: hits, per-shard stats,
  flows and obs snapshots (every field but the wall-clock ``ts``), also
  across rebalancing, retargeting, a total resize and a lost shard;
* ``repro_torch.core.torch_engine``'s ``replay_store`` and
  ``sharded_replay`` against ``repro.core.jax_engine``'s;
* ``ProdClock2QPlus.replay`` over chunks against the reference's.

The same numpy inputs go to both packages; the tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import jax_engine as je
from repro.core import traces as jtraces
from repro.core.prodcache import ProdClock2QPlus as JProd
from repro.shardcache import hashing as jhash
from repro.shardcache import replay as jreplay
from repro.shardcache import sharded as jsharded
from repro.traceio.store import iter_chunks as jiter_chunks
from repro_torch import obs as pobs
from repro_torch.core import torch_engine as pte
from repro_torch.core.prodcache import ProdClock2QPlus as PProd
from repro_torch.shardcache import hashing as phash
from repro_torch.shardcache import replay as preplay
from repro_torch.shardcache import sharded as psharded
from repro_torch.traceio.formats import relabel
from repro_torch.traceio.store import iter_chunks as piter_chunks

CPU = "cpu"
N_SHARDED = 2_400   # requests per SUITE prefix in the lane comparisons


def _meta(spec_i: int, n: int) -> np.ndarray:
    """A dense prefix of SUITE trace ``spec_i``'s metadata trace."""
    tr = jtraces.derive_metadata(jtraces.SUITE[spec_i].data())[:n]
    return relabel(tr)[0]


def _data(n=6_000, universe=700, seed=11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, universe // 10, n)
    cold = rng.integers(0, universe, n)
    return np.where(rng.random(n) < 0.6, hot, cold).astype(np.int64)


def _snap(snapshot) -> dict:
    """A snapshot as plain data without its wall-clock ``ts``."""
    d = dataclasses.asdict(snapshot)
    del d["ts"]
    return d


# -- hashing and apportioning ----------------------------------------------------

def test_shard_hash_equal_reference():
    rng = np.random.default_rng(2)
    keys = np.concatenate([np.arange(5_000), rng.integers(0, 1 << 62, 5_000),
                           [0, 1, (1 << 63) - 1]]).astype(np.int64)
    for n in (1, 2, 3, 4, 7, 8, 16):
        assert np.array_equal(phash.shard_of_np(keys, n),
                              jhash.shard_of_np(keys, n))
        for k in keys[::500].tolist():
            assert phash.shard_of(k, n) == jhash.shard_of(k, n)


def test_apportion_equal_reference():
    rng = np.random.default_rng(4)
    for _ in range(300):
        n = int(rng.integers(1, 9))
        lo, hi = 2, int(rng.integers(3, 40))
        total = int(rng.integers(n * lo, n * hi + 1))
        w = rng.integers(0, 1000, n).astype(float).tolist()
        assert psharded.apportion(w, total, lo, hi) == \
            jsharded.apportion(w, total, lo, hi)
    for Apportion in (psharded.apportion, jsharded.apportion):
        with pytest.raises(ValueError):
            Apportion([1, 1], 100, 2, 10)


# -- the sharded service ---------------------------------------------------------

def _pair(cap, n_shards, **kw):
    return (jsharded.ShardedClock2QPlus(cap, n_shards=n_shards, **kw),
            psharded.ShardedClock2QPlus(cap, n_shards=n_shards, **kw))


def _assert_services_equal(ref, port):
    assert port.shard_stats() == ref.shard_stats()
    assert port.flows == ref.flows
    assert port.shard_capacities == ref.shard_capacities
    assert (port.hits, port.misses, port.io_waits, len(port)) == \
        (ref.hits, ref.misses, ref.io_waits, len(ref))
    assert port.tuning == ref.tuning
    for a, b in zip(port.shards, ref.shards):
        assert np.array_equal(a.key, b.key)
    assert _snap(port.obs_snapshot()) == _snap(ref.obs_snapshot())


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_service_equal_across_retargets_and_a_lost_shard(n_shards):
    keys = _data(n=8_000)
    ref, port = _pair(160, n_shards, rebalance_headroom=3.0)
    batches = np.array_split(keys, 8)

    def step(i):
        got, want = port.access_many(batches[i]), ref.access_many(batches[i])
        assert np.array_equal(got, want)
        _assert_services_equal(ref, port)

    step(0)
    assert port.rebalance() == ref.rebalance()
    step(1)
    caps = psharded.apportion(range(1, n_shards + 1), 160, 2, port.shard_max)
    for svc in (ref, port):
        svc.set_shard_capacities(caps, complete=False)
    step(2)
    assert port.rebalance_step(3) == ref.rebalance_step(3)
    step(3)
    for svc in (ref, port):
        svc.begin_resize(120)
        while not svc.resize_step(16):
            pass
    step(4)
    lost_ref, lost_port = ref.lose_shard(n_shards - 1), \
        port.lose_shard(n_shards - 1)
    assert np.array_equal(lost_port.key, lost_ref.key)
    step(5)
    for svc in (ref, port):
        svc.retune(window_frac=0.3, small_frac=0.15)
    step(6)
    for k in batches[7][:300].tolist():
        a, b = port.access(k, dirty=k % 3 == 0), ref.access(k, dirty=k % 3 == 0)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    _assert_services_equal(ref, port)
    assert sorted(port.dirty_keys()) == sorted(ref.dirty_keys())


def test_service_with_io_tracking_and_a_null_sink_equal():
    keys = _data(n=3_000, seed=5)
    ref = jsharded.ShardedClock2QPlus(64, n_shards=4, track_io=True,
                                      obs=jobs.NullSink())
    port = psharded.ShardedClock2QPlus(64, n_shards=4, track_io=True,
                                       obs=pobs.NullSink())
    assert np.array_equal(port.access_many(keys), ref.access_many(keys))
    for k in keys[:200].tolist():
        a, b = port.access(k), ref.access(k)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        port.io_done(k)
        ref.io_done(k)
    assert port.shard_stats() == ref.shard_stats()
    assert _snap(port.obs_snapshot()) == _snap(ref.obs_snapshot())


# -- the threaded harness ------------------------------------------------------------

def test_threaded_replay_and_store_at_one_thread_equal():
    keys = _data(n=9_000, seed=8)
    for batch in (1, 256, 4_096):
        ref, port = _pair(128, 4)
        r = jreplay.replay_threaded(ref, keys, n_threads=1, batch_size=batch)
        p = preplay.replay_threaded(port, keys, n_threads=1, batch_size=batch)
        assert (p.hits, p.n_requests, p.n_shards, p.n_threads) == \
            (r.hits, r.n_requests, r.n_shards, r.n_threads)
        assert p.miss_ratio == r.miss_ratio
        _assert_services_equal(ref, port)
    ref, port = _pair(128, 4)
    ref_obs, port_obs = jobs.ObsSink(src="replay"), pobs.ObsSink(src="replay")
    r = jreplay.replay_store(ref, keys, n_threads=1, batch_size=256,
                             chunk_size=1_003, obs=ref_obs)
    p = preplay.replay_store(port, keys, n_threads=1, batch_size=256,
                             chunk_size=1_003, obs=port_obs)
    assert (p.hits, p.n_requests) == (r.hits, r.n_requests)
    a, b = _snap(port_obs.snapshot()), _snap(ref_obs.snapshot())
    # the batch-latency histogram holds wall-clock times: only its count
    # of observations is the same run's
    ha, hb = a.pop("hists"), b.pop("hists")
    assert {k: h["count"] for k, h in ha.items()} == \
        {k: h["count"] for k, h in hb.items()}
    assert a == b
    assert [e["kind"] for e in a["events"]].count("snapshot") == 9
    _assert_services_equal(ref, port)


def test_threaded_replay_within_the_reference_band():
    keys = _data(n=12_000, seed=9)
    serial = preplay.replay_threaded(
        psharded.ShardedClock2QPlus(128, n_shards=4), keys, n_threads=1)
    for n_threads in (2, 4):
        rep = preplay.replay_store(
            psharded.ShardedClock2QPlus(128, n_shards=4), keys,
            n_threads=n_threads, batch_size=256, chunk_size=3_001)
        assert rep.n_requests == keys.size
        assert abs(rep.miss_ratio - serial.miss_ratio) < 0.01
    sweep = preplay.scalability_sweep(keys, 128, n_shards=4, threads=(1,))
    ref = jreplay.scalability_sweep(keys, 128, n_shards=4, threads=(1,))
    assert [r.hits for r in sweep] == [r.hits for r in ref]


def test_unsharded_and_lane_miss_ratios_equal():
    d = relabel(_data(n=1_000, seed=3))[0]
    assert preplay.unsharded_miss_ratio(d, 96) == \
        jreplay.unsharded_miss_ratio(d, 96)
    for policy, kw in (("clock2q+", {}), ("s3fifo", {}),
                       ("clock2q+", dict(window_frac=0.2))):
        assert preplay.lane_miss_ratio(d, 96, policy=policy, device=CPU,
                                       **kw) == \
            jreplay.lane_miss_ratio(d, 96, policy=policy, **kw)


# -- the lane-sharded simulation --------------------------------------------------

@pytest.fixture(scope="module")
def suite_prefixes():
    return {i: _meta(i, N_SHARDED) for i in range(3)}


@pytest.mark.parametrize("spec_i", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("divisible", [True, False])
def test_sharded_replay_equal_reference(suite_prefixes, spec_i, n_shards,
                                        divisible):
    d = suite_prefixes[spec_i]
    cap = 96 if divisible else 99
    got = pte.sharded_replay("clock2q+", d, cap, n_shards, device=CPU)
    want = je.sharded_replay("clock2q+", d, cap, n_shards)
    assert got.dtype == bool and got.shape == d.shape
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"{bad.size} requests differ, first {bad[:3]}"
    h, mr = pte.sharded_replay_np("clock2q+", d, cap, n_shards, device=CPU)
    assert (h, mr) == je.sharded_replay_np("clock2q+", d, cap, n_shards)


def test_sharded_replay_refuses_tiny_shards():
    d = _meta(0, 200)
    for fn in (je.sharded_replay, pte.sharded_replay):
        with pytest.raises(ValueError, match="too small"):
            fn("clock2q+", d, 11, 8)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_host_service_equals_lane_sharding_at_divisible_capacity(
        suite_prefixes, n_shards):
    """At a capacity divisible by the shard count, the host service is an
    exact oracle for the lanes: the same partition, the same shard
    capacity, the same Clock2Q+."""
    d = suite_prefixes[1]
    lanes = pte.sharded_replay("clock2q+", d, 96, n_shards, device=CPU)
    host = psharded.ShardedClock2QPlus(96, n_shards=n_shards).access_many(d)
    assert np.array_equal(lanes, host)


# -- streamed replays ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [7, 1_001, 50_000])
def test_replay_store_equal_reference(chunk):
    d = _meta(2, 3_000)
    ref_obs, port_obs = jobs.ObsSink(src="replay"), pobs.ObsSink(src="replay")
    want = je.replay_store("clock2q+", d, 80, chunk_size=chunk, obs=ref_obs)
    got = pte.replay_store("clock2q+", d, 80, chunk_size=chunk,
                           obs=port_obs, device=CPU)
    assert got == want
    a, b = _snap(port_obs.snapshot()), _snap(ref_obs.snapshot())
    assert a == b
    n_chunks = -(-d.size // chunk)
    assert [e["kind"] for e in a["events"]] == ["snapshot"] * n_chunks


def test_replay_store_universe_rules(tmp_path):
    from repro_torch.traceio.formats import save_trace
    from repro_torch.traceio.store import TraceStore

    d = _meta(0, 1_500)
    p = str(tmp_path / "t.npy")
    save_trace(p, d)
    assert pte.replay_store("clock2q+", TraceStore(p), 64, chunk_size=500,
                            device=CPU) == \
        je.replay_store("clock2q+", d, 64)
    with pytest.raises(ValueError, match="universe"):
        pte.replay_store("clock2q+", iter([d]), 64, device=CPU)


@pytest.mark.parametrize("chunk", [7, 911])
def test_prodcache_replay_equal_reference(chunk):
    d = _data(n=5_000, seed=12)
    ref, port = JProd(120), PProd(120)
    want = ref.replay(jiter_chunks(d, chunk))
    got = port.replay(piter_chunks(d, chunk))
    assert got == want == port.hits and port.misses == ref.misses
    for name in ("key", "block", "ref", "dirty", "gkey"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert port.flows == ref.flows
    whole = PProd(120)
    assert whole.replay(d) == got and np.array_equal(whole.key, port.key)

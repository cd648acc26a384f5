"""The port's profiler, online tuner and ``EngineCache``
(``repro_torch.tuning``, ``repro_torch.core.engine.host``) against the
reference's, on the CPU (the port's sweeps and lanes on their plain
versions).

The same numpy inputs go to both packages.  Sampling is bit-equal, the
sampled estimates are equal (integer hit counts turned into ratios:
tolerance 0), ``EngineCache`` hits are equal for every engine across a
live window retune, a cold fraction retune and a reference state carried
in, and ``OnlineTuner`` makes the same decisions, round for round, with
the same telemetry.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import traces as jtraces
from repro.core.engine import host as jhost
from repro.core.prodcache import ProdClock2QPlus as JProd
from repro.shardcache import ShardedClock2QPlus as JSharded
from repro.traceio import formats as jfmt
from repro.tuning import profiler as jprof
from repro.tuning import tuner as jtuner
from repro.tuning.sweep import SweepConfig as JConfig
from repro_torch.core import engine as peng
from repro_torch.core.engine import host as phost
from repro_torch.core.prodcache import ProdClock2QPlus as PProd
from repro_torch.shardcache import ShardedClock2QPlus as PSharded
from repro_torch.traceio.store import TraceStore
from repro_torch.tuning import profiler as pprof
from repro_torch.tuning import tuner as ptuner
from repro_torch.tuning.sweep import SweepConfig as PConfig

CPU = "cpu"


def _burst(n=24_000, seed=3) -> np.ndarray:
    return jtraces.correlated_burst_trace(n, universe=1 << 13, alpha=0.9,
                                          seed=seed)


def _grid(Config, caps=(48, 160), wfs=(0.1, 1.0), **kw):
    return [Config(c, wf, **kw) for c in caps for wf in wfs]


# -- sampling --------------------------------------------------------------------

def test_sampling_helpers_equal_reference():
    rng = np.random.default_rng(1)
    keys = np.concatenate([np.arange(4_000), rng.integers(0, 1 << 62, 4_000),
                           [(1 << 63) - 1]]).astype(np.int64)
    assert np.array_equal(pprof.mix64(keys), jprof.mix64(keys))
    for shift in range(0, 9):
        assert np.array_equal(pprof.sample_mask(keys, shift),
                              jprof.sample_mask(keys, shift))
        assert np.array_equal(pprof.sample_trace(keys, shift),
                              jprof.sample_trace(keys, shift))
        for cap in (1, 7, 64, 1_000, 99_999):
            assert pprof.scale_capacity(cap, shift) == \
                jprof.scale_capacity(cap, shift)
    ours = pprof.scaled_configs(_grid(PConfig, policy="s3fifo", bits=1), 3)
    theirs = jprof.scaled_configs(_grid(JConfig, policy="s3fifo", bits=1), 3)
    assert [dataclasses.asdict(c) for c in ours] == \
        [dataclasses.asdict(c) for c in theirs]
    chunks = [keys[i:i + 777] for i in range(0, keys.size, 777)]
    assert np.array_equal(pprof.sample_stream(chunks, 4),
                          jprof.sample_stream(chunks, 4))
    assert pprof.sample_stream([], 4).size == 0


def test_estimates_equal_reference(tmp_path):
    tr = _burst(8_000, seed=4)
    ours, theirs = _grid(PConfig), _grid(JConfig)
    want = jprof.estimate_sweep(tr, theirs, rate_shift=3)
    assert np.isfinite(want).all()
    assert np.array_equal(pprof.estimate_sweep(tr, ours, 3, device=CPU), want)
    for chunk in (13, 4_000):
        chunks = [tr[i:i + chunk] for i in range(0, tr.size, chunk)]
        assert np.array_equal(
            pprof.estimate_sweep_stream(chunks, ours, 3, device=CPU), want)
    p = str(tmp_path / "t.bin")
    jfmt.save_trace(p, tr)
    assert np.array_equal(pprof.estimate_sweep_store(
        TraceStore(p), ours, 3, chunk_size=5_000, device=CPU), want)
    mrc = pprof.estimate_mrc(tr, [48, 160], (0.1, 1.0), rate_shift=3,
                             device=CPU)
    assert mrc.shape == (2, 2)
    assert np.array_equal(mrc, jprof.estimate_mrc(tr, [48, 160], (0.1, 1.0),
                                                  rate_shift=3))
    # a sample with no key: the reference's NaNs, without a launch
    empty = np.asarray([1, 2, 3], np.int64)[:0]
    assert np.isnan(pprof.estimate_sweep(empty, ours, 3, device=CPU)).all()


# -- EngineCache -------------------------------------------------------------------

ENGINES = [("clock2q+", {}), ("clock2q", {}), ("s3fifo", dict(bits=1)),
           ("fifo", {}), ("clock", {}), ("lru", {})]


@pytest.mark.parametrize("policy,knobs", ENGINES, ids=[e[0] for e in ENGINES])
def test_engine_cache_equal_across_retunes(policy, knobs):
    d, u = jfmt.relabel(_burst(1_600, seed=6))
    ref = jhost.EngineCache(policy, 96, u, **knobs)
    port = phost.EngineCache(policy, 96, u, device=CPU, **knobs)
    assert port.tuning == ref.tuning and port.capacity == ref.capacity
    assert port.lane_skip_limit == ref.lane_skip_limit
    assert port.miss_ratio == ref.miss_ratio == 1.0
    batches = np.array_split(d, 4)

    def serve(batch):
        got, want = port.access_many(batch), ref.access_many(batch)
        assert got.dtype == want.dtype == bool and np.array_equal(got, want)
        assert (port.hits, port.misses) == (ref.hits, ref.misses)

    serve(batches[0])
    for cache in (ref, port):
        cache.retune(window_frac=0.2)           # live where it applies
    assert port.config == dataclasses.replace(port.config, **{
        k: getattr(ref.config, k) for k in ("window_frac", "small_frac")})
    serve(batches[1])
    for cache in (ref, port):
        cache.retune(small_frac=0.2, window_frac=0.7)   # cold re-init
    serve(batches[2])
    # a reference state carried in continues to the same hits
    port.state = peng.state_from_numpy(
        {k: np.asarray(v) for k, v in ref.state.items()}, device=CPU)
    serve(batches[3])
    assert port.access(int(d[0])) == ref.access(int(d[0]))
    assert port.miss_ratio == ref.miss_ratio
    assert port.tuning == ref.tuning
    with pytest.raises(ValueError, match="relabel"):
        port.access_many(np.asarray([u]))


def test_engine_cache_window_retune_is_in_place():
    port = phost.EngineCache("clock2q+", 200, 64, device=CPU)
    window = port.state["window"]
    port.retune(window_frac=1.0)
    assert port.state["window"] is window and int(window[0]) == 20
    port.retune(window_frac=1.0, ghost_frac=0.5)   # no change: no re-init
    assert port.state["window"] is window


# -- OnlineTuner -------------------------------------------------------------------

def _assert_decisions_equal(port, ref):
    assert len(port.decisions) == len(ref.decisions) >= 2
    for a, b in zip(port.decisions, ref.decisions):
        assert (a.at_access, a.n_sampled, a.rate_shift, a.applied) == \
            (b.at_access, b.n_sampled, b.rate_shift, b.applied)
        assert [dataclasses.asdict(c) for c in a.configs] == \
            [dataclasses.asdict(c) for c in b.configs]
        assert dataclasses.asdict(a.chosen) == dataclasses.asdict(b.chosen)
        assert np.array_equal(a.est_miss_ratios, b.est_miss_ratios,
                              equal_nan=True)
    sa, sb = dataclasses.asdict(port.obs.snapshot()), \
        dataclasses.asdict(ref.obs.snapshot())
    del sa["ts"], sb["ts"]
    assert sa == sb


def _drive(cache, tuner, tr, batch):
    for lo in range(0, tr.size, batch):
        keys = tr[lo:lo + batch]
        if hasattr(cache, "access_many"):
            cache.access_many(keys)
        else:
            cache.replay(keys)
        tuner.observe_many(keys)


# small mini-caches and samples keep the plain sweeps short on the CPU
TUNE = dict(window_fracs=(0.0, 0.3, 1.0), retune_every=4_000, rate_shift=2,
            min_gain=0.001, min_scaled_cap=8, min_samples=256)


def test_tuner_over_prodcache_decides_as_reference():
    tr = _burst(16_000, seed=3)
    cap = max(10, int(0.02 * jtraces.footprint(tr)))
    ref_cache, port_cache = JProd(cap, window_frac=0.0), \
        PProd(cap, window_frac=0.0)
    ref = jtuner.OnlineTuner(ref_cache, **TUNE)
    port = ptuner.OnlineTuner(port_cache, device=CPU, **TUNE)
    _drive(ref_cache, ref, tr, 2_500)
    _drive(port_cache, port, tr, 2_500)
    _assert_decisions_equal(port, ref)
    assert any(d.applied for d in port.decisions)
    assert port_cache.tuning == ref_cache.tuning
    assert (port_cache.hits, port_cache.misses) == \
        (ref_cache.hits, ref_cache.misses)
    assert np.array_equal(port.recent(), ref.recent())


def test_tuner_over_sharded_service_decides_as_reference():
    tr = _burst(12_000, seed=5)
    cap = 8 * max(4, int(0.02 * jtraces.footprint(tr)) // 8)
    ref_cache, port_cache = JSharded(cap, n_shards=4, window_frac=0.0), \
        PSharded(cap, n_shards=4, window_frac=0.0)
    ref = jtuner.OnlineTuner(ref_cache, **TUNE)
    port = ptuner.OnlineTuner(port_cache, device=CPU, **TUNE)
    _drive(ref_cache, ref, tr, 4_096)
    _drive(port_cache, port, tr, 4_096)
    _assert_decisions_equal(port, ref)
    assert port_cache.shard_stats() == ref_cache.shard_stats()
    assert port_cache.tuning == ref_cache.tuning


def test_tuner_over_s3fifo_engine_cache_decides_as_reference():
    d, u = jfmt.relabel(_burst(3_000, seed=8))
    ref_cache = jhost.EngineCache("s3fifo", 160, u, small_frac=0.05)
    port_cache = phost.EngineCache("s3fifo", 160, u, device=CPU,
                                   small_frac=0.05)
    kw = dict(small_fracs=(0.05, 0.1, 0.3), retune_every=1_500,
              rate_shift=3, min_gain=0.0, min_scaled_cap=8, min_samples=256)
    ref = jtuner.OnlineTuner(ref_cache, **kw)
    port = ptuner.OnlineTuner(port_cache, device=CPU, **kw)
    _drive(ref_cache, ref, d, 1_000)
    _drive(port_cache, port, d, 1_000)
    _assert_decisions_equal(port, ref)
    # s3fifo reads no window: the grid spans the small fractions alone,
    # and an applied decision re-inits the cache cold
    assert {c.window_frac for c in port.decisions[0].configs} == {0.5}
    assert sum(d.applied for d in port.decisions) >= 2
    assert port_cache.config == dataclasses.replace(
        port_cache.config, small_frac=ref_cache.config.small_frac)
    assert port_cache.config.small_frac != 0.05
    assert (port_cache.hits, port_cache.misses) == \
        (ref_cache.hits, ref_cache.misses)

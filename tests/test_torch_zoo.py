"""The port's pure-Python policy zoo and simulation drivers
(``repro_torch.core``: ``policy``, ``policies``, ``stats``, ``btree``)
against the reference's (``repro.core``), on the CPU.

The same seeded numpy traces go through both packages; every comparison
is exact (tolerance 0): hit for hit, resident count and membership at
the end, the recorded queue-flow events, and the drivers' results.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as pcore
from repro.core import btree as jbtree
from repro.core import stats as jstats
from repro.core import traces as jtraces
from repro_torch.core import btree as pbtree
from repro_torch.core import stats as pstats

N = 3000
CAPS = (16, 100)
SCENARIOS = ("w01-skewed", "ghost-thrash", "correlated-burst")
NAMES = jcore.policy_names()


def _trace(scenario: str, n: int = N, seed: int = 7) -> list:
    return [int(k) for k in jtraces.make_trace(scenario, n=n, seed=seed)[:n]]


def _dirty(i: int, key: int) -> bool:
    """A seeded-looking write pattern: about one request in five."""
    return (i * 7 + key * 13) % 5 == 0


def _pair(name: str, cap: int, trace, **kw):
    """The same policy from both packages, events recorded."""
    if name == "belady":
        kw = dict(kw, trace=trace)
    return (jcore.make_policy(name, cap, record_events=True, **kw),
            pcore.make_policy(name, cap, record_events=True, **kw))


def _assert_same_run(ref, pol, trace, dirty_fn=None, tail: int = 300):
    a = ref.run(trace, dirty_fn=dirty_fn)
    b = pol.run(trace, dirty_fn=dirty_fn)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert len(pol) == len(ref)
    end = trace[-tail:]
    assert [k in pol for k in end] == [k in ref for k in end]
    assert pol.events == ref.events
    assert pol.name == ref.name


def test_registry_equals_reference():
    assert pcore.policy_names() == NAMES
    with pytest.raises(KeyError):
        pcore.make_policy("no-such-policy", 10)
    with pytest.raises(ValueError):
        pcore.make_policy("lru", 0)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("name", NAMES)
def test_every_policy_hit_for_hit(name, scenario):
    """Every registered policy: hits per request, the end state's size
    and membership, and its event log."""
    trace = _trace(scenario)
    for cap in CAPS:
        ref, pol = _pair(name, cap, trace)
        hits_ref = [ref.access(k) for k in trace[:N // 2]]
        hits = [pol.access(k) for k in trace[:N // 2]]
        assert hits == hits_ref, (name, cap)
        # the rest through run(), which also stamps event times
        _assert_same_run(ref, pol, trace[N // 2:])


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("skip_limit", [None, 1, 3])
def test_s3fifo_knobs_and_skips_per_eviction(bits, skip_limit):
    trace = _trace("correlated-burst", seed=11)
    for cap in (10, 64):
        ref, pol = _pair("s3fifo", cap, trace, bits=bits,
                         skip_limit=skip_limit, ghost_frac=0.5)
        _assert_same_run(ref, pol, trace)
        assert pol.skipped_per_eviction == ref.skipped_per_eviction
        assert pol.skipped_per_eviction  # the main queue did evict


@pytest.mark.parametrize("dirty_mode", ["off", "simplified", "accurate"])
@pytest.mark.parametrize("flush", [dict(), dict(flush_after=50),
                                   dict(low_water=0.05, high_water=0.1)])
def test_clock2qplus_dirty_modes_and_flushers(dirty_mode, flush):
    trace = _trace("correlated-burst", seed=3)
    for cap in (20, 120):
        ref, pol = _pair("clock2q+", cap, trace, dirty_mode=dirty_mode,
                         skip_limit=4, **flush)
        _assert_same_run(ref, pol, trace, dirty_fn=_dirty)
        assert pol.flows == ref.flows
        assert list(pol.dirty_since.items()) == list(ref.dirty_since.items())
        assert pol.main.skipped_per_eviction == ref.main.skipped_per_eviction


@pytest.mark.parametrize("name", ["clock2q+a", "2q", "clock2q"])
def test_adaptive_and_two_q_family_with_writes(name):
    """clock2q+a's small-cache floors, and 2Q/Clock2Q under a dirty_fn
    (they take the write flag and ignore it, as the reference does)."""
    trace = _trace("w01-skewed", seed=5)
    for cap in (3, 9, 40, 200):
        ref, pol = _pair(name, cap, trace)
        _assert_same_run(ref, pol, trace, dirty_fn=_dirty)
        if name == "clock2q+a":
            assert (pol.small_cap, pol.window) == (ref.small_cap, ref.window)


def test_simulate_miss_ratios_and_improvement():
    trace = _trace("w01-skewed", seed=9)
    names = ["clock2q+", "s3fifo", "lru", "arc", "belady"]
    for cap in CAPS:
        for name in names:
            a = jstats.simulate(name, trace, cap, dirty_fn=_dirty)
            b = pstats.simulate(name, trace, cap, dirty_fn=_dirty)
            assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert pstats.miss_ratios(names, trace, cap) == \
            jstats.miss_ratios(names, trace, cap)
        assert pstats.improvement_vs_clock(names, trace, cap) == \
            jstats.improvement_vs_clock(names, trace, cap)
    sizes = [5, 30, 200]
    assert pstats.mrc("s3fifo", trace, sizes, bits=1) == \
        jstats.mrc("s3fifo", trace, sizes, bits=1)


@pytest.mark.parametrize("name,kw", [("clock2q+", {}), ("s3fifo", {}),
                                     ("2q", {}), ("lirs", {})])
def test_flow_nrd_and_next_use(name, kw):
    trace = _trace("correlated-burst", seed=2)
    a_res, a_counts, a_flows = jstats.flow_nrd(name, trace, 50, **kw)
    b_res, b_counts, b_flows = pstats.flow_nrd(name, trace, 50, **kw)
    assert dataclasses.asdict(b_res) == dataclasses.asdict(a_res)
    assert b_counts == a_counts and b_flows == a_flows
    assert a_counts  # some blocks moved
    nu = pstats.next_use_indices(trace)
    assert nu.dtype == np.int64
    assert np.array_equal(nu, jstats.next_use_indices(trace))


@pytest.mark.parametrize("fanout,universe", [(200, 0), (16, 3000), (7, 0)])
def test_btree_metadata_trace(fanout, universe):
    rng = np.random.default_rng(fanout)
    data = np.concatenate([rng.integers(0, 3000, 1500),
                           np.arange(1000, 1800)]).astype(np.int64)
    a = jbtree.btree_metadata_trace(data, fanout=fanout, universe=universe)
    b = pbtree.btree_metadata_trace(data, fanout=fanout, universe=universe)
    assert b.dtype == a.dtype and np.array_equal(b, a)
    ta, tb = jbtree.LeafBTree(fanout), pbtree.LeafBTree(fanout)
    for k in data.tolist():
        assert tb.lookup_or_insert(k) == ta.lookup_or_insert(k)
    assert tb.n_leaves == ta.n_leaves and tb.lower == ta.lower

"""The port's engine (``repro_torch.core.engine``) against the reference
(``repro.core.engine``), on the CPU, where the port runs the plain
version of its ``cache_sim`` kernel.

Inputs are made with numpy from a seed and handed to both packages; the
comparisons are exact (tolerance 0: these are integer state machines),
hit for hit and on every final state tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import jax_engine as je
from repro.core import make_policy
from repro.core import traces as jtraces
from repro.tuning.sweep import relabel as jrelabel
from repro_torch.core import engine as peng
from repro_torch.core import torch_engine as pte
from repro_torch.core import traces as ptraces
from repro_torch.core.policies.clock2qplus import Clock2QPlus

N = 2500          # requests per scenario, as tests/test_conformance.py
UNIVERSE = 4096   # shared dense-id space
CAPS = (20, 80, 320)
CPU = "cpu"


def _dense(scenario: str, n: int = N, seed: int = 13) -> np.ndarray:
    tr = jtraces.make_trace(scenario, n=n, seed=seed)[:n]
    dense, n_unique = jrelabel(tr)
    assert n_unique <= UNIVERSE, (scenario, n_unique)
    return dense


def _jax_run(specs, rows, universe=UNIVERSE):
    """Reference: one lane per (policy, capacity, knobs) spec, padded to
    the grid maxima, each lane replaying its own row."""
    cfgs = [jeng.get_engine(p).config(c, **kw) for p, c, kw in specs]
    phys = tuple(int(x) for x in np.max(
        [jeng.get_engine(c.policy).sizes_fn(c) for c in cfgs], axis=0))
    states = [jeng.get_engine(c.policy).init_config(c, universe, phys)
              for c in cfgs]
    st = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    st, hits = je.replay_batch("clock2q+", st,
                               jnp.asarray(np.stack(rows), jnp.int32))
    return {k: np.asarray(v) for k, v in st.items()}, np.asarray(hits)


def _port_run(specs, rows, universe=UNIVERSE):
    cfgs = [peng.get_engine(p).config(c, **kw) for p, c, kw in specs]
    st = peng.grid_init(cfgs, universe, device=CPU)
    st, hits = pte.replay_batch("clock2q+", st, np.stack(rows))
    return peng.state_to_numpy(st), hits.numpy()


def _assert_same(ref_state, ref_hits, state, hits):
    assert hits.shape == ref_hits.shape
    bad = np.argwhere(hits != ref_hits)
    assert bad.size == 0, f"{len(bad)} hits differ, first (lane, t) {bad[:3]}"
    assert set(state) == set(ref_state)
    for k in ref_state:
        assert state[k].dtype == ref_state[k].dtype, k
        assert np.array_equal(state[k], ref_state[k]), k


def test_every_scenario_and_capacity_as_lanes_of_one_replay():
    """Every registered scenario x caps 20/80/320: 66 lanes, one batched
    replay on each side."""
    specs, rows = [], []
    for sc in jtraces.scenario_names():
        d = _dense(sc)
        # a few generators emit fewer than N requests: pad with the no-op
        # key -1 (the padding sentinel of both engines)
        d = np.concatenate([d, np.full(N - d.size, -1, np.int32)])
        for cap in CAPS:
            specs.append(("clock2q+", cap, {}))
            rows.append(d)
    ref = _jax_run(specs, rows)
    got = _port_run(specs, rows)
    _assert_same(*ref, *got)


def test_padded_mixed_grid_with_skip_limit_and_clock2q_lanes():
    d = _dense("correlated-burst")
    specs = [("clock2q+", c, dict(skip_limit=s, window_frac=w))
             for c in (16, 50, 200) for s in (0, 1, 4) for w in (0.0, 1.0)]
    specs += [("clock2q", c, dict(skip_limit=s))
              for c in (24, 120) for s in (0, 3)]
    specs += [("clock2q+", 90, dict(small_frac=0.3, ghost_frac=1.0))]
    rows = [d] * len(specs)
    ref = _jax_run(specs, rows)
    got = _port_run(specs, rows)
    _assert_same(*ref, *got)


@pytest.mark.parametrize("chunk_size", [1, 7, 1001])
def test_chunked_equals_single_shot(chunk_size):
    """CAP 120 gives S=12, window 6: chunks of 7 straddle the correlation
    window; chunk size 1 carries the state across every request."""
    n = 600 if chunk_size == 1 else N
    d = _dense("w03-seqheavy", n=n, seed=21)
    uni = int(d.max()) + 1
    h_ref, _ = je.replay_np("clock2q+", d, 120, universe=uni)
    st_ref = pte.init_state("clock2q+", 120, uni, device=CPU)
    _, hits = pte.replay("clock2q+", st_ref, d)
    assert int(hits.sum()) == h_ref
    h, n_done, st = pte.replay_chunked(
        "clock2q+", (d[i:i + chunk_size] for i in range(0, n, chunk_size)),
        120, uni, device=CPU)
    assert (h, n_done) == (h_ref, n)
    for k in st_ref:
        assert torch.equal(st[k], st_ref[k]), k


@pytest.mark.parametrize("layout", ["single", "grid"])
def test_jax_state_carried_mid_trace(layout):
    """A reference state from mid-trace, carried across with
    ``state_from_numpy``, continues in the port as it does in JAX."""
    d = _dense("ghost-thrash")
    cut = 1234
    if layout == "single":
        st = je.init_state("clock2q+", 80, UNIVERSE, skip_limit=2)
        st, _ = je.replay("clock2q+", st, jnp.asarray(d[:cut]))
        mid = {k: np.asarray(v) for k, v in st.items()}
        st, hits = je.replay("clock2q+", st, jnp.asarray(d[cut:]))
        ref_hits = np.asarray(hits)[None]
    else:
        cfgs = [jeng.SweepConfig(c, window_frac=w)
                for c in (30, 300) for w in (0.1, 1.0)]
        st = jeng.grid_init(cfgs, UNIVERSE)
        rows = jnp.asarray(np.stack([d] * len(cfgs)))
        st, _ = je.replay_batch("clock2q+", st, rows[:, :cut])
        mid = {k: np.asarray(v) for k, v in st.items()}
        st, hits = je.replay_batch("clock2q+", st, rows[:, cut:])
        ref_hits = np.asarray(hits)
    ref = {k: np.asarray(v) for k, v in st.items()}
    if layout == "single":
        ref = {k: v[None] for k, v in ref.items()}
    pst = peng.state_from_numpy(mid, device=CPU)
    pst, phits = peng.replay("clock2q+", pst, d[cut:])
    _assert_same(ref, ref_hits, peng.state_to_numpy(pst), phits.numpy())


def test_state_round_trips_through_numpy():
    st = pte.init_state("clock2q", 64, 512, device=CPU)
    arrays = peng.state_to_numpy(st)
    back = peng.state_from_numpy(arrays, device=CPU)
    assert all(torch.equal(back[k], st[k]) for k in st)
    # the port advances its copy in place; the source arrays stay as given
    peng.replay("clock2q", back, np.arange(300) % 200)
    assert not back["skey"].eq(-1).all() and (arrays["skey"] == -1).all()
    with pytest.raises(ValueError):
        peng.state_from_numpy({"skey": np.zeros(3, np.int32)}, device=CPU)


def _corrupt(arrays, what):
    """One value the kernel would index out of its lane's row with."""
    a = {k: v.copy() for k, v in arrays.items()}
    if what == "spos":
        a["spos"][1] = a["scap"][1]
    elif what == "hand":
        a["hand"][0] = a["mcap"][0] + 3
    elif what == "gpos":
        a["gpos"][1] = -1
    elif what == "cap":
        a["mcap"][0] = a["mkey"].shape[1] + 1
    elif what == "ring_key":
        a["gkey"][0, 0] = a["loc_w"].shape[1]
    elif what == "loc_w":
        a["loc_w"][1, 7] = 4
    elif what == "loc_s":
        # a resident key whose slot lies in the padding of its lane's ring
        lane, key = np.argwhere(a["loc_w"] == jeng.W_SMALL)[0]
        a["loc_s"][lane, key] = a["scap"][lane]
    elif what == "skip_limit":
        a["skip_limit"][0] = -2
    return a


@pytest.mark.parametrize("what", ["spos", "hand", "gpos", "cap", "ring_key",
                                  "loc_w", "loc_s", "skip_limit"])
def test_state_from_numpy_rejects_out_of_range_values(what):
    """A state from outside is held to the layout once, where it enters:
    the kernel does not check cursors and slots per request."""
    cfgs = [jeng.SweepConfig(c) for c in (30, 300)]
    st = jeng.grid_init(cfgs, UNIVERSE)
    st, _ = je.replay_batch("clock2q+", st,
                            jnp.asarray(np.stack([_dense("zipf")] * 2)))
    good = {k: np.asarray(v) for k, v in st.items()}
    assert all(torch.equal(peng.state_from_numpy(good, device=CPU)[k],
                           torch.tensor(good[k])) for k in good)
    with pytest.raises(ValueError):
        peng.state_from_numpy(_corrupt(good, what), device=CPU)


def test_registry_matches_reference():
    assert peng.engine_names() == jeng.engine_names() == [
        "clock", "clock2q", "clock2q+", "fifo", "lru", "s3fifo"]
    for name in peng.engine_names():
        p, r = peng.get_engine(name), jeng.get_engine(name)
        assert p.knobs == r.knobs and dict(p.preset) == dict(r.preset)
        assert dataclasses.asdict(p.config(100)) == \
            dataclasses.asdict(r.config(100))


def test_replay_np_and_lane_hits_match_reference():
    d = _dense("zipf")
    assert pte.replay_np("clock2q+", d, 80, device=CPU) == \
        je.replay_np("clock2q+", d, 80)
    cfg = dict(capacity=50, window_frac=1.0, skip_limit=3)
    got = peng.lane_hits(d, peng.SweepConfig(**cfg), UNIVERSE, device=CPU)
    ref = jeng.lane_hits(d, jeng.SweepConfig(**cfg), UNIVERSE)
    assert got.dtype == bool and np.array_equal(got, ref)


def test_replay_chunked_rejects_keys_outside_the_universe():
    with pytest.raises(ValueError, match="outside"):
        pte.replay_chunked("clock2q+", [np.array([0, 5, 9])], 8, 9,
                           device=CPU)
    with pytest.raises(ValueError, match="outside"):
        pte.replay_chunked("clock2q+", [np.array([0, -2])], 8, 9, device=CPU)


@pytest.mark.parametrize("scenario", jtraces.scenario_names())
def test_port_traces_equal_reference(scenario):
    a = ptraces.make_trace(scenario, n=3000, seed=5)
    b = jtraces.make_trace(scenario, n=3000, seed=5)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ptraces.footprint(a) == jtraces.footprint(b)
    assert ptraces.suite_capacity(a) == jtraces.suite_capacity(b)


def test_port_suite_equals_reference():
    assert [dataclasses.asdict(s) for s in ptraces.SUITE] == \
        [dataclasses.asdict(s) for s in jtraces.SUITE]
    assert ptraces.scenario_names() == jtraces.scenario_names()
    for ps, js in zip(ptraces.SUITE, jtraces.SUITE):
        ps, js = (dataclasses.replace(s, n=4000) for s in (ps, js))
        assert np.array_equal(ps.data(), js.data()), ps.name
        assert np.array_equal(ps.metadata(), js.metadata()), ps.name


@pytest.mark.parametrize("scenario,kw", [
    ("w01-skewed", {}), ("ghost-thrash", {}),
    ("correlated-burst", dict(skip_limit=2, window_frac=1.0))])
def test_port_oracle_equals_reference_oracle(scenario, kw):
    d = jtraces.make_trace(scenario, n=6000, seed=13)[:6000].tolist()
    for cap in CAPS:
        ref = make_policy("clock2q+", cap, **kw)
        pol = Clock2QPlus(cap, **kw)
        assert [pol.access(k) for k in d] == [ref.access(k) for k in d], cap
        assert len(pol) == len(ref)
        assert [k in pol for k in d[-200:]] == [k in ref for k in d[-200:]]

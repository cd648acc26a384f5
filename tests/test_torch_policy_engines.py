"""The port's S3-FIFO, FIFO, Clock and LRU engines
(``repro_torch.core.engine``) against the reference's
(``repro.core.engine``), on the CPU, where the port runs the plain
versions of its ``s3fifo_sim`` and ``simple_sim`` kernels.

Inputs are made with numpy from a seed and handed to both packages.  The
comparisons are exact (tolerance 0: integer state machines): hit for hit
and on every state tensor, whole, chunked, and carried across from a JAX
state mid-trace.  Several configurations run as lanes of one padded grid
to keep the CPU time down.  Last, a differential fuzz holds every port
engine against the port's own zoo at random knob points, with the
sampler of ``tests/test_engine_fuzz.py``.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import jax_engine as je
from repro.core import traces as jtraces
from repro.tuning import sweep as jsweep
from repro.tuning.sweep import relabel as jrelabel
from repro_torch.core import engine as peng
from repro_torch.core import make_policy
from repro_torch.core import torch_engine as pte
from repro_torch.tuning import sweep as psweep
from test_engine_fuzz import (
    UNIVERSE as FUZZ_UNIVERSE, _engine_overrides, _sample_point, _trace,
    _zoo_kwargs,
)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
N = 2000
UNIVERSE = 2048
CPU = "cpu"
FAMILIES = ("s3fifo", "fifo", "clock", "lru")
# Lanes of one padded grid a family: mixed capacities, S3-FIFO's bits and
# skip limits (0 = unlimited), sizes that a skip limit reaches past.
GRIDS = {
    "s3fifo": [dict(capacity=c, bits=b, skip_limit=s)
               for c in (9, 120) for b in (1, 2) for s in (0, 1, 3)]
    + [dict(capacity=40, small_frac=0.3, ghost_frac=0.5, skip_limit=200)],
    "fifo": [dict(capacity=c) for c in (1, 30, 300)],
    "clock": [dict(capacity=c) for c in (1, 30, 300)],
    "lru": [dict(capacity=c) for c in (1, 30, 300)],
}


def _dense(scenario: str, n: int = N, seed: int = 13) -> np.ndarray:
    tr = jtraces.make_trace(scenario, n=n, seed=seed)[:n]
    dense, n_unique = jrelabel(tr)
    assert n_unique <= UNIVERSE, (scenario, n_unique)
    return dense


def _jax_grid(family, specs, rows, universe=UNIVERSE):
    cfgs = [jeng.get_engine(family).config(**kw) for kw in specs]
    st = jeng.grid_init(cfgs, universe)
    st, hits = je.replay_batch(family, st, jnp.asarray(np.stack(rows)))
    return {k: np.asarray(v) for k, v in st.items()}, np.asarray(hits)


def _port_grid(family, specs, rows, universe=UNIVERSE):
    cfgs = [peng.get_engine(family).config(**kw) for kw in specs]
    st = peng.grid_init(cfgs, universe, device=CPU)
    st, hits = pte.replay_batch(family, st, np.stack(rows))
    return peng.state_to_numpy(st), hits.numpy()


def _assert_same(ref_state, ref_hits, state, hits):
    assert hits.shape == ref_hits.shape
    bad = np.argwhere(hits != ref_hits)
    assert bad.size == 0, f"{len(bad)} hits differ, first (lane, t) {bad[:3]}"
    assert set(state) == set(ref_state)
    for k in ref_state:
        assert state[k].dtype == ref_state[k].dtype, k
        assert np.array_equal(state[k], ref_state[k]), k


@pytest.mark.parametrize("family", FAMILIES)
def test_padded_grid_equals_reference(family):
    """Every lane of the family's grid, one trace row a lane (two
    scenarios, padding keys in one)."""
    specs = GRIDS[family]
    a, b = _dense("correlated-burst"), _dense("w04-scans", seed=3)
    b = b.copy()
    b[::53] = -1
    rows = [(a, b)[i % 2] for i in range(len(specs))]
    _assert_same(*_jax_grid(family, specs, rows),
                 *_port_grid(family, specs, rows))


@pytest.mark.parametrize("chunk_size", [1, 7, 1001])
@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_equals_single_shot(family, chunk_size):
    n = 300 if chunk_size == 1 else N
    d = _dense("w03-seqheavy", n=n, seed=21)
    uni = int(d.max()) + 1
    kw = dict(bits=1, skip_limit=2) if family == "s3fifo" else {}
    h_ref, _ = je.replay_np(family, d, 40, universe=uni, **kw)
    st_ref = pte.init_state(family, 40, uni, device=CPU, **kw)
    _, hits = pte.replay(family, st_ref, d)
    assert int(hits.sum()) == h_ref
    h, n_done, st = pte.replay_chunked(
        family, (d[i:i + chunk_size] for i in range(0, n, chunk_size)),
        40, uni, device=CPU, **kw)
    assert (h, n_done) == (h_ref, n)
    for k in st_ref:
        assert torch.equal(st[k], st_ref[k]), k


@pytest.mark.parametrize("layout", ["single", "grid"])
@pytest.mark.parametrize("family", FAMILIES)
def test_jax_state_carried_mid_trace(family, layout):
    """A reference state from mid-trace, carried across with
    ``state_from_numpy``, continues in the port as it does in JAX."""
    d = _dense("ghost-thrash")
    cut = 1234
    if layout == "single":
        kw = dict(skip_limit=2) if family == "s3fifo" else {}
        st = je.init_state(family, 80, UNIVERSE, **kw)
        st, _ = je.replay(family, st, jnp.asarray(d[:cut]))
        mid = {k: np.asarray(v) for k, v in st.items()}
        st, hits = je.replay(family, st, jnp.asarray(d[cut:]))
        ref = {k: np.asarray(v)[None] for k, v in st.items()}
        ref_hits = np.asarray(hits)[None]
    else:
        specs = GRIDS[family][:4]
        cfgs = [jeng.get_engine(family).config(**kw) for kw in specs]
        st = jeng.grid_init(cfgs, UNIVERSE)
        rows = jnp.asarray(np.stack([d] * len(cfgs)))
        st, _ = je.replay_batch(family, st, rows[:, :cut])
        mid = {k: np.asarray(v) for k, v in st.items()}
        st, hits = je.replay_batch(family, st, rows[:, cut:])
        ref = {k: np.asarray(v) for k, v in st.items()}
        ref_hits = np.asarray(hits)
    assert peng.state_family(mid) == family
    pst = peng.state_from_numpy(mid, device=CPU)
    pst, phits = peng.replay(family, pst, d[cut:])
    _assert_same(ref, ref_hits, peng.state_to_numpy(pst), phits.numpy())


def _mid_state(family):
    """A reference grid state (two lanes) partway through a trace."""
    cfgs = [jeng.get_engine(family).config(c) for c in (30, 300)]
    st = jeng.grid_init(cfgs, UNIVERSE)
    st, _ = je.replay_batch(family, st,
                            jnp.asarray(np.stack([_dense("zipf")] * 2)))
    return {k: np.asarray(v).copy() for k, v in st.items()}


def _first(a, code):
    return tuple(np.argwhere(a["loc_w"] == code)[0])


CORRUPT = {  # family: {what: one value the kernel would index out of range}
    "s3fifo": {
        "spos": lambda a: a["spos"].__setitem__(1, a["scap"][1]),
        "mhead": lambda a: a["mhead"].__setitem__(0, -1),
        "mcount": lambda a: a["mcount"].__setitem__(0, a["mcap"][0] + 1),
        "gpos": lambda a: a["gpos"].__setitem__(1, a["gcap"][1] + 2),
        "cap": lambda a: a["mcap"].__setitem__(0, a["mkey"].shape[1] + 1),
        "ring_key": lambda a: a["gkey"].__setitem__((0, 0),
                                                    a["loc_w"].shape[1]),
        "loc_w": lambda a: a["loc_w"].__setitem__((1, 7), 4),
        "loc_s": lambda a: a["loc_s"].__setitem__(
            _first(a, jeng.W_MAIN), a["mcap"][_first(a, jeng.W_MAIN)[0]]),
        "freq": lambda a: a["mfreq"].__setitem__((1, 0), 4),
    },
    "fifo": {
        "pos": lambda a: a["pos"].__setitem__(0, a["cap"][0]),
        "cap": lambda a: a["cap"].__setitem__(1, a["keys"].shape[1] + 1),
        "ring_key": lambda a: a["keys"].__setitem__((1, 0), UNIVERSE),
    },
    "clock": {
        "hand": lambda a: a["hand"].__setitem__(1, -3),
        "cap": lambda a: a["cap"].__setitem__(0, 0),
        "ring_key": lambda a: a["keys"].__setitem__((0, 2), -2),
        "loc": lambda a: a["loc"].__setitem__((0, 5), a["cap"][0]),
    },
    "lru": {
        "t": lambda a: a["t"].__setitem__(0, -1),
        "cap": lambda a: a["cap"].__setitem__(0, a["keys"].shape[1] + 1),
        "ring_key": lambda a: a["keys"].__setitem__((1, 3), UNIVERSE + 5),
        "loc": lambda a: a["loc"].__setitem__((1, 9), a["cap"][1] + 1),
    },
}


@pytest.mark.parametrize("family,what", [(f, w) for f in FAMILIES
                                         for w in CORRUPT[f]])
def test_state_from_numpy_rejects_out_of_range_values(family, what):
    """A state from outside is held to its family's layout once, where it
    enters: the kernels do not check cursors and slots per request."""
    good = _mid_state(family)
    back = peng.state_from_numpy(good, device=CPU)
    assert all(torch.equal(back[k], torch.tensor(good[k])) for k in good)
    bad = {k: v.copy() for k, v in good.items()}
    CORRUPT[family][what](bad)
    with pytest.raises(ValueError):
        peng.state_from_numpy(bad, device=CPU)


def test_state_from_numpy_rejects_unknown_layouts():
    with pytest.raises(ValueError, match="no engine's layout"):
        peng.state_from_numpy({"keys": np.zeros(3, np.int32)}, device=CPU)


def test_registry_and_grid_rules():
    assert peng.engine_names() == jeng.engine_names()
    cfgs = [peng.get_engine(p).config(50) for p in ("s3fifo", "lru")]
    with pytest.raises(ValueError, match="step family"):
        peng.grid_init(cfgs, 100, device=CPU)
    # clock2q+ and clock2q share one step: one grid may hold both
    both = [peng.get_engine(p).config(50) for p in ("clock2q+", "clock2q")]
    assert peng.grid_init(both, 100, device=CPU)["scap"].tolist() == [5, 12]


def test_mixed_grid_of_all_six_engines_equals_reference_sweep():
    tr = jtraces.derive_metadata(jtraces.SUITE[2].data())[:1000]
    grid = [("clock2q+", 40, {}), ("clock2q", 40, {}), ("s3fifo", 40, {}),
            ("s3fifo", 40, dict(bits=1, skip_limit=2)), ("fifo", 40, {}),
            ("clock", 12, {}), ("lru", 40, {}), ("s3fifo", 9, {}),
            ("lru", 9, {}), ("clock2q+", 120, dict(skip_limit=2))]
    pg = [psweep.get_engine(p).config(c, **kw) for p, c, kw in grid]
    jg = [jsweep.get_engine(p).config(c, **kw) for p, c, kw in grid]
    ref = jsweep.sweep_hits(tr, jg)
    assert np.array_equal(psweep.sweep_hits(tr, pg, device=CPU), ref)
    assert np.array_equal(psweep.serial_sweep_hits(tr, pg, device=CPU), ref)
    # make_grid builds S3-FIFO configs directly, with the sweep defaults
    # (ghost_frac 0.5), as the reference does
    kw = dict(policy="s3fifo", bits=1)
    assert [vars(c) for c in psweep.make_grid([30, 60], **kw)] == \
        [vars(c) for c in jsweep.make_grid([30, 60], **kw)]
    got = psweep.lane_hits(jrelabel(tr)[0], pg[3], device=CPU)
    assert np.array_equal(got, jsweep.lane_hits(jrelabel(tr)[0], jg[3]))


@pytest.mark.parametrize("module", ["cache_sim", "s3fifo_sim", "simple_sim"])
def test_kernel_wrapper_imports_first(module):
    """A wrapper module imported before the engine package (which imports
    every wrapper to register it) loads: no import cycle."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(SRC)!r})\n"
            f"import repro_torch.kernels.{module}.ops as o\n"
            "import repro_torch.core.engine as e\n"
            "print(len(e.engine_names()))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "6"


# -- differential fuzz against the port's own zoo ----------------------------

FUZZ_SEEDS = range(8)


@pytest.fixture(scope="module")
def fuzz_lanes():
    """Per policy, the 8 sampled points of ``tests/test_engine_fuzz.py``
    (its non-hypothesis seeds) as the lanes of one padded grid, each lane
    replaying its own trace: hits (8, T) and the points."""
    out = {}
    policies = peng.engine_names()
    for policy in policies:
        eng = peng.get_engine(policy)
        cfgs, rows, points = [], [], []
        for seed in FUZZ_SEEDS:
            rng = np.random.default_rng(seed + 1000 * policies.index(policy))
            p = _sample_point(rng)
            cfgs.append(eng.config(p["capacity"],
                                   **_engine_overrides(eng, policy, p)))
            rows.append(_trace(rng, p["capacity"]))
            points.append(p)
        st = peng.grid_init(cfgs, FUZZ_UNIVERSE, device=CPU)
        _, hits = peng.replay(policy, st, np.stack(rows))
        out[policy] = (hits.numpy(), rows, points, cfgs)
    return out


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
@pytest.mark.parametrize("policy", sorted(["clock", "clock2q", "clock2q+",
                                           "fifo", "lru", "s3fifo"]))
def test_engine_matches_port_zoo_fuzz(fuzz_lanes, policy, seed):
    hits, rows, points, cfgs = fuzz_lanes[policy]
    p, trace = points[seed], rows[seed]
    ref = make_policy(policy, p["capacity"], **_zoo_kwargs(policy, p))
    ref_hits = np.fromiter((ref.access(int(k)) for k in trace), bool,
                           len(trace))
    where = np.nonzero(hits[seed] != ref_hits)[0]
    assert where.size == 0, (
        f"{policy} diverges from the port's zoo at request {where[:5]} "
        f"(of {where.size}) for {dataclasses.asdict(cfgs[seed])}")

"""The plain-Python parts of the ``s3fifo_sim`` and ``simple_sim``
wrappers, on the CPU: each family's per-lane planner (where the kernel
keeps a lane) at the 16 SUITE sweeps' real sizes, the LRU wrapper's one
refusal, and a pure-Python model of the LRU kernel's victim order -- the
start run sorted by (last, index), the log of accesses appended a window
at a time, the two live fronts and the stream compaction -- held against
the plain ``lru_step``'s argmin on padded grids, on states carried in
from JAX mid-fill, and on crafted states with ties and ages at or above
``t``.  Nothing here needs a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import jax_engine as je
from repro_torch.core import engine as peng
from repro_torch.core import traces
from repro_torch.core.engine.simple import lru_step
from repro_torch.kernels import lanes
from repro_torch.kernels.s3fifo_sim import ops as s3ops
from repro_torch.kernels.simple_sim import ops as smops
from repro_torch.tuning.sweep import relabel

# chip_smoke.py's comparison sweep: capacities as fractions of the footprint
SWEEP_FRACS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5)
FAMILIES = ("s3fifo", "fifo", "clock", "lru")
DATA = [s.name for s in traces.SUITE]
META = [n + "/meta" for n in DATA]


@pytest.fixture(scope="module")
def suite_sizes():
    """Per SUITE trace and its metadata trace: the sweep's capacities and
    K (the relabelled ids are below the unique count)."""
    out = {}
    for spec in traces.SUITE:
        d = spec.data()
        for name, tr in ((spec.name, d),
                         (spec.name + "/meta", traces.derive_metadata(d))):
            fp = traces.footprint(tr)
            _, u = relabel(tr)
            out[name] = ([max(8, int(fp * f)) for f in SWEEP_FRACS], u)
    return out


def _s3_sizes(caps):
    """(S, M, G) of the comparison's S3-FIFO lanes, 2- and 1-bit."""
    eng = peng.get_engine("s3fifo")
    return [eng.sizes_fn(eng.config(c, bits=b)) for b in (2, 1)
            for c in caps]


def _plan(family, caps, K):
    if family == "s3fifo":
        return s3ops.plan_launch(*zip(*_s3_sizes(caps)), K)
    return smops.plan_launch(family, caps, K)


def _tier_bytes(family, caps, K):
    """Per lane, the bytes of each tier the family's planner tries, in
    its order of preference."""
    if family == "s3fifo":
        return [[s3ops.ring_bytes(S, M, G) + s3ops.table_bytes(K),
                 s3ops.ring_bytes(S, M, G), s3ops.small_bytes(S, G)]
                for S, M, G in _s3_sizes(caps)]
    return [[smops.ring_bytes(family, c) + smops.table_bytes(family, K),
             smops.ring_bytes(family, c)] for c in caps]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", META)
def test_every_metadata_lane_lives_whole_in_shared_memory(name, family,
                                                          suite_sizes):
    caps, K = suite_sizes[name]
    plan = _plan(family, caps, K)
    assert plan.tiers == [lanes.TIER_WHOLE] * len(plan.tiers)
    largest = max(b[0] for b in _tier_bytes(family, caps, K))
    assert plan.smem_bytes == largest + lanes.TRACE_BYTES <= lanes.SMEM_BLOCK
    assert plan.blocks_per_sm == lanes.blocks_per_sm(plan.smem_bytes) >= 2


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", DATA)
def test_data_lanes_keep_what_fits(name, family, suite_sizes):
    """Each data lane's tier is the first of its family's order whose
    bytes fit one block beside the trace ring; no plan passes the
    232,448 bytes a block may use."""
    caps, K = suite_sizes[name]
    plan = _plan(family, caps, K)
    order = ([lanes.TIER_WHOLE, lanes.TIER_RINGS, lanes.TIER_SMALL]
             if family == "s3fifo" else [lanes.TIER_WHOLE, lanes.TIER_RINGS])
    for fits, tier in zip(_tier_bytes(family, caps, K), plan.tiers):
        first = next((t for t, b in zip(order, fits)
                      if b + lanes.TRACE_BYTES <= lanes.SMEM_BLOCK),
                     lanes.TIER_GLOBAL)
        assert tier == first
    assert plan.smem_bytes <= lanes.SMEM_BLOCK


@pytest.mark.parametrize("family,cap,K,tier,smem", [
    ("fifo", 1000, 4096, lanes.TIER_WHOLE, 4 * 1000 + 4096),
    ("fifo", 1000, 262_144, lanes.TIER_RINGS, 4 * 1000),
    ("fifo", 60_000, 262_144, lanes.TIER_GLOBAL, 0),
    ("clock", 1000, 4096, lanes.TIER_WHOLE, 5 * 1000 + 4 * 4096),
    ("clock", 1000, 65_536, lanes.TIER_RINGS, 5 * 1000),
    ("clock", 50_000, 65_536, lanes.TIER_GLOBAL, 0),
    ("lru", 1000, 4096, lanes.TIER_WHOLE,
     12 * 1000 + 4 * (2 * 1000 + 64) + 4 * 4096),
    ("lru", 2000, 65_536, lanes.TIER_RINGS, 12 * 2000 + 4 * (2 * 2000 + 64)),
    ("lru", 12_000, 65_536, lanes.TIER_GLOBAL, 0),
])
def test_simple_plan_lane_bytes_and_tier(family, cap, K, tier, smem):
    p = smops.plan_lane(family, cap, K)
    assert (p.tier, p.smem_bytes) == (tier, smem + lanes.TRACE_BYTES)
    assert p.blocks_per_sm == lanes.blocks_per_sm(smem + lanes.TRACE_BYTES)


@pytest.mark.parametrize("S,M,G,K,tier,smem", [
    (10, 90, 100, 1000, lanes.TIER_WHOLE, 80 + 720 + 400 + 5000),
    (200, 1800, 2000, 65_536, lanes.TIER_RINGS, 1600 + 14_400 + 8000),
    (3000, 27_000, 30_000, 131_072, lanes.TIER_SMALL, 24_000 + 120_000),
    (6000, 54_000, 60_000, 262_144, lanes.TIER_GLOBAL, 0),
])
def test_s3fifo_plan_lane_bytes_and_tier(S, M, G, K, tier, smem):
    p = s3ops.plan_lane(S, M, G, K)
    assert (p.tier, p.smem_bytes) == (tier, smem + lanes.TRACE_BYTES)


def test_a_mixed_grid_takes_the_largest_lane_s_bytes():
    plan = smops.plan_launch("lru", [64, 5000, 12_000], 40_000)
    assert plan.tiers == [lanes.TIER_WHOLE, lanes.TIER_RINGS,
                          lanes.TIER_GLOBAL]
    assert plan.smem_bytes == (smops.ring_bytes("lru", 64)
                               + smops.table_bytes("lru", 40_000)
                               + lanes.TRACE_BYTES)
    assert lanes.tier_counts(plan.tiers) == [1, 1, 0, 1]


def test_the_plan_of_a_state_reads_its_key_range():
    """K is 1 + the largest key of the trace and of the ring: a wide key
    pushes a small lane out of the whole tier."""
    st = peng.grid_init([peng.get_engine("clock").config(100)], 70_000,
                        device="cpu")
    small = torch.tensor([1, 2, 3], dtype=torch.int32)
    view = smops.host_view("clock", st, small)
    assert smops.plan_view("clock", view).tiers == [lanes.TIER_WHOLE]
    st["keys"][0, 5] = 69_999
    view = smops.host_view("clock", st, small)
    assert lanes.key_range(view) == 70_000
    assert smops.plan_view("clock", view).tiers == [lanes.TIER_RINGS]


@pytest.mark.parametrize("over", [0, 1])
def test_lru_refuses_timestamps_that_would_wrap(over):
    """The kernel's log keeps accesses in timestamp order: ``t + T`` must
    stay within int32 (the plain step's own ``t`` would wrap past it).
    At the limit the launch runs; one past it, the wrapper raises, on the
    CPU as on the card."""
    T = 16
    st = peng.grid_init([peng.get_engine("lru").config(4)], 64, device="cpu")
    st["t"][0] = 2**31 - 1 - T + over
    trace = torch.arange(T, dtype=torch.int32)
    if over:
        with pytest.raises(ValueError, match="wrap"):
            smops.lru_sim(st, trace)
    else:
        assert int(smops.lru_sim(st, trace, "counts")[0]) == 0
        assert int(st["t"][0]) == 2**31 - 1


# -- the LRU kernel's victim order, modelled in Python -------------------------


class LruLane:
    """One lane of ``csrc/simple_sim.cu``'s LRU kernel, as the kernel
    orders it: the start run S (slots sorted by (last, index)), the log L
    (each access's slot, in timestamp order; of repeated hits between two
    misses of a window only the last), ``qpos`` (the position of each
    slot's one live entry in the buffer that holds S then L), the victim
    as the smaller (last, index) of the two live fronts, and the live
    entries compacted to the buffer's front, S's then L's, when a window
    could overrun it."""

    def __init__(self, keys, last, t, loc, cap):
        self.cap, self.n = cap, smops.log_entries(cap)
        self.keys, self.last = list(keys[:cap]), list(last[:cap])
        self.t, self.loc = int(t), list(loc)
        order = sorted(range(cap), key=lambda s: (self.last[s], s))
        self.q = order + [None] * (self.n - cap)
        self.qpos = [0] * cap
        for i, s in enumerate(order):
            self.qpos[s] = i
        self.sh, self.se, self.lh, self.le = 0, cap, cap, cap
        self.victims, self.compactions = [], 0

    def _live(self, p):
        return self.qpos[self.q[p]] == p

    def _front(self, h, e):
        while h < e and not self._live(h):
            h += 1
        return h

    def _append(self, s, ts):
        self.last[s] = ts
        self.q[self.le] = s
        self.qpos[s] = self.le
        self.le += 1

    def _compact(self):
        live = [self.q[p] for p in range(self.sh, self.se) if self._live(p)]
        ns = len(live)
        live += [self.q[p] for p in range(self.lh, self.le) if self._live(p)]
        assert len(live) == self.cap  # one live entry a slot
        self.q[:len(live)] = live
        for i, s in enumerate(live):
            self.qpos[s] = i
        self.sh, self.se, self.lh, self.le = 0, ns, ns, len(live)
        self.compactions += 1

    def _victim(self):
        self.sh = self._front(self.sh, self.se)
        self.lh = self._front(self.lh, self.le)
        fronts = []
        if self.sh < self.se:
            s = self.q[self.sh]
            fronts.append(((self.last[s], s), "S"))
        if self.lh < self.le:
            s = self.q[self.lh]
            fronts.append(((self.last[s], s), "L"))
        (_, v), run = min(fronts)
        if run == "S":
            self.sh += 1
        else:
            self.lh += 1
        return v

    def replay(self, row):
        hits = []
        for w in range(0, len(row), 32):
            if self.le + 32 > self.n:
                self._compact()
            pending = {}  # slot -> timestamp of its last hit since a miss

            def flush():
                for s, ts in sorted(pending.items(), key=lambda kv: kv[1]):
                    self._append(s, ts)
                pending.clear()

            for key in row[w:w + 32]:
                key = int(key)
                if key < 0:
                    hits.append(False)
                    continue
                ts, self.t = self.t, self.t + 1
                s = self.loc[key]
                if s >= 0:
                    pending[s] = ts
                    hits.append(True)
                    continue
                flush()
                v = self._victim()
                self.victims.append(v)
                if self.keys[v] >= 0:
                    self.loc[self.keys[v]] = -1
                self.keys[v] = key
                self.loc[key] = v
                self._append(v, ts)
                hits.append(False)
            flush()
        return np.array(hits)


def _model_equals_plain(st, rows):
    """Each lane of ``st`` through the model and the grid through the
    plain ``lru_step``, request by request: the same victim at every
    miss, the same hits and the same final state.  Returns the models."""
    L, T = rows.shape
    init = {k: v.clone() for k, v in st.items()}
    models = []
    for l in range(L):
        m = LruLane(*(init[k][l].tolist() for k in ("keys", "last", "t",
                                                   "loc", "cap")))
        models.append((m, m.replay(rows[l])))
    victims = [[] for _ in range(L)]
    hits = np.zeros((L, T), bool)
    for t in range(T):
        before = st["t"].clone()
        _, h = lru_step(st, torch.from_numpy(rows[:, t]))
        hits[:, t] = h.numpy()
        for l in range(L):
            if rows[l, t] >= 0 and not h[l]:
                victims[l].append(int(st["loc"][l, int(rows[l, t])]))
                assert int(st["last"][l, victims[l][-1]]) == int(before[l])
    for l, (m, mh) in enumerate(models):
        assert m.victims == victims[l], f"lane {l}: victims differ"
        assert np.array_equal(mh, hits[l])
        cap = int(st["cap"][l])
        assert m.keys == st["keys"][l, :cap].tolist()
        assert m.last == st["last"][l, :cap].tolist()
        assert m.loc == st["loc"][l].tolist() and m.t == int(st["t"][l])
    return [m for m, _ in models]


def _rows(L, T, U, seed, pad=True):
    rng = np.random.default_rng(seed)
    rows = np.where(rng.random((L, T)) < 0.6,
                    rng.integers(0, max(2, U // 8), (L, T)),
                    rng.integers(0, U, (L, T))).astype(np.int32)
    if pad:
        rows[:, ::41] = -1
        rows[0, 100:180] = -1
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_model_on_padded_grids(seed):
    """Lanes of mixed capacities padded to the widest, per-lane rows with
    padding keys, from a fresh state."""
    caps = [1, 3, 17, 40, 90, 200]
    st = peng.grid_init([peng.get_engine("lru").config(c) for c in caps],
                        256, device="cpu")
    models = _model_equals_plain(st, _rows(len(caps), 900, 256, seed))
    assert models[1].compactions >= 5  # the log compacts several times


def test_lru_model_on_a_state_carried_in_from_jax_mid_fill():
    """A reference state partway through filling (empty slots at -1
    beside aged ones), carried across with ``state_from_numpy``."""
    caps = [20, 150, 400]
    cfgs = [jeng.get_engine("lru").config(c) for c in caps]
    st = jeng.grid_init(cfgs, 512)
    first = _rows(len(caps), 300, 512, seed=5, pad=False)
    st, _ = je.replay_batch("lru", st, jnp.asarray(first))
    mid = {k: np.asarray(v) for k, v in st.items()}
    assert (mid["last"][2, :400] == -1).any()  # the widest lane mid-fill
    assert (mid["last"][0, :20] >= 0).all()
    pst = peng.state_from_numpy(mid, device="cpu")
    _model_equals_plain(pst, _rows(len(caps), 700, 512, seed=6))


@pytest.mark.parametrize("how", ["ties", "late", "negative", "sorted"])
def test_lru_model_on_crafted_ages(how):
    """Ages a replay never leaves but ``state_from_numpy`` accepts: few
    distinct values (ties break on the first index), values at or above
    t (they interleave with the launch's own timestamps), values below
    -1, and ages already in index order (the kernel skips its sort)."""
    caps = [5, 60, 200]
    rng = np.random.default_rng(11)
    st = peng.grid_init([peng.get_engine("lru").config(c) for c in caps],
                        400, device="cpu")
    t0 = 300
    for l, c in enumerate(caps):
        ks = rng.permutation(400)[:c]
        st["keys"][l, :c] = torch.from_numpy(ks.astype(np.int32))
        st["loc"][l, torch.from_numpy(ks)] = torch.arange(c,
                                                          dtype=torch.int32)
        ages = {"ties": rng.integers(0, 3, c),
                "late": rng.integers(t0 - 50, t0 + 400, c),
                "negative": rng.integers(-10**6, 10, c),
                "sorted": np.sort(rng.integers(0, t0, c))}[how]
        st["last"][l, :c] = torch.from_numpy(ages.astype(np.int32))
        st["t"][l] = t0
    _model_equals_plain(st, _rows(len(caps), 800, 400, seed=12))

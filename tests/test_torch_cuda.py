"""The port's Hopper kernels (``cache_sim``, ``s3fifo_sim``,
``simple_sim``, ``flash_attention``, ``paged_attention``, ``mamba_scan``)
(and the bf16 scan of ``mamba_bf16_scan``) against their plain PyTorch
versions, on a card, and the moe and vlm
serving paths and the contiguous-cache decode (dense, hybrid,
encoder-decoder) on the card against the port on the CPU; and training:
the flash and scan backward kernels against their plain versions, the
grad refusal of ``paged_attention``, and a train step on the card against
the CPU.
Every test here is marked ``cuda`` and skips without one.

This file imports nothing of JAX or ``repro``, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as peng
from repro_torch.kernels.cache_sim import ops
from repro_torch.kernels.cache_sim.ref import cache_sim_plain
from repro_torch.kernels.s3fifo_sim import ops as s3ops
from repro_torch.kernels.s3fifo_sim.ref import s3fifo_sim_plain
from repro_torch.kernels.simple_sim import ops as simple_ops
from repro_torch.kernels.simple_sim.ref import simple_sim_plain
from repro_torch.tuning import sweep as psweep

SHAPES = [(40, 600, 4, 200), (24, 400, 8, 80)]  # cap, T, L, U


def _traces(T, L, U, seed):
    """Half uniform keys, half a loop, shuffled (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    traces = np.stack([
        np.concatenate([rng.integers(0, U, T // 2),
                        np.arange(T // 2) % max(2, U // 2)])
        for _ in range(L)])
    rng.shuffle(traces, axis=1)
    return traces.astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cap,T,L,U", SHAPES)
def test_kernel_equals_plain_on_the_card(cap, T, L, U, cuda_device):
    traces = torch.from_numpy(_traces(T, L, U, seed=cap)).to(cuda_device)
    cfgs = [peng.SweepConfig(cap, window_frac=w, skip_limit=s)
            for w in (0.1, 1.0) for s in (0, 3)][:L]
    cfgs += [peng.SweepConfig(cap)] * (L - len(cfgs))
    a = peng.grid_init(cfgs, U, device=cuda_device)
    b = {k: v.clone() for k, v in a.items()}
    before = ops.launch_count
    h_kernel = ops.cache_sim(a, traces, "hits")
    torch.cuda.synchronize()
    assert ops.launch_count == before + 1
    h_plain = cache_sim_plain(b, traces, "hits")
    assert torch.equal(h_kernel, h_plain)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_sweep_through_the_kernel_equals_the_cpu_path(cuda_device):
    tr = _traces(3000, 1, 700, seed=4)[0]
    grid = psweep.make_grid([8, 30, 120, 400], (0.1, 0.5, 1.0))
    before = ops.launch_count
    got = psweep.sweep_hits(tr, grid, device=cuda_device)
    assert ops.launch_count == before + 1
    assert np.array_equal(got, psweep.sweep_hits(tr, grid, device="cpu"))


# -- cache_sim: each tier of the planner, and a mixed launch ---------------------


def _filled_state(cfgs, U, seed, device):
    """A grid state whose rings are already full of distinct keys (as far
    as U allows), with random refs, ages and cursors and a location table
    that agrees: the victim search then walks long runs of set refs from
    the first request on."""
    st = peng.grid_init(cfgs, U, device="cpu")
    rng = np.random.default_rng(seed)
    for l in range(len(cfgs)):
        S, M, G = (int(st[k][l]) for k in ("scap", "mcap", "gcap"))
        fill = min(1.0, 0.9 * U / (S + M + G))
        nS, nM, nG = (max(1, int(fill * n)) for n in (S, M, G))
        keys = rng.permutation(U)[:nS + nM + nG]
        ks, km, kg = keys[:nS], keys[nS:nS + nM], keys[nS + nM:]
        st["skey"][l, :nS] = torch.from_numpy(ks)
        st["sref"][l, :nS] = torch.from_numpy(rng.random(nS) < 0.5)
        st["seqctr"][l] = S + 10
        st["sseq"][l, :nS] = torch.from_numpy(
            (S + 10 - rng.integers(1, S + 10, nS)).astype(np.int32))
        st["spos"][l] = int(rng.integers(S))
        st["mkey"][l, :nM] = torch.from_numpy(km)
        density = (0.5, 0.99)[l % 2]
        st["mref"][l, :nM] = torch.from_numpy(rng.random(nM) < density)
        st["hand"][l] = int(rng.integers(M))
        st["gkey"][l, :nG] = torch.from_numpy(kg)
        st["gpos"][l] = int(rng.integers(G))
        for ks_, code in ((ks, peng.W_SMALL), (km, peng.W_MAIN),
                          (kg, peng.W_GHOST)):
            idx = torch.from_numpy(ks_.astype(np.int64))
            st["loc_w"][l, idx] = code
            st["loc_s"][l, idx] = torch.arange(len(ks_), dtype=torch.int32)
    return {k: v.to(device) for k, v in st.items()}


def _skewed_trace(T, U, seed):
    """Half uniform keys over [0, U), half from its first tenth."""
    rng = np.random.default_rng(seed)
    tr = np.concatenate([rng.integers(0, U, T // 2),
                         rng.integers(0, max(2, U // 10), T - T // 2)])
    rng.shuffle(tr)
    return tr.astype(np.int32)


def _lane_configs(caps, **kw):
    """Per capacity: two windows, a skip limit, and a clock2q lane."""
    cfgs = []
    for c in caps:
        cfgs += [peng.SweepConfig(c, window_frac=0.1, **kw),
                 peng.SweepConfig(c, window_frac=1.0, skip_limit=3, **kw),
                 peng.get_engine("clock2q").config(c, **kw)]
    return cfgs


TIER_GRIDS = {  # tier: (lane configs, universe); natural sizes in that tier
    0: (_lane_configs([64, 1500], small_frac=0.1), 4096),
    1: (_lane_configs([2000, 20000], small_frac=0.1), 65536),
    2: (_lane_configs([50000], small_frac=0.1), 131072),
    3: (_lane_configs([90000], small_frac=0.1), 262144),
}


def _kernel_and_plain(state, trace, out="hits"):
    a = {k: v.clone() for k, v in state.items()}
    b = {k: v.clone() for k, v in state.items()}
    before = ops.launch_count
    got = ops.cache_sim(a, trace, out)
    torch.cuda.synchronize()
    assert ops.launch_count == before + 1
    want = cache_sim_plain(b, trace, out)
    return got, want, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIER_GRIDS))
def test_cache_sim_each_tier_equals_plain(tier, cuda_device):
    cfgs, U = TIER_GRIDS[tier]
    st = _filled_state(cfgs, U, seed=tier, device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(2048, U, seed=tier)).to(
        cuda_device)
    plan = ops.plan_view(ops.host_view(st, trace))
    assert max(plan.tiers) == tier
    got, want, a, b = _kernel_and_plain(st, trace)
    assert torch.equal(got, want)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_cache_sim_mixed_tiers_in_one_launch(cuda_device):
    """One launch over lanes of all four tiers, with skip-limit and
    clock2q lanes, per-lane trace rows with padding keys."""
    U = 20000
    cfgs = _lane_configs([100, 25000, 40000, 90000], small_frac=0.1)
    st = _filled_state(cfgs, U, seed=7, device=cuda_device)
    rows = np.stack([_skewed_trace(1500, U, seed=10 + i)
                     for i in range(len(cfgs))])
    rows[:, ::97] = -1
    trace = torch.from_numpy(rows).to(cuda_device)
    plan = ops.plan_view(ops.host_view(st, trace))
    assert sorted(set(plan.tiers)) == [0, 1, 2, 3]
    for out in ("hits", "counts"):
        got, want, a, b = _kernel_and_plain(st, trace, out)
        assert torch.equal(got, want)
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", sorted(TIER_GRIDS))
def test_cache_sim_plain_to_kernel_handover_in_each_tier(tier, cuda_device):
    """The plain version replays the first chunk, the kernel the second:
    the same hits and state as the kernel over both."""
    cfgs, U = TIER_GRIDS[tier]
    st = _filled_state(cfgs, U, seed=20 + tier, device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(1024, U, seed=30 + tier)).to(
        cuda_device)
    whole = {k: v.clone() for k, v in st.items()}
    h_whole = ops.cache_sim(whole, trace, "hits")
    part = {k: v.clone() for k, v in st.items()}
    h1 = cache_sim_plain(part, trace[:600].contiguous(), "hits")
    h2 = ops.cache_sim(part, trace[600:].contiguous(), "hits")
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([h1, h2], dim=1), h_whole)
    assert all(torch.equal(part[k], whole[k]) for k in part)


# -- s3fifo_sim and simple_sim: the other policy families ------------------------

POLICY_GRIDS = {  # family: lane configs of one padded launch, universe
    "s3fifo": ([peng.get_engine("s3fifo").config(c, bits=b, skip_limit=s)
                for c in (1, 7, 60, 700) for b in (1, 2) for s in (0, 2, 16)]
               + [peng.get_engine("s3fifo").config(300, small_frac=0.4,
                                                   ghost_frac=0.2)], 2000),
    "fifo": ([peng.get_engine("fifo").config(c)
              for c in (1, 9, 250, 1500)], 2000),
    "clock": ([peng.get_engine("clock").config(c)
               for c in (1, 9, 250, 1500)], 2000),
    # 3,000 slots: the LRU log and its fronts span many passes of 32
    "lru": ([peng.get_engine("lru").config(c)
             for c in (1, 9, 250, 1500, 3000)], 8000),
}


def _policy_kernel(family):
    if family == "s3fifo":
        return s3ops, s3ops.s3fifo_sim, s3fifo_sim_plain
    kernel = getattr(simple_ops, f"{family}_sim")
    return (simple_ops, kernel,
            lambda st, tr, out="hits": simple_sim_plain(family, st, tr, out))


def _policy_rows(L, T, U, seed):
    """Per-lane skewed rows with padding keys."""
    rows = np.stack([_skewed_trace(T, U, seed=seed + i) for i in range(L)])
    rows[:, ::89] = -1
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(POLICY_GRIDS))
@pytest.mark.parametrize("shared", [True, False])
def test_policy_kernel_equals_plain(family, shared, cuda_device):
    """Hits (and counts) and every state tensor equal the plain version's,
    with one trace row shared by the lanes or one row a lane."""
    mod, kernel, plain = _policy_kernel(family)
    cfgs, U = POLICY_GRIDS[family]
    init = peng.grid_init(cfgs, U, device=cuda_device)
    rows = _policy_rows(len(cfgs), 3000, U, seed=40)
    trace = torch.from_numpy(rows[0] if shared else rows).to(cuda_device)
    for out in ("hits", "counts"):
        a = {k: v.clone() for k, v in init.items()}
        b = {k: v.clone() for k, v in init.items()}
        before = mod.launch_count
        got = kernel(a, trace, out)
        torch.cuda.synchronize()
        assert mod.launch_count == before + 1
        assert torch.equal(got, plain(b, trace, out))
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(POLICY_GRIDS))
def test_policy_kernel_plain_to_kernel_handover(family, cuda_device):
    """The plain version replays the first chunk, the kernel the second:
    the same hits and state as the kernel over both."""
    _, kernel, plain = _policy_kernel(family)
    cfgs, U = POLICY_GRIDS[family]
    st = peng.grid_init(cfgs, U, device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(2400, U, seed=50)).to(cuda_device)
    whole = {k: v.clone() for k, v in st.items()}
    h_whole = kernel(whole, trace, "hits")
    part = {k: v.clone() for k, v in st.items()}
    h1 = plain(part, trace[:1300].contiguous(), "hits")
    h2 = kernel(part, trace[1300:].contiguous(), "hits")
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([h1, h2], dim=1), h_whole)
    assert all(torch.equal(part[k], whole[k]) for k in part)


@pytest.mark.cuda
def test_mixed_policy_sweep_through_the_kernels_equals_the_cpu_path(
        cuda_device):
    """A grid of all six engines: one launch a step family on the card,
    the plain versions on the CPU."""
    tr = _traces(2500, 1, 600, seed=6)[0]
    grid = [peng.get_engine(p).config(c, **kw)
            for p, kw in (("clock2q+", {}), ("clock2q", {}), ("s3fifo", {}),
                          ("s3fifo", dict(bits=1)), ("fifo", {}),
                          ("clock", {}), ("lru", {}))
            for c in (8, 40, 200)]
    before = [m.launch_count for m in (ops, s3ops, simple_ops)]
    got = psweep.sweep_hits(tr, grid, device=cuda_device)
    after = [m.launch_count for m in (ops, s3ops, simple_ops)]
    assert [b - a for a, b in zip(before, after)] == [1, 1, 3]
    assert np.array_equal(got, psweep.sweep_hits(tr, grid, device="cpu"))


# -- s3fifo_sim and simple_sim: tiers, short rings, the lookahead, LRU's log -----


def _filled_policy_state(family, cfgs, U, seed, device, lru="distinct"):
    """A grid state of ``family`` whose rings are nine tenths full of
    distinct keys, with random freqs / refs / ages and cursors and a
    location table that agrees, so the victim searches walk from the
    first request on.  ``lru`` picks LRU's ages: ``distinct`` (below t, as
    a replay leaves them), ``ties`` (few distinct values) or ``late``
    (some at or above t)."""
    st = peng.grid_init(cfgs, U, device="cpu")
    rng = np.random.default_rng(seed)
    for l in range(len(cfgs)):
        if family == "s3fifo":
            S, M, G = (int(st[k][l]) for k in ("scap", "mcap", "gcap"))
            fill = min(0.9, 0.9 * U / (S + M + G))
            nS, nM, nG = (max(1, int(fill * n)) for n in (S, M, G))
            if nS + M + nG <= U:  # a full Main ring: walks from the start
                nM = M
            keys = rng.permutation(U)[:nS + nM + nG]
            fcap = int(st["freq_cap"][l])
            for ring, freq, code, ks, n, cap, cur in (
                    ("skey", "sfreq", peng.W_SMALL, keys[:nS], nS, S, "spos"),
                    ("mkey", "mfreq", peng.W_MAIN, keys[nS:nS + nM], nM, M,
                     "mhead"),
                    ("gkey", None, peng.W_GHOST, keys[nS + nM:], nG, G,
                     "gpos")):
                st[ring][l, :n] = torch.from_numpy(ks.astype(np.int32))
                if freq:
                    st[freq][l, :n] = torch.from_numpy(
                        rng.integers(0, fcap + 1, n).astype(np.int32))
                idx = torch.from_numpy(ks.astype(np.int64))
                st["loc_w"][l, idx] = code
                st["loc_s"][l, idx] = torch.arange(n, dtype=torch.int32)
                st[cur][l] = int(rng.integers(cap)) \
                    if code != peng.W_MAIN or n == M else 0
            st["mcount"][l] = nM
            continue
        C = int(st["cap"][l])
        n = max(1, int(min(0.9, 0.9 * U / C) * C))
        slots = torch.from_numpy(rng.permutation(C)[:n].astype(np.int64))
        ks = torch.from_numpy(rng.permutation(U)[:n].astype(np.int32))
        st["keys"][l, slots] = ks
        if family == "fifo":
            st["resident"][l, ks.long()] = True
            st["pos"][l] = int(rng.integers(C))
        else:
            st["loc"][l, ks.long()] = slots.to(torch.int32)
        if family == "clock":
            st["ref"][l, :C] = torch.from_numpy(rng.random(C) < 0.7)
            st["hand"][l] = int(rng.integers(C))
        if family == "lru":
            t = 5 * C + 100
            vals = {"distinct": rng.permutation(t)[:C],
                    "ties": rng.integers(0, 4, C),
                    "late": rng.integers(t - C, t + C, C)}[lru]
            st["last"][l, :C] = torch.from_numpy(vals.astype(np.int32))
            st["t"][l] = t
    return {k: v.to(device) for k, v in st.items()}


def _s3(c, **kw):
    return peng.get_engine("s3fifo").config(c, **kw)


def _policy_cfgs(family, caps):
    if family == "s3fifo":
        return [_s3(c, bits=b, skip_limit=s) for c in caps
                for b, s in ((2, 0), (1, 2), (2, 1))]
    return [peng.get_engine(family).config(c) for c in caps]


POLICY_TIERS = {  # (family, tier): (capacities, key range)
    ("s3fifo", 0): ([64, 1500], 4096), ("s3fifo", 1): ([200, 2000], 65536),
    ("s3fifo", 2): ([30000], 131072), ("s3fifo", 3): ([60000], 262144),
    ("fifo", 0): ([64, 1500], 4096), ("fifo", 1): ([2000], 262144),
    ("fifo", 3): ([60000], 262144),
    ("clock", 0): ([64, 1500], 4096), ("clock", 1): ([2000], 65536),
    ("clock", 3): ([50000], 131072),
    ("lru", 0): ([64, 1500], 4096), ("lru", 1): ([2000], 65536),
    ("lru", 3): ([12000], 65536),
}


def _policy_plan(family, st, trace):
    if family == "s3fifo":
        return s3ops.plan_view(s3ops.host_view(st, trace))
    return simple_ops.plan_view(family,
                                simple_ops.host_view(family, st, trace))


def _policy_kernel_and_plain(family, state, trace, out="hits"):
    mod, kernel, plain = _policy_kernel(family)
    a = {k: v.clone() for k, v in state.items()}
    b = {k: v.clone() for k, v in state.items()}
    before = mod.launch_count
    got = kernel(a, trace, out)
    torch.cuda.synchronize()
    assert mod.launch_count == before + 1
    want = plain(b, trace, out)
    assert torch.equal(got, want)
    assert all(torch.equal(a[k], b[k]) for k in a)
    return got, a


@pytest.mark.cuda
@pytest.mark.parametrize("family,tier", sorted(POLICY_TIERS))
def test_policy_kernel_each_tier_equals_plain(family, tier, cuda_device):
    caps, U = POLICY_TIERS[family, tier]
    st = _filled_policy_state(family, _policy_cfgs(family, caps), U,
                              seed=tier, device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(2048, U, seed=tier)).to(
        cuda_device)
    assert max(_policy_plan(family, st, trace).tiers) == tier
    _policy_kernel_and_plain(family, st, trace)


@pytest.mark.cuda
@pytest.mark.parametrize("family,tier", sorted(POLICY_TIERS))
def test_policy_kernel_plain_to_kernel_handover_in_each_tier(family, tier,
                                                             cuda_device):
    """The plain version replays the first chunk, the kernel the second:
    the same hits and state as the kernel over both."""
    _, kernel, plain = _policy_kernel(family)
    caps, U = POLICY_TIERS[family, tier]
    st = _filled_policy_state(family, _policy_cfgs(family, caps), U,
                              seed=20 + tier, device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(1024, U, seed=30 + tier)).to(
        cuda_device)
    whole = {k: v.clone() for k, v in st.items()}
    h_whole = kernel(whole, trace, "hits")
    part = {k: v.clone() for k, v in st.items()}
    h1 = plain(part, trace[:600].contiguous(), "hits")
    h2 = kernel(part, trace[600:].contiguous(), "hits")
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([h1, h2], dim=1), h_whole)
    assert all(torch.equal(part[k], whole[k]) for k in part)


POLICY_MIXED = {  # family: (capacities, key range): a lane in every tier
    "s3fifo": ([64, 10000, 30000, 60000], 30000),
    "fifo": ([64, 30000, 60000], 150000),
    "clock": ([64, 20000, 50000], 40000),
    "lru": ([64, 5000, 12000], 40000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(POLICY_MIXED))
def test_policy_kernel_mixed_tiers_in_one_launch(family, cuda_device):
    """One launch over lanes of every tier of the family, per-lane rows
    with padding keys and a row of padding only; hits and counts."""
    caps, U = POLICY_MIXED[family]
    st = _filled_policy_state(family, _policy_cfgs(family, caps), U, seed=7,
                              device=cuda_device)
    L = st["spos" if family == "s3fifo" else "cap"].shape[0]
    rows = np.stack([_skewed_trace(1500, U, seed=10 + i) for i in range(L)])
    rows[:, ::97] = -1
    rows[1] = -1
    trace = torch.from_numpy(rows).to(cuda_device)
    tiers = _policy_plan(family, st, trace).tiers
    assert set(tiers) == ({0, 1, 2, 3} if family == "s3fifo" else {0, 1, 3})
    for out in ("hits", "counts"):
        _policy_kernel_and_plain(family, st, trace, out)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["s3fifo", "fifo", "clock", "lru"])
def test_policy_kernel_forced_into_device_memory_equals_plain(family,
                                                              cuda_device):
    """``bind`` with a plan that puts every lane in device memory (as
    chip_smoke's policy_tier_time launches them): lanes the planner keeps
    whole in shared memory give the plain version's hits and state."""
    from repro_torch.kernels import lanes

    caps, U = POLICY_TIERS[family, 0]
    st = _filled_policy_state(family, _policy_cfgs(family, caps), U, seed=3,
                              device=cuda_device)
    trace = torch.from_numpy(_skewed_trace(2048, U, seed=4)).to(cuda_device)
    assert set(_policy_plan(family, st, trace).tiers) == {lanes.TIER_WHOLE}
    plan = lanes.plan_grid([lanes.plan_tiers(((lanes.TIER_GLOBAL, 0),))]
                           * len(_policy_plan(family, st, trace).tiers))
    a = {k: v.clone() for k, v in st.items()}
    b = {k: v.clone() for k, v in st.items()}
    if family == "s3fifo":
        from repro_torch.kernels.s3fifo_sim.build import load

        _, w = s3ops.check_state(a)
        got = s3ops.bind(load(), a, trace, "hits", s3ops.host_view(a, trace),
                         w, plan)()
    else:
        from repro_torch.kernels.simple_sim.build import load

        _, w = simple_ops.check_state(family, a)
        got = simple_ops.bind(load(), family, a, trace, "hits",
                              simple_ops.host_view(family, a, trace), w,
                              plan)()
    torch.cuda.synchronize()
    want = _policy_kernel(family)[2](b, trace, "hits")
    assert torch.equal(got, want)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["s3fifo", "fifo", "clock", "lru"])
def test_policy_kernel_rings_shorter_than_a_warp(family, cuda_device):
    """Rings of 1-31 slots (S3-FIFO's Main ring too): a pass of 32 visits
    a slot several times; skip limits 1 and 2; filled and fresh."""
    caps = list(range(1, 36)) if family == "s3fifo" else list(range(1, 32))
    cfgs = _policy_cfgs(family, caps)
    if family == "s3fifo":
        mcaps = {peng.get_engine("s3fifo").sizes_fn(c)[1] for c in cfgs}
        assert set(range(1, 32)) <= mcaps
    U = 48
    rows = np.stack([_skewed_trace(2048, U, seed=60 + i)
                     for i in range(len(cfgs))]).astype(np.int32)
    trace = torch.from_numpy(rows).to(cuda_device)
    _policy_kernel_and_plain(family, peng.grid_init(cfgs, U,
                                                    device=cuda_device),
                             trace)
    _policy_kernel_and_plain(family, _filled_policy_state(
        family, cfgs, U, seed=61, device=cuda_device), trace)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["s3fifo", "fifo", "clock", "lru"])
def test_policy_kernel_windows_that_repeat_one_slot(family, cuda_device):
    """Two-key traces: every window hits one or two slots many times
    (S3-FIFO's freqs saturate by grouped hits)."""
    rng = np.random.default_rng(70)
    rows = np.stack([np.where(rng.random(3000) < p, 0, 1)
                     for p in (0.5, 0.9, 0.99, 1.0)]).astype(np.int32)
    cfgs = _policy_cfgs(family, [1, 2, 8, 40])
    rows = np.repeat(rows, len(cfgs) // 4, axis=0)
    trace = torch.from_numpy(rows).to(cuda_device)
    _policy_kernel_and_plain(family, peng.grid_init(cfgs, 64,
                                                    device=cuda_device),
                             trace)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["s3fifo", "fifo", "clock", "lru"])
def test_policy_kernel_rerequest_within_64_of_an_eviction(family,
                                                          cuda_device):
    """Loops over cap + 1 .. cap + 5 keys: each key comes back a few
    requests after the miss that evicts it, inside the window in flight
    or the next, so every table write of a miss must reach the held
    entries of both windows."""
    caps = [2, 3, 7, 15, 30, 50]
    cfgs = _policy_cfgs(family, caps)
    per = len(cfgs) // len(caps)
    rng = np.random.default_rng(80)
    rows = []
    for c in caps:
        for j in range(per):
            loop = c + 1 + (j % 5)
            r = np.arange(4000) % loop
            noise = rng.random(4000) < 0.05
            r[noise] = rng.integers(0, 200, int(noise.sum()))
            rows.append(r)
    trace = torch.from_numpy(np.stack(rows).astype(np.int32)).to(cuda_device)
    _policy_kernel_and_plain(family, peng.grid_init(cfgs, 256,
                                                    device=cuda_device),
                             trace)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["distinct", "ties", "late"])
def test_lru_kernel_takes_any_carried_in_ages(how, cuda_device):
    """LRU states whose ages are distinct, tied, or at or above t: the
    victim is the first index of the smallest ``last`` all the same."""
    caps = [5, 64, 700, 2000]
    cfgs = _policy_cfgs("lru", caps)
    st = _filled_policy_state("lru", cfgs, 4096, seed=90,
                              device=cuda_device, lru=how)
    trace = torch.from_numpy(_skewed_trace(3000, 4096, seed=91)).to(
        cuda_device)
    _policy_kernel_and_plain("lru", st, trace)


@pytest.mark.cuda
def test_lru_log_compacts_many_times_in_one_launch(cuda_device):
    """Small rings over loops of 3 cap + 5 keys: every access is a miss
    and appends to the log of 2 cap + 64 entries, which compacts once
    every cap + 64 appends -- 20 times or more in the launch."""
    caps = [1, 8, 33, 100]
    T = 6000
    assert all(T // (c + simple_ops.LOG_SLACK) >= 20 for c in caps)
    rows = np.stack([(np.arange(T) * 7) % (3 * c + 5) for c in caps])
    trace = torch.from_numpy(rows.astype(np.int32)).to(cuda_device)
    cfgs = _policy_cfgs("lru", caps)
    _policy_kernel_and_plain("lru", peng.grid_init(cfgs, 512,
                                                   device=cuda_device),
                             trace)
    _policy_kernel_and_plain("lru", _filled_policy_state(
        "lru", cfgs, 512, seed=95, device=cuda_device), trace)


@pytest.mark.cuda
def test_policy_kernels_raise_on_a_cuda_launch_they_refuse(cuda_device):
    """No quiet fallback: a timestamp that would wrap is refused before
    any launch, on the card as on the CPU."""
    st = peng.grid_init(_policy_cfgs("lru", [8]), 64, device=cuda_device)
    st["t"][0] = 2**31 - 10
    with pytest.raises(ValueError, match="wrap"):
        simple_ops.lru_sim(st, torch.zeros(20, dtype=torch.int32,
                                           device=cuda_device))


# -- attention kernels -------------------------------------------------------

FLASH_SHAPES = [  # B, S, Skv, H, Hkv, hd, causal: tests/test_kernels.py,
    # granite, one row, rows off the 128-row tile, every head_dim of the
    # bf16 kernel
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 2, 2, 128, False),
    (2, 96, 96, 4, 1, 80, True),
    (1, 64, 64, 2, 2, 32, True),
    (1, 1000, 1000, 32, 8, 128, True),
    (1, 1, 1, 32, 8, 128, True),
    (2, 200, 200, 8, 2, 128, True),
    (3, 130, 130, 4, 4, 64, False),
    (2, 333, 333, 4, 4, 80, True),
    (1, 77, 77, 4, 2, 32, False),
    (2, 200, 200, 8, 1, 112, True),   # kimi-k2's hd: TMA's zeros past 112
    (1, 130, 130, 4, 4, 112, False),
    (1, 300, 300, 16, 16, 128, True),  # olmoe's 16/16 heads
    # Sq != Skv, full: whisper-tiny's cross-attention (a 4-token prompt
    # and a long decoder prefix against 1,500 frames), rows and columns
    # off the tiles both ways
    (2, 4, 1500, 6, 6, 64, False),
    (2, 448, 1500, 6, 6, 64, False),
    (1, 1, 77, 4, 2, 64, False),
    (1, 300, 130, 8, 2, 128, False),
]
FUSED_SHAPES = [  # B, S, H, hd: q/k/v views of one (B, S, 3, H, hd) tensor
    (4, 300, 8, 80),
    (2, 129, 4, 64),
    (4, 2048, 32, 80),   # zamba2-2.7b's shared block at the hybrid's prefill
]
PAGED_SHAPES = [  # B, H, Hkv, d, N, bs, nb: tests/test_kernels.py, granite,
    # groups of 1 and 16
    (3, 4, 2, 64, 16, 8, 4),
    (2, 8, 8, 128, 32, 16, 3),
    (1, 4, 1, 32, 8, 4, 2),
    (8, 32, 8, 128, 1024, 16, 160),
    (4, 8, 8, 128, 256, 16, 40),
    (3, 32, 2, 128, 256, 16, 40),
    (4, 64, 8, 112, 256, 16, 40),   # kimi-k2: 7 k-steps of 16
    (3, 16, 16, 128, 64, 16, 8),    # olmoe
    # one page a sequence, as layers.decode_attention views a contiguous
    # cache: pages of 1,500 (whisper's frames), 2,049 and 37 positions,
    # none a multiple of the 16-position chunk; zamba2's head_dim 80
    (4, 6, 6, 64, 4, 1500, 1),
    (2, 32, 8, 128, 2, 2049, 1),
    (3, 32, 32, 80, 3, 37, 1),
]
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 3e-2)}
# (atol, rtol) in bf16 of the one-page views and the Sq != Skv shapes: their
# outputs average up to 2,049 positions, so a typical |want| is 0.03 and
# ATTN_TOL's absolute 2e-2 would pass a kernel that lost a partial tail
NEW_BF16_TOL = (1e-3, 3e-2)


def _tol(dtype, tol: float, new_shape: bool) -> tuple:
    """(atol, rtol): ``NEW_BF16_TOL`` for a new shape in bf16, else tol."""
    if new_shape and dtype == torch.bfloat16:
        return NEW_BF16_TOL
    return tol, tol


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Skv,H,Hkv,hd,causal", FLASH_SHAPES)
def test_flash_attention_kernel_equals_plain(B, S, Skv, H, Hkv, hd, causal,
                                             dtype, cuda_device):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    rng = np.random.default_rng(S + hd)
    q = _randn(rng, (B, S, H, hd), dtype, cuda_device)
    k = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda_device)
    v = _randn(rng, (B, Skv, Hkv, hd), dtype, cuda_device)
    before = fops.launch_count
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.launch_count == before + 1
    want = flash_attention_plain(q, k, v, causal)
    atol, rtol = _tol(dtype, ATTN_TOL[dtype][0], S != Skv)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", FUSED_SHAPES)
def test_flash_attention_kernel_on_views_of_a_fused_tensor(B, S, H, hd, dtype,
                                                           cuda_device):
    """Strided q/k/v (H = Hkv), as a fused projection would hand them
    over: TMA reads the views in place."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    rng = np.random.default_rng(S + hd)
    qkv = _randn(rng, (B, S, 3, H, hd), dtype, cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fops.launch_count
    got = fops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fops.launch_count == before + 1
    want = flash_attention_plain(q, k, v, True)
    tol = ATTN_TOL[dtype][0]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,d,N,bs,nb", PAGED_SHAPES)
def test_paged_attention_kernel_equals_plain(B, H, Hkv, d, N, bs, nb, dtype,
                                             cuda_device):
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    rng = np.random.default_rng(N + d)
    q = _randn(rng, (B, H, d), dtype, cuda_device)
    kp = _randn(rng, (N, bs, Hkv, d), dtype, cuda_device)
    vp = _randn(rng, (N, bs, Hkv, d), dtype, cuda_device)
    bt = torch.from_numpy(np.stack([rng.permutation(N)[:nb]
                                    for _ in range(B)]).astype(np.int32))
    lens = rng.integers(1, nb * bs + 1, size=B)
    lens[0] = 1
    lens[-1] = nb * bs
    lens = torch.from_numpy(lens.astype(np.int32))
    before = pops.launch_count
    got = pops.paged_attention(q, kp, vp, bt.to(cuda_device),
                               lens.to(cuda_device))
    torch.cuda.synchronize()
    assert pops.launch_count == before + 1
    want = paged_attention_plain(q, kp, vp, bt.to(cuda_device),
                                 lens.to(cuda_device))
    atol, rtol = _tol(dtype, ATTN_TOL[dtype][1], nb == 1)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


# -- selective scan ------------------------------------------------------------

SCAN_SHAPES = [  # B, S, din, N: tests/test_kernels.py, falcon-mamba, edges
    (2, 64, 128, 16),
    (1, 100, 96, 8),
    (2, 32, 64, 4),
    (1, 70, 100, 3),      # one thread a channel, N not a power of two
    (2, 17, 8192, 16),
    (1, 70, 256, 33),
    (2, 100, 300, 64),
    (1, 130, 200, 12),    # N not a power of two, din and S off the tiles
    (2, 65, 100, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,din,N", SCAN_SHAPES)
def test_mamba_scan_kernel_equals_plain(B, S, din, N, dtype, cuda_device):
    """fp32: y and h_last within 1e-4 (tests/test_kernels.py's bound);
    bf16 u/B/C (both versions on the same rounded inputs, dt fp32): y
    within 2e-2 of max |y| (one bf16 rounding of y), h_last within
    1e-3."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain
    rng = np.random.default_rng(S + din + N)
    u = _randn(rng, (B, S, din), dtype, cuda_device)
    dt = _randn(rng, (B, S, din), torch.float32, cuda_device).abs() * 0.1
    Bc = _randn(rng, (B, S, N), dtype, cuda_device)
    Cc = _randn(rng, (B, S, N), dtype, cuda_device)
    A_log = _randn(rng, (din, N), torch.float32, cuda_device) * 0.5
    before = sops.launch_count
    y, h = sops.mamba_scan(u, dt, Bc, Cc, A_log)
    torch.cuda.synchronize()
    assert sops.launch_count == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y0, h0 = mamba_scan_plain(u, dt, Bc, Cc, A_log)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y0, atol=1e-4, rtol=0)
        torch.testing.assert_close(h, h0, atol=1e-4, rtol=0)
    else:
        scale = float(y0.float().abs().max())
        assert float((y.float() - y0.float()).abs().max()) <= 2e-2 * scale
        torch.testing.assert_close(h, h0, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [7, 64, 256])
def test_mamba_scan_bf16_kernels_equal_plain(chunk, dtype, cuda_device):
    """The bf16 scan (``mamba_bf16_scan``) on the card: h_last and the
    states bit-equal to the plain version (the same bf16 operations), y
    within 1e-5 of max |y| plus one bf16 step where y is bf16 (an fp32
    sum in another order); the backward under its bf16 flag within 1e-4
    of each gradient's max plus half a bf16 step of bf16 outputs."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import (
        mamba_scan_bf16_plain, mamba_scan_bwd_plain,
    )
    rng = np.random.default_rng(chunk)
    B, S, din, N = 2, 300, 96, 16
    u = _randn(rng, (B, S, din), dtype, cuda_device)
    dt = _randn(rng, (B, S, din), torch.float32, cuda_device).abs() * 0.1
    Bc = _randn(rng, (B, S, N), dtype, cuda_device)
    Cc = _randn(rng, (B, S, N), dtype, cuda_device)
    A_log = _randn(rng, (din, N), torch.float32, cuda_device) * 0.5
    before = sops.bf16_launch_count
    y, h, st = sops.mamba_scan_fwd(u, dt, Bc, Cc, A_log, chunk)
    torch.cuda.synchronize()
    assert sops.bf16_launch_count == before + 1
    y0, h0, st0 = mamba_scan_bf16_plain(u, dt, Bc, Cc, A_log, chunk,
                                        chunk_states=True)
    assert torch.equal(h, h0) and torch.equal(st, st0)
    scale = float(y0.float().abs().max())
    step = 2.0 ** -7 * y0.float().abs() if dtype == torch.bfloat16 else 0.0
    assert bool(((y.float() - y0.float()).abs()
                 <= 1e-5 * scale + step).all())
    dy = _randn(rng, (B, S, din), dtype, cuda_device)
    got = sops.mamba_scan_bwd(u, dt, Bc, Cc, A_log, st, dy, None, chunk)
    want = mamba_scan_bwd_plain(u.float(), dt, Bc.float(), Cc.float(),
                                A_log, st, dy.float(), None,
                                bf16_chunk=chunk)
    for g, w in zip(got, want):
        m, e = torch.frexp(w)
        half = torch.ldexp(torch.ones_like(m), e - 9) * (w != 0)
        lim = 1e-4 * float(w.abs().max()) + (
            half if g.dtype == torch.bfloat16 else 0.0)
        assert bool(((g.float() - w).abs() <= lim + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 8])
def test_paged_attention_kernel_at_split_and_page_boundaries(bs, dtype,
                                                            cuda_device):
    """Lengths of exactly one chunk, one split and one page, one past
    each, and the table's whole capacity nb * bs, at granite's widths."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    rng = np.random.default_rng(bs)
    N, nb, H, Hkv, d = 512, 64, 32, 8, 128
    lengths = [pops.CHUNK, pops.CHUNK + 1, bs, bs + 1, nb * bs, nb * bs - 1]
    B = len(lengths)
    n = pops.plan_splits(B, Hkv, nb * bs)
    one_split = pops.split_range(0, nb * bs, n)[1]
    lengths += [one_split, one_split + 1]
    B = len(lengths)
    q = _randn(rng, (B, H, d), dtype, cuda_device)
    kp = _randn(rng, (N, bs, Hkv, d), dtype, cuda_device)
    vp = _randn(rng, (N, bs, Hkv, d), dtype, cuda_device)
    bt = torch.from_numpy(np.stack([rng.permutation(N)[:nb]
                                    for _ in range(B)]).astype(np.int32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    bt, lens = bt.to(cuda_device), lens.to(cuda_device)
    before = pops.launch_count
    got = pops.paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert pops.launch_count == before + 1
    want = paged_attention_plain(q, kp, vp, bt, lens)
    tol = ATTN_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# -- the moe and vlm models on the card ------------------------------------------


def _family(arch: str, **kw):
    """(cfg, params on the CPU): the reduced ``arch`` in fp32, random
    params from a seeded generator."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build

    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    return cfg, build(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")


def _on(params, device):
    from repro_torch.models import layers as L
    return L.tree_map(lambda t: t.to(device), params)


@pytest.mark.cuda
def test_moe_engine_on_the_card_equals_the_cpu(cuda_device):
    """The padded moe decode on the card (16 experts, top-2, 6 rows of one
    prompt at max_batch 16: the capacity binds on the padded rows, which
    name the last real row's slot) gives the CPU's tokens, and all six
    requests agree."""
    from repro_torch.models.model import build
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, params = _family("olmoe-1b-7b", n_experts=16)
    prompt = [int(t) for t in np.random.default_rng(5).integers(0, 512, 13)]
    out = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(build(cfg), _on(params, dev), block_size=8,
                            hbm_blocks=64, max_batch=16, device=dev)
        done = eng.run([Request(i, list(prompt), max_new=6)
                        for i in range(6)])
        out[str(dev)] = {c.req_id: c.tokens for c in done}
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert card == cpu
    assert all(card[i] == card[0] for i in range(6))


@pytest.mark.cuda
def test_vlm_patch_prefill_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.models.model import build

    cfg, params = _family("llava-next-mistral-7b")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    pe = torch.from_numpy(rng.normal(0, 1, (2, cfg.n_patches, cfg.d_model))
                          .astype(np.float32))
    api = build(cfg)
    want, wc = api.prefill(params, toks, full_logits=True, patch_embeds=pe)
    got, gc = api.prefill(_on(params, cuda_device), toks.to(cuda_device),
                          full_logits=True, patch_embeds=pe.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gc.k.cpu(), wc.k, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_contiguous_decode_on_the_card_equals_the_cpu(arch, cuda_device):
    """prefill(max_len) and four greedy decode steps of the reduced model
    (fp32) on the card, its decode attention on the paged kernel's
    one-page views, give the CPU's logits and caches."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.models.model import build

    cfg, params = _family(arch)
    api = build(cfg)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 7)))
    kw = {}
    if cfg.family == "encdec":
        kw["audio_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (2, 37, cfg.d_model)).astype(np.float32))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 2, 1)))
    out = {}
    for dev in ("cpu", cuda_device):
        p = _on(params, dev)
        logits, cache = api.prefill(p, toks.to(dev), max_len=12,
                                    **{k: v.to(dev) for k, v in kw.items()})
        got = [logits[:, -1]]
        before = pops.launch_count
        for t in steps:
            logits, cache = api.decode(p, t.to(dev), cache)
            got.append(logits[:, -1])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert pops.launch_count > before
        out[str(dev)] = (torch.stack(got, 1).cpu(), cache.k.cpu(),
                         cache.v.cpu())
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# -- training: the flash backward kernel, the grad refusals, a train step ------

# B, Sq, Skv, H, Hkv, hd, causal: GQA, head_dims 128, 112, 80, 64 and 8,
# Sq != Skv both ways, lengths off every tile
FLASH_BWD_SHAPES = [(2, 130, 130, 8, 2, 128, True), (1, 65, 65, 4, 4, 112, True),
                    (1, 200, 200, 4, 4, 80, True), (2, 70, 300, 6, 6, 64, False),
                    (1, 300, 70, 2, 1, 8, True), (1, 257, 257, 3, 3, 64, False)]
# against the plain backward rounded as the kernel rounds (bf16: P and dS,
# ops.BWD_ROUNDING), each element's limit widened by one rounding step of
# its sum's largest term (ref.flash_attention_bwd_rounding_slack); a bf16
# case also against the unrounded one at ATTN_TOL's bf16 limit, the size
# of that rounding (chip_smoke.py)
BWD_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 3e-2)}
BWD_FP32_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 3e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,causal", FLASH_BWD_SHAPES)
def test_flash_attention_backward_kernel_equals_plain(B, Sq, Skv, H, Hkv, hd,
                                                      causal, dtype,
                                                      cuda_device):
    """Gradients through ``flash_attention`` (the autograd Function: the
    forward kernel with lse, the backward kernel) against the plain
    backward on fp32 copies of the same inputs, rounded where the kernel
    rounds and unrounded, and the lse against the plain log-sum-exp."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_bwd_rounding_slack,
        flash_attention_lse_plain,
    )
    rng = np.random.default_rng(Sq + hd)
    q, k, v = (_randn(rng, s, dtype, cuda_device).requires_grad_()
               for s in ((B, Sq, H, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)))
    do = _randn(rng, (B, Sq, H, hd), dtype, cuda_device)
    f0, b0 = fops.launch_count, fops.bwd_launch_count
    o = fops.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fops.launch_count, fops.bwd_launch_count) == (f0 + 1, b0 + 1)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    o2, lse = fops.flash_attention_fwd(q.detach(), k.detach(), v.detach(),
                                       causal)
    assert torch.equal(o2, o.detach())
    torch.testing.assert_close(lse, flash_attention_lse_plain(
        qf, kf, vf, causal), atol=1e-4, rtol=1e-5)
    of = o.detach().float()
    rnd = fops.BWD_ROUNDING[dtype]
    slack = ((0.0,) * 3 if rnd is None else flash_attention_bwd_rounding_slack(
        qf, kf, vf, of, lse, do.float(), causal, rnd))
    for round_to, (atol, rtol), sls in ((rnd, BWD_TOL[dtype], slack),
                                        (None, BWD_FP32_TOL[dtype], (0.0,) * 3)):
        want = flash_attention_bwd_plain(qf, kf, vf, of, lse, do.float(),
                                         causal, round_to=round_to)
        for g, w, sl in zip(got, want, sls):
            assert g.dtype == dtype
            err = (g.float() - w).abs()
            assert bool((err <= atol + rtol * w.abs() + sl).all()), \
                (round_to, float(err.max()))


@pytest.mark.cuda
def test_paged_attention_and_mamba_scan_refuse_grad_on_the_card(cuda_device):
    """The paged decode kernel refuses grad on the card.  The scan, which
    refused it until its backward kernel was written, is now held to its
    plain backward by ``test_mamba_scan_backward_kernel_equals_plain``."""
    from repro_torch.kernels.paged_attention import ops as pops
    rng = np.random.default_rng(0)
    q = _randn(rng, (2, 4, 64), torch.float32, cuda_device)
    kp = _randn(rng, (4, 16, 4, 64), torch.float32, cuda_device)
    vp = _randn(rng, (4, 16, 4, 64), torch.float32, cuda_device)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda_device)
    lens = torch.tensor([20, 31], dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="paged_attention on CUDA has no "
                                           "backward"):
        pops.paged_attention(q.requires_grad_(), kp, vp, bt, lens)
    with torch.no_grad():
        pops.paged_attention(q, kp, vp, bt, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,din,N,dtype,with_dh", [
    (2, 1000, 512, 16, torch.float32, False), (1, 1, 64, 16, torch.float32,
                                               True),
    (1, 65, 100, 4, torch.float32, False), (2, 130, 96, 64, torch.float32,
                                            True),
    (1, 64, 64, 1, torch.float32, False), (2, 300, 200, 16, torch.bfloat16,
                                           True),
    # the states every 16 steps and the 4-step sub-chunks: S = 16 + 1 with
    # din off the 64-channel block; a ragged last sub-chunk with rows TMA
    # cannot read (din 100 in bf16: the wrapper pads them), N 8
    (2, 17, 72, 16, torch.bfloat16, False), (1, 22, 100, 8, torch.bfloat16,
                                             True)])
def test_mamba_scan_backward_kernel_equals_plain(B, S, din, N, dtype,
                                                 with_dh, cuda_device):
    """The scan's gradients on the card through ``MambaScan`` (the
    forward kernel with its states, the backward kernel) against
    ``mamba_scan_bwd_plain`` on fp32 copies of the same inputs and states:
    each within 1e-4 of its largest magnitude, plus half a bf16 step of
    each element for a bf16 output; two calls bit-equal."""
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_plain
    rng = np.random.default_rng(S)
    u = _randn(rng, (B, S, din), dtype, cuda_device)
    dt = _randn(rng, (B, S, din), torch.float32, cuda_device).abs() * 0.1
    bc = _randn(rng, (B, S, 8 + 2 * N), dtype, cuda_device)
    Bc, Cc = bc[..., 8:8 + N], bc[..., 8 + N:]
    A_log = _randn(rng, (din, N), torch.float32, cuda_device) * 0.5
    dy = _randn(rng, (B, S, din), dtype, cuda_device)
    dh = _randn(rng, (B, din, N), torch.float32, cuda_device)
    ins = [t.clone().requires_grad_() for t in (u, dt, Bc, Cc, A_log)]
    f0, b0 = sops.launch_count, sops.bwd_launch_count
    y, h = sops.mamba_scan(*ins)
    outs, grads = ((y, h), (dy, dh)) if with_dh else ((y,), (dy,))
    got = torch.autograd.grad(outs, ins, grads)
    torch.cuda.synchronize()
    assert (sops.launch_count, sops.bwd_launch_count) == (f0 + 1, b0 + 1)
    _, _, states = sops.mamba_scan_fwd(u, dt, Bc, Cc, A_log)
    want = mamba_scan_bwd_plain(u.float(), dt, Bc.float(), Cc.float(), A_log,
                                states, dy.float(), dh if with_dh else None)
    for g, w, x in zip(got, want, (u, dt, Bc, Cc, A_log)):
        assert g.dtype == x.dtype
        lim = 1e-4 * float(w.abs().max()) + 1e-30
        if g.dtype == torch.bfloat16:
            m, e = torch.frexp(w)
            lim = lim + torch.ldexp(torch.ones_like(m), e - 9) * (w != 0)
        assert bool(((g.float() - w).abs() <= lim).all())
    first = sops.mamba_scan_bwd(u, dt, Bc, Cc, A_log, states, dy,
                                dh if with_dh else None)
    second = sops.mamba_scan_bwd(u, dt, Bc, Cc, A_log, states, dy,
                                 dh if with_dh else None)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, got))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny"])
def test_train_step_on_the_card_equals_the_cpu(arch, cuda_device):
    """One step of the reduced model (fp32) on the card, its attention
    through both flash kernels, against the same step on the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import build
    from repro_torch.training import optim, step as step_lib

    cfg = reduced(get_config(arch))
    api = build(cfg)
    oc = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = step_lib.make_train_step(api, step_lib.RunConfig(adamw=oc))
    state = step_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                      oc, device="cpu")
    tree = step_lib.train_state_to_numpy(state)
    batch = make_batch(cfg, ShapeCell("t", 32, 4, "train"), seed=5,
                       device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        st = step_lib.train_state_from_numpy(cfg, tree, oc, device=dev)
        b0 = fops.bwd_launch_count
        st, m = step(st, {k: v.to(dev) for k, v in batch.items()})
        if dev != "cpu":
            torch.cuda.synchronize()
            assert fops.bwd_launch_count > b0
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert abs(l_gpu - l_cpu) <= 1e-5 * l_cpu
    assert abs(g_gpu - g_cpu) <= 1e-5 * g_cpu

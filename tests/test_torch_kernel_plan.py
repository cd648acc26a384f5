"""The plain-Python parts of the ``cache_sim`` and ``mamba_scan`` wrappers,
on the CPU: ``cache_sim``'s per-lane planner (where the kernel keeps each
lane) at the SUITE sweeps' real sizes, the key range K a launch touches,
and ``mamba_scan``'s launch plan.  Nothing here needs a card, and nothing
imports ``repro`` or JAX."""

import numpy as np
import pytest
import torch

from repro_torch.core import traces
from repro_torch.core.engine import SweepConfig, grid_init
from repro_torch.core.engine.layout import c2qp_sizes
from repro_torch.kernels.cache_sim import ops
from repro_torch.kernels.cache_sim.ref import cache_sim_plain
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.tuning.sweep import make_grid, relabel

# chip_smoke.py's sweep: capacities as fractions of the footprint x windows
SWEEP_FRACS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5)
SWEEP_WINDOWS = (0.1, 0.3, 0.5, 1.0)
NAMES = [s.name for s in traces.SUITE]


@pytest.fixture(scope="module")
def suite_plans():
    """Per SUITE trace and its metadata trace: the sweep grid's logical
    sizes, K (the relabelled ids are below the unique count) and the
    launch plan."""
    out = {}
    for spec in traces.SUITE:
        d = spec.data()
        for name, tr in ((spec.name, d),
                         (spec.name + "/meta", traces.derive_metadata(d))):
            fp = traces.footprint(tr)
            _, u = relabel(tr)
            grid = make_grid([max(8, int(fp * f)) for f in SWEEP_FRACS],
                             SWEEP_WINDOWS)
            sizes = [c2qp_sizes(c.capacity, c.small_frac, c.ghost_frac,
                                c.window_frac)[:3] for c in grid]
            out[name] = (sizes, u, ops.plan_launch(*zip(*sizes), u))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_every_metadata_lane_lives_in_shared_memory(name, suite_plans):
    sizes, K, plan = suite_plans[name + "/meta"]
    assert plan.tiers == [ops.TIER_WHOLE] * len(sizes)
    largest = (max(ops.ring_bytes(*s) for s in sizes) + ops.table_bytes(K)
               + ops.TRACE_BYTES)
    assert plan.smem_bytes == largest <= ops.SMEM_BLOCK
    assert plan.blocks_per_sm == ops.blocks_per_sm(largest) >= 4


@pytest.mark.parametrize("name", NAMES)
def test_data_sweep_lanes_keep_what_fits(name, suite_plans):
    """The widest data lane never lives whole in shared memory; every
    lane's tier is the first of the order whole, rings, Small and Ghost
    rings, none whose bytes fit one block."""
    sizes, K, plan = suite_plans[name]
    assert plan.tiers[-1] != ops.TIER_WHOLE
    for (S, M, G), tier in zip(sizes, plan.tiers):
        fits = [ops.ring_bytes(S, M, G) + ops.table_bytes(K),
                ops.ring_bytes(S, M, G), ops.small_bytes(S, G)]
        first = next((i for i, b in enumerate(fits)
                      if b + ops.TRACE_BYTES <= ops.SMEM_BLOCK),
                     ops.TIER_GLOBAL)
        assert tier == first
    assert plan.smem_bytes <= ops.SMEM_BLOCK


@pytest.mark.parametrize("name,tier", [("w01-skewed", ops.TIER_SMALL),
                                       ("w04-scans", ops.TIER_GLOBAL)])
def test_the_widest_data_lanes(name, tier, suite_plans):
    """w01-skewed's widest lane keeps its Small and Ghost rings on chip;
    w04-scans' (the largest trace) keeps nothing there."""
    assert suite_plans[name][2].tiers[-1] == tier


@pytest.mark.parametrize("S,M,G,K,tier,smem", [
    (10, 90, 50, 1000, ops.TIER_WHOLE, 90 + 450 + 200 + 5000),
    (10, 90, 50, 60_000, ops.TIER_RINGS, 90 + 450 + 200),
    (4042, 36373, 20208, 80_831, ops.TIER_SMALL, 9 * 4042 + 4 * 20208),
    (13516, 121643, 67580, 270_318, ops.TIER_GLOBAL, 0),
])
def test_plan_lane_bytes_and_tier(S, M, G, K, tier, smem):
    """Each tier's shared memory: its arrays beside the trace ring."""
    p = ops.plan_lane(S, M, G, K)
    assert (p.tier, p.smem_bytes) == (tier, smem + ops.TRACE_BYTES)
    assert p.blocks_per_sm == ops.blocks_per_sm(smem + ops.TRACE_BYTES)


@pytest.mark.parametrize("smem,blocks", [(0, 32), (1, 32), (6000, 32),
                                         (7000, 28), (43_800, 5),
                                         (232_000, 1)])
def test_blocks_per_sm(smem, blocks):
    assert ops.blocks_per_sm(smem) == blocks


def test_a_mixed_grid_takes_the_largest_lane_s_bytes():
    plan = ops.plan_launch([10, 2000], [90, 18000], [50, 10000], 20_000)
    assert plan.tiers == [ops.TIER_WHOLE, ops.TIER_RINGS]
    assert plan.smem_bytes == (ops.ring_bytes(2000, 18000, 10000)
                               + ops.TRACE_BYTES)
    assert plan.blocks_per_sm == 1


def test_key_range_counts_the_rings_of_earlier_chunks():
    """After a chunk of keys up to 999, a chunk of keys below 100: K is
    1 + the largest key still in a ring, not the chunk's maximum."""
    rng = np.random.default_rng(0)
    st = grid_init([SweepConfig(64), SweepConfig(200, window_frac=1.0)],
                   1024, device="cpu")
    first = torch.from_numpy(rng.integers(0, 1000, 600).astype(np.int32))
    cache_sim_plain(st, first, "counts")
    second = torch.from_numpy(rng.integers(0, 100, 300).astype(np.int32))
    ring_max = max(int(st[k].max()) for k in ("skey", "mkey", "gkey"))
    assert ring_max >= 100
    assert ops.key_range(st, second) == 1 + ring_max
    assert ops.key_range(st, second) > 1 + int(second.max())


def test_key_range_of_an_empty_state_and_padding():
    st = grid_init([SweepConfig(16)], 64, device="cpu")
    assert ops.key_range(st, torch.full((5,), -1, dtype=torch.int32)) == 1
    assert ops.key_range(st, torch.tensor([3, 40, -1],
                                          dtype=torch.int32)) == 41


def test_ring_key_outside_the_universe_is_refused():
    st = grid_init([SweepConfig(16)], 64, device="cpu")
    st["mkey"][0, 0] = 64
    with pytest.raises(ValueError, match="universe"):
        ops.cache_sim(st, torch.zeros(4, dtype=torch.int32))


# -- mamba_scan's launch plan ----------------------------------------------------


def test_scan_plan_at_falcon_mamba_prefill_is_one_wave():
    """(4, 2048, 8192, 16): two threads a channel, 64 channels a block,
    512 blocks of 128 threads and 40 KB, 4 an SM: 528 >= 512."""
    p = sops.scan_plan(4, 2048, 8192, 16)
    assert (p.split, p.channels, p.blocks, p.smem_bytes) == (2, 64, 512,
                                                             40_960)
    assert p.blocks_per_sm == 4 and p.one_wave
    assert sops.SMS * p.blocks_per_sm >= p.blocks


@pytest.mark.parametrize("shape,split,channels,smem", [
    ((2, 32, 64, 4), 1, 128, 4 * (2 * 64 * 128 + 2 * 64 * 4)),
    ((1, 100, 96, 8), 2, 64, 4 * (2 * 64 * 64 + 2 * 64 * 8)),
    ((1, 130, 200, 12), 2, 64, 4 * (2 * 64 * 64 + 2 * 64 * 16)),
    ((2, 100, 300, 64), 2, 64, 4 * (2 * 64 * 64 + 2 * 64 * 64)),
])
def test_scan_plan_by_state_count(shape, split, channels, smem):
    p = sops.scan_plan(*shape)
    assert (p.split, p.channels, p.smem_bytes) == (split, channels, smem)
    assert p.blocks == -(-shape[2] // channels) * shape[0]


@pytest.mark.parametrize("N,split", [(1, 1), (3, 1), (4, 1), (5, 2),
                                     (33, 2), (64, 2)])
def test_scan_plan_threads_a_channel_follow_from_N(N, split):
    """One thread a channel up to N = 4 (the kernel's only one-thread
    instantiation), two above."""
    p = sops.scan_plan(1, 8, 64, N)
    assert (p.split, p.channels) == (split, sops.THREADS // split)

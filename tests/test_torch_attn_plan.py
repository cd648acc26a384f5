"""The plain-Python parts of the two attention kernels' wrappers, on the
CPU: ``flash_attention``'s route by input type and its TMA predicate,
and ``paged_attention``'s split planner, the cut of a sequence it hands
the kernel and its scratch, reused per shape and stream.  Nothing here needs a card, and
nothing imports ``repro`` or JAX."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.paged_attention import ops as pops

# -- flash_attention: the dtype route ------------------------------------------


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")])
def test_flash_route_follows_the_input_type(dtype, route):
    assert fops.route(dtype) == route
    assert route in fops.KERNELS    # what the C entry point is told to run


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_route_refuses_other_types(dtype):
    with pytest.raises(TypeError):
        fops.route(dtype)


# -- flash_attention: what TMA can load ----------------------------------------

CALL_SITES = {  # (B, S, H, Hkv, hd): granite-3-8b prefill, zamba2's shared
    # attention block
    "granite": (1, 1088, 32, 8, 128),
    "zamba2": (4, 2048, 32, 32, 80),
}


def _projected(B, S, H, Hkv, hd):
    """q, k, v as the models hand them over: reshaped projections, then
    q and k rotated (``layers.rotate`` concatenates, so contiguous)."""
    proj = lambda n: torch.zeros(B, S, n * hd, dtype=torch.bfloat16).reshape(
        B, S, n, hd)
    rotate = lambda x: torch.cat([x[..., :hd // 2], x[..., hd // 2:]], -1)
    return rotate(proj(H)), rotate(proj(Hkv)), proj(Hkv)


@pytest.mark.parametrize("site", sorted(CALL_SITES))
def test_tma_predicate_takes_the_models_call_sites(site):
    q, k, v = _projected(*CALL_SITES[site])
    assert all(fops.tma_compatible(t) for t in (q, k, v))
    fops.check_tma(q, k, v)


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_tma_predicate_takes_views_of_one_fused_tensor(hd):
    qkv = torch.zeros(2, 40, 3, 8, hd, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    fops.check_tma(q, k, v)


def test_tma_predicate_refuses_a_misaligned_start():
    flat = torch.zeros(1 + 2 * 16 * 4 * 64, dtype=torch.bfloat16)
    q = flat[1:].view(2, 16, 4, 64)          # starts 2 bytes past a boundary
    assert q.data_ptr() % 16 and not fops.tma_compatible(q)
    ok = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        fops.check_tma(q, ok, ok)


def test_tma_predicate_refuses_a_stride_off_the_16_byte_grid():
    q = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64]
    assert q.stride(2) * 2 % 16 and not fops.tma_compatible(q)
    ok = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="TMA"):
        fops.check_tma(ok, q, ok)


def test_kernel_strides_give_unit_axes_the_dense_stride():
    t = torch.zeros(1, 16, 4, 64, dtype=torch.bfloat16)[:, :1, :, :]
    assert fops.kernel_strides(t) == (1 * 4 * 64, 4 * 64, 64)
    big = torch.zeros(3, 5, 4, 64)
    assert fops.kernel_strides(big) == big.stride()[:3]


# -- paged_attention: the split planner and the kernel's cut ----------------

SERVE_LENGTHS = [1196, 1263, 1372, 1487, 1663, 1839, 1910, 1985]


def test_planner_fills_the_card_at_serve_mains_batch():
    n = pops.plan_splits(8, 8, 160 * 16)      # B 8, Hkv 8, 160 blocks of 16
    assert 8 * 8 * n >= pops.SMS               # at least one block a SM
    assert 8 * 8 * n <= pops.WAVES * pops.SMS  # and one wave of them


@pytest.mark.parametrize("B,Hkv,max_len", [(1, 8, 2560), (2, 1, 64),
                                           (64, 8, 4096), (3, 2, 5)])
def test_planner_stays_in_range(B, Hkv, max_len):
    n = pops.plan_splits(B, Hkv, max_len)
    assert 1 <= n <= -(-max_len // pops.CHUNK)
    assert n == 1 or B * Hkv * n <= pops.WAVES * pops.SMS


@pytest.mark.parametrize("length", [1, 15, 16, 17, 63, 64, 65, 1196, 1985,
                                    2560])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 4, 7, 160])
def test_splits_cover_every_position_once(length, n_splits):
    seen = [0] * length
    for s in range(n_splits):
        lo, hi = pops.split_range(s, length, n_splits)
        assert 0 <= lo <= hi <= length and lo % pops.CHUNK == 0
        for p in range(lo, hi):
            seen[p] += 1
    assert seen == [1] * length


@pytest.mark.parametrize("length", SERVE_LENGTHS)
def test_no_planned_block_is_empty_at_serve_mains_lengths(length):
    n = pops.plan_splits(len(SERVE_LENGTHS), 8, 160 * 16)
    sizes = [hi - lo for lo, hi in (pops.split_range(s, length, n)
                                    for s in range(n))]
    assert min(sizes) > 0 and max(sizes) - min(sizes) <= pops.CHUNK


def test_scratch_is_made_once_per_shape():
    a = pops._scratch_for(torch.device("cpu"), 0, 8, 8, 4, 4, 128)
    b = pops._scratch_for(torch.device("cpu"), 0, 8, 8, 4, 4, 128)
    c = pops._scratch_for(torch.device("cpu"), 0, 4, 8, 4, 4, 128)
    assert a[0] is b[0] and a[1] is b[1] and a[0] is not c[0]
    assert a[0].numel() == 8 * 8 * 4 * 4 * (128 + 2)
    assert a[1].dtype == torch.int32 and not bool(a[1].any())


def test_scratch_is_not_shared_between_streams():
    a = pops._scratch_for(torch.device("cpu"), 1, 8, 8, 4, 4, 128)
    b = pops._scratch_for(torch.device("cpu"), 2, 8, 8, 4, 4, 128)
    assert a[0] is not b[0] and a[1] is not b[1]
    assert a[0] is pops._scratch_for(torch.device("cpu"), 1, 8, 8, 4, 4, 128)[0]


def test_paged_wrapper_refuses_a_head_dim_off_the_8_grid():
    q = torch.zeros(2, 4, 36)
    pool = torch.zeros(6, 4, 2, 36)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        pops.paged_attention(q, pool, pool, bt, lens)

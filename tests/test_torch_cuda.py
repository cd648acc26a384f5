"""The port's Hopper kernels (``cache_sim``, ``flash_attention``,
``paged_attention``) against their plain PyTorch versions, on a card.
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


# -- attention kernels -------------------------------------------------------

FLASH_SHAPES = [  # B, S, H, Hkv, hd, causal: tests/test_kernels.py, granite
    (2, 128, 4, 2, 64, True),
    (1, 256, 2, 2, 128, False),
    (2, 96, 4, 1, 80, True),
    (1, 64, 2, 2, 32, True),
    (1, 1000, 32, 8, 128, True),
]
PAGED_SHAPES = [  # B, H, Hkv, d, N, bs, nb: tests/test_kernels.py, granite
    (3, 4, 2, 64, 16, 8, 4),
    (2, 8, 8, 128, 32, 16, 3),
    (1, 4, 1, 32, 8, 4, 2),
    (8, 32, 8, 128, 1024, 16, 160),
]
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 3e-2)}


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal", FLASH_SHAPES)
def test_flash_attention_kernel_equals_plain(B, S, H, Hkv, hd, causal, dtype,
                                             cuda_device):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    rng = np.random.default_rng(S + hd)
    q = _randn(rng, (B, S, H, hd), dtype, cuda_device)
    k = _randn(rng, (B, S, Hkv, hd), dtype, cuda_device)
    v = _randn(rng, (B, S, Hkv, hd), dtype, cuda_device)
    before = fops.launch_count
    got = fops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.launch_count == before + 1
    want = flash_attention_plain(q, k, v, causal)
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
    tol = ATTN_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

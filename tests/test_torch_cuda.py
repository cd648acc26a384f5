"""The Hopper ``cache_sim`` kernel against its plain PyTorch version, on
a card.  Every test here is marked ``cuda`` and skips without one.

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
        pytest.skip("needs a CUDA device: the cache_sim kernel runs only "
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

"""The ``cache_sim`` wrapper of the port (``repro_torch.kernels.cache_sim``).

On the CPU the wrapper runs the kernel's plain version and launches
nothing; it is held against the reference kernel's oracle
(``repro.kernels.cache_sim.ref.cache_sim_ref``) on the shapes of
``tests/test_kernels.py``.  ``tests/test_torch_cuda.py`` holds the
Hopper kernel itself against the plain version on a card.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.kernels.cache_sim.ref import cache_sim_ref
from repro_torch.core import engine as peng
from repro_torch.core import torch_engine as pte
from repro_torch.kernels.cache_sim import ops
from repro_torch.tuning import sweep as psweep

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
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


def _lanes(cap, L, universe, device):
    return peng.grid_init([peng.SweepConfig(cap)] * L, universe,
                          device=device)


@pytest.mark.parametrize("cap,T,L,U", SHAPES)
def test_wrapper_on_cpu_matches_reference_oracle(cap, T, L, U, monkeypatch):
    monkeypatch.setattr(ops, "launch_count", 0)
    traces = _traces(T, L, U, seed=cap)
    ref = cache_sim_ref(traces, cap)
    st = _lanes(cap, L, int(traces.max()) + 1, "cpu")
    hits = ops.cache_sim(st, torch.from_numpy(traces), "hits")
    assert hits.dtype == torch.bool and hits.shape == (L, T)
    assert np.array_equal(hits.numpy(), ref)
    st = _lanes(cap, L, int(traces.max()) + 1, "cpu")
    counts = ops.cache_sim(st, torch.from_numpy(traces), "counts")
    assert counts.dtype == torch.int64
    assert np.array_equal(counts.numpy(), ref.sum(axis=1))
    assert ops.launch_count == 0  # the CPU path launched no kernel


def test_shared_trace_row_equals_one_row_per_lane():
    traces = _traces(500, 3, 120, seed=1)
    cfgs = [peng.SweepConfig(c, window_frac=w) for c in (12, 60)
            for w in (0.1, 1.0)]
    a = peng.grid_init(cfgs, 120, device="cpu")
    b = peng.grid_init(cfgs, 120, device="cpu")
    row = torch.from_numpy(traces[0])
    ha = ops.cache_sim(a, row, "hits")
    hb = ops.cache_sim(b, row.expand(len(cfgs), -1).contiguous(), "hits")
    assert torch.equal(ha, hb)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_padding_keys_are_no_ops():
    tr = _traces(300, 1, 90, seed=2)[0]
    a = pte.init_state("clock2q+", 30, 90, device="cpu")
    b = pte.init_state("clock2q+", 30, 90, device="cpu")
    padded = np.where(np.arange(600) % 2 == 0, -1,
                      np.repeat(tr, 2)).astype(np.int32)
    ha = ops.cache_sim(a, torch.from_numpy(tr), "hits")
    hb = ops.cache_sim(b, torch.from_numpy(padded), "hits")
    assert torch.equal(hb[:, 1::2], ha) and not hb[:, ::2].any()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    st = _lanes(20, 2, 50, "cpu")
    good = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.cache_sim(st, good.long())
    with pytest.raises(ValueError):
        ops.cache_sim(st, torch.zeros((2, 10), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="universe"):
        ops.cache_sim(st, torch.full((10,), 50, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.cache_sim(st, torch.zeros((3, 10), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.cache_sim(st, good, out="both")
    bad = dict(st, mref=st["mref"].to(torch.int32))
    with pytest.raises(TypeError):
        ops.cache_sim(bad, good)
    bad = dict(st, mcap=st["mcap"] + 10_000)
    with pytest.raises(ValueError, match="physical"):
        ops.cache_sim(bad, good)


def test_entry_points_without_a_device_need_cuda(monkeypatch):
    """With no ``device=``, entry points run on CUDA; where it is absent
    they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _traces(100, 1, 40, seed=3)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        psweep.sweep_hits(tr, psweep.make_grid([8, 16]))
    with pytest.raises(RuntimeError, match="CUDA"):
        pte.init_state("clock2q+", 16, 40)
    with pytest.raises(RuntimeError, match="CUDA"):
        pte.replay_np("clock2q+", tr, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        peng.grid_init([peng.SweepConfig(16)], 40)


def test_build_is_not_imported_with_the_package():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    if not m.name.endswith('.build'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'repro_torch.kernels.cache_sim.ops' in sys.modules\n"
        "assert 'repro_torch.kernels.cache_sim.build' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

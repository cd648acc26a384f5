"""The port's attention kernels' plain versions against the reference's
Pallas kernels (interpret mode) and their oracles, on the CPU, and the
wrappers' CPU path and input checks.

Inputs are made with numpy from a seed and handed to both packages, at
the shapes of ``tests/test_kernels.py`` and its tolerances: 2e-5 in
fp32, 2e-2 (flash) and 3e-2 (paged) in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.ops import paged_attention as j_paged
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

FLASH_SHAPES = [  # tests/test_kernels.py:24-29
    (2, 128, 4, 2, 64, True),
    (1, 256, 2, 2, 128, False),
    (2, 96, 4, 1, 80, True),
    (1, 64, 2, 2, 32, True),
]
PAGED_SHAPES = [  # tests/test_kernels.py:50-54
    (3, 4, 2, 64, 16, 8, 4),
    (2, 8, 8, 128, 32, 16, 3),
    (1, 4, 1, 32, 8, 4, 2),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a jax array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    x = jnp.asarray(arr, jd)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(td)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal", FLASH_SHAPES)
def test_flash_plain_equals_reference(B, S, H, Hkv, hd, causal, dtype):
    rng = np.random.default_rng(S * hd + H)
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng.normal(0, 1, s), dtype)
        for s in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    got = flash_attention_plain(q, k, v, causal)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    tol = 2e-5 if dtype == "float32" else 2e-2
    pallas = j_flash(jq, jk, jv, causal=causal, block_q=64, block_kv=64,
                     interpret=True)
    _close(got, pallas, tol)
    rep = H // Hkv
    qb = jq.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    kb = jnp.repeat(jk, rep, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, S, hd)
    vb = jnp.repeat(jv, rep, axis=2).transpose(0, 2, 1, 3).reshape(
        B * H, S, hd)
    oracle = attention_ref(qb, kb, vb, causal=causal).reshape(
        B, H, S, hd).transpose(0, 2, 1, 3)
    _close(got, oracle, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,d,N,bs,nb", PAGED_SHAPES)
def test_paged_plain_equals_reference(B, H, Hkv, d, N, bs, nb, dtype):
    rng = np.random.default_rng(N * d + B)
    (jq, q), (jk, kp), (jv, vp) = (
        _pair(rng.normal(0, 1, s), dtype)
        for s in ((B, H, d), (N, bs, Hkv, d), (N, bs, Hkv, d)))
    bt = rng.choice(N, size=(B, nb)).astype(np.int32)
    lens = rng.integers(1, nb * bs + 1, size=(B,)).astype(np.int32)
    got = paged_attention_plain(q, kp, vp, torch.from_numpy(bt),
                                torch.from_numpy(lens))
    assert got.dtype == q.dtype and got.shape == (B, H, d)
    tol = 2e-5 if dtype == "float32" else 3e-2
    jbt, jlens = jnp.asarray(bt), jnp.asarray(lens)
    _close(got, j_paged(jq, jk, jv, jbt, jlens, interpret=True), tol)
    _close(got, paged_attention_ref(jq, jk, jv, jbt, jlens), tol)


def test_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    q, k, v = t(1, 40, 4, 32), t(1, 40, 2, 32), t(1, 40, 2, 32)
    f0, p0 = fops.launch_count, pops.launch_count
    assert torch.equal(fops.flash_attention(q, k, v, causal=True),
                       flash_attention_plain(q, k, v, True))
    qd, kp, vp = t(2, 4, 32), t(6, 4, 2, 32), t(6, 4, 2, 32)
    bt = torch.tensor([[5, 0, 3], [1, 2, 0]], dtype=torch.int32)
    lens = torch.tensor([9, 5], dtype=torch.int32)
    assert torch.equal(pops.paged_attention(qd, kp, vp, bt, lens),
                       paged_attention_plain(qd, kp, vp, bt, lens))
    assert (fops.launch_count, pops.launch_count) == (f0, p0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(TypeError):
        fops.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        fops.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        fops.flash_attention(q, torch.zeros(1, 8, 2, 16), kv)   # head_dim
    with pytest.raises(ValueError):
        fops.flash_attention(q, torch.zeros(1, 8, 3, 32),
                             torch.zeros(1, 8, 3, 32))           # 4 % 3
    with pytest.raises(ValueError):
        fops.flash_attention(torch.zeros(1, 8, 4, 36),
                             torch.zeros(1, 8, 2, 36),
                             torch.zeros(1, 8, 2, 36))           # hd % 8
    with pytest.raises(ValueError):
        fops.flash_attention(q, torch.zeros(1, 8, 2, 64)[..., ::2], kv)


def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 32)
    pool = torch.zeros(6, 4, 2, 32)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        pops.paged_attention(q.bfloat16(), pool, pool, bt, lens)
    with pytest.raises(TypeError):
        pops.paged_attention(q, pool, pool, bt.long(), lens)
    with pytest.raises(ValueError):                               # shapes
        pops.paged_attention(q, pool, torch.zeros(6, 4, 2, 16), bt, lens)
    with pytest.raises(ValueError):
        pops.paged_attention(q, pool, pool, bt[:1], lens)
    with pytest.raises(ValueError):                               # layout
        strided = torch.zeros(6, 8, 2, 32)[:, ::2]
        pops.paged_attention(q, strided, strided, bt, lens)
    with pytest.raises(ValueError):                               # values
        pops.paged_attention(q, pool, pool, bt + 6, lens)
    with pytest.raises(ValueError):
        pops.paged_attention(q, pool, pool, bt, lens * 13)

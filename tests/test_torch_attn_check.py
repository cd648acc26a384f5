"""The power of ``chip_smoke.py``'s bf16 check of the contiguous caches'
one-page views and whisper's flash shapes, on the CPU.

A kernel that drops a page's partial last chunk (paged) or the partial
last KV tile (flash) returns the plain version over the cut length.  At
each of ``ONE_PAGE_CASES``' and ``CROSS_CASES``' shapes with such a tail,
``NEW_BF16_TOL`` must reject that output and take the plain version's
own.  On the paged cases ``ATTN_TOL`` takes the faulty output too, which
is why the new cases have a limit of their own.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention.ref import paged_attention_plain

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
PAGED = [(B, S_max, H, Hkv, d, n) for B, S_max, H, Hkv, d, lens
         in CS.ONE_PAGE_CASES for n in lens
         if n > pops.CHUNK and n % pops.CHUNK]
# B cut to 1: the flash plain version's (B, H, Sq, Skv) scores stay small
FLASH = [(1, Sq, Skv, H, Hkv, hd) for B, Sq, Skv, H, Hkv, causal, hd
         in CS.CROSS_CASES
         if not causal and Skv > CS.WGMMA_KV_TILE and Skv % CS.WGMMA_KV_TILE]


def _randn(rng, *shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
        torch.bfloat16)


def test_the_cases_have_partial_tails():
    assert len(PAGED) >= 4 and len(FLASH) >= 3


@pytest.mark.parametrize("B,S_max,H,Hkv,d,n", PAGED)
def test_one_page_check_rejects_a_dropped_partial_chunk(B, S_max, H, Hkv, d,
                                                        n):
    rng = np.random.default_rng(0)
    q, kc, vc = (_randn(rng, B, H, d), _randn(rng, B, S_max, Hkv, d),
                 _randn(rng, B, S_max, Hkv, d))
    tables = torch.arange(B, dtype=torch.int32)[:, None]
    run = lambda m: paged_attention_plain(
        q, kc, vc, tables, torch.full((B,), m, dtype=torch.int32))
    want, fault = run(n), run(n - n % pops.CHUNK)
    assert CS._err(want, want, *CS.NEW_BF16_TOL)[1]
    assert not CS._err(fault, want, *CS.NEW_BF16_TOL)[1]
    assert CS._err(fault, want, CS.ATTN_TOL["bfloat16"][1])[1]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd", FLASH)
def test_whisper_flash_check_rejects_a_dropped_partial_tile(B, Sq, Skv, H,
                                                            Hkv, hd):
    rng = np.random.default_rng(0)
    q, k, v = (_randn(rng, B, Sq, H, hd), _randn(rng, B, Skv, Hkv, hd),
               _randn(rng, B, Skv, Hkv, hd))
    cut = Skv - Skv % CS.WGMMA_KV_TILE
    want = flash_attention_plain(q, k, v, False)
    fault = flash_attention_plain(q, k[:, :cut], v[:, :cut], False)
    assert CS._err(want, want, *CS.NEW_BF16_TOL)[1]
    assert not CS._err(fault, want, *CS.NEW_BF16_TOL)[1]

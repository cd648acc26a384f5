"""The power of ``chip_smoke.py``'s training checks, on the CPU.

``bwd_case_check`` holds the forward's out and lse to the plain forward
and the backward to the plain backward given the plain lse.  On the CPU
the "kernel" is the plain version, so every honest limit use is small,
and each planted fault (D left out, the last KV tile dropped, an lse
stored in base 2) must use more than its limit.  ``grad_rel_errors``
and ``BF16_GRAD_TOL`` are checked on a narrow olmo-1b: the bf16
gradients sit well inside the limit of the fp32 ones.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
# B, Sq, Skv, H, Hkv, hd, causal: small cuts of FLASH_BWD_CASES' kinds
CASES = [(1, 65, 65, 4, 2, 32, True), (1, 100, 150, 2, 2, 16, False),
         (1, 1, 1, 4, 2, 32, True), (2, 130, 130, 4, 4, 24, True)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_bwd_case_check_passes_the_plain_version(case, dt):
    rec = CS.bwd_case_check("cpu", dt, case, np.random.default_rng(0))
    assert rec["out_limit_use"] <= 0.5
    assert rec["lse_limit_use"] <= 0.5
    assert rec["limit_use"] <= 0.5


@pytest.mark.parametrize("case", CASES)
def test_bwd_case_check_fails_every_planted_fault(case):
    rec = CS.bwd_case_check("cpu", "bfloat16", case,
                            np.random.default_rng(1))
    faults = rec["fault_limit_use"]
    want = {"no_delta", "base2_lse", "base2_lse_bwd"}
    if case[2] > CS.BWD_KV_TILE:
        want.add("dropped_kv_tile")
    assert set(faults) == want
    assert min(faults.values()) > 1.0


def test_grad_rel_errors():
    want = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    got = {"a": torch.full((3,), 1.5), "b": {"c": torch.zeros(2)}}
    assert CS.grad_rel_errors(got, want) == {"/a": 0.5, "/b/c": 0.0}
    got["b"]["c"] = torch.ones(2)
    assert CS.grad_rel_errors(got, want)["/b/c"] == math.inf


def test_bf16_gradients_within_the_limit_of_fp32():
    """olmo-1b narrowed to d 256 at 2 layers on 1 x 64 tokens: the bf16
    loss's gradients against the fp32 loss's on the same values."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import (
        build, params_from_numpy, params_to_numpy,
    )
    from repro_torch.training import step as step_lib

    c16 = dataclasses.replace(get_config("olmo-1b"), n_layers=2, d_model=256,
                              n_heads=2, n_kv_heads=2, d_ff=1024, vocab=4096)
    c32 = dataclasses.replace(c16, dtype="float32", param_dtype="float32")
    a16, a32 = build(c16), build(c32)
    p16 = a16.init(torch.Generator().manual_seed(0), "cpu")
    p32 = params_from_numpy(c32, params_to_numpy(p16), "cpu")
    batch = make_batch(c16, ShapeCell("t", 64, 1, "train"), seed=6,
                       device="cpu")
    _, _, g16 = step_lib.value_and_grad(a16, p16, batch)
    _, _, g32 = step_lib.value_and_grad(a32, p32, batch)
    rel = CS.grad_rel_errors(g16, g32)
    assert max(rel.values()) <= CS.BF16_GRAD_TOL / 2
    assert max(rel.values()) > 0      # bf16 is not fp32


def test_causal_bf16_rounding_of_p_needs_attn_tol():
    """The bf16 forward rounds P to bf16 before P V.  On causal rows over
    a few positions that rounding alone exceeds ``NEW_BF16_TOL``, which
    is why ``bwd_fwd_tol`` keeps ``ATTN_TOL`` for causal bf16 cases."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 8, 1024, 128)).astype(
        np.float32)).bfloat16().float() for _ in range(3))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(128)
    s = s.masked_fill(~torch.ones(1024, 1024, dtype=torch.bool).tril(),
                      -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    want = (p @ v) / l
    got = ((p.bfloat16().float() @ v) / l).bfloat16()
    assert CS.limit_use(got, want, *CS.NEW_BF16_TOL) > 1.0
    assert CS.limit_use(got, want, *CS.bwd_fwd_tol("bfloat16", True)) < 0.5
    assert CS.bwd_fwd_tol("bfloat16", False) == CS.NEW_BF16_TOL

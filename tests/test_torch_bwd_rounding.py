"""The bf16 backward's oracle, on the CPU.

The tensor-core backward (``flash_attention_bwd.cu``, bf16 route) rounds
P to bf16 before dV = P^T dO and dS before dQ = dS K and dK = dS^T Q.
``flash_attention_bwd_plain(round_to=torch.bfloat16)`` rounds where it
does; ``chip_smoke.py`` holds the kernel to that version at
``NEW_BF16_TOL`` plus ``flash_attention_bwd_rounding_slack`` (one bf16
step of the largest term of each element's sum), and to the unrounded
fp32 version at ``ATTN_TOL``.  These tests show why each limit is what it
is: the rounding itself sits well inside ``ATTN_TOL`` and is the
reference's own precision; two exact fp32 paths of the rounded recipe
can round a step apart, beyond ``NEW_BF16_TOL`` but inside the slack;
and every planted fault still fails the rounded check.
"""

from __future__ import annotations

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    _masked, _scores, flash_attention_bwd_plain,
    flash_attention_bwd_rounding_slack, flash_attention_lse_plain,
    flash_attention_plain,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
NEW_BF16_TOL = CS.NEW_BF16_TOL                 # (1e-3, 3e-2)
ATTN_TOL = CS.ATTN_TOL["bfloat16"]             # (2e-2, 3e-2)
# B, Sq, Skv, H, Hkv, hd, causal: the causal short rows where P's and
# dS's rounding is largest, and full attention with Sq != Skv
CAUSAL = (1, 65, 65, 4, 2, 128, True)
FULL = (1, 100, 150, 2, 2, 64, False)


def _inputs(case, seed):
    """q, k, v, dO as bf16 values held in fp32, the plain forward's out
    (rounded to bf16, as the bf16 forward returns it) and lse on them."""
    B, Sq, Skv, H, Hkv, hd, causal = case
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).bfloat16().float()
    q, k, v, do = g(B, Sq, H, hd), g(B, Skv, Hkv, hd), g(B, Skv, Hkv, hd), \
        g(B, Sq, H, hd)
    return (q, k, v, do,
            flash_attention_plain(q, k, v, causal).bfloat16().float(),
            flash_attention_lse_plain(q, k, v, causal))


def _use(got, want, atol, rtol, slack=(0.0, 0.0, 0.0)) -> float:
    return max(CS.limit_use(a, w, atol, rtol, s)
               for a, w, s in zip(got, want, slack))


def _bwd_before(q, k, v, o, lse, do, causal):
    """The plain backward as it was before ``round_to``: the unrounded
    function that ``round_to=None`` must repeat bit for bit."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / hd ** 0.5
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq)[..., None])
    if causal:
        p = p.masked_fill(_masked(Sq, Skv, q.device), 0.0)
    dog = do.float().reshape(B, Sq, Hkv, G, hd)
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    dsum = (do.float() * o.float()).sum(-1)
    dsum = dsum.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("case", [CAUSAL, FULL, (2, 9, 13, 6, 2, 8, True),
                                  (1, 13, 5, 2, 1, 24, False)], ids=str)
def test_round_to_none_is_the_unrounded_backward_bit_for_bit(case):
    q, k, v, do, o, lse = _inputs(case, 0)
    want = _bwd_before(q, k, v, o, lse, do, case[-1])
    for got in (flash_attention_bwd_plain(q, k, v, o, lse, do, case[-1]),
                flash_attention_bwd_plain(q, k, v, o, lse, do, case[-1],
                                          round_to=None)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", [CAUSAL, FULL], ids=str)
def test_rounding_is_within_half_of_attn_tol(case):
    """The bf16 rounding of P and dS moves the gradients by well under
    ``ATTN_TOL`` (half of it, for margin), and by more than nothing."""
    q, k, v, do, o, lse = _inputs(case, 1)
    rounded = flash_attention_bwd_plain(q, k, v, o, lse, do, case[-1],
                                        round_to=torch.bfloat16)
    exact = flash_attention_bwd_plain(q, k, v, o, lse, do, case[-1])
    assert _use(rounded, exact, *ATTN_TOL) <= 0.5
    assert max(float((a - b).abs().max()) for a, b in zip(rounded, exact)) > 0


def test_reference_bf16_gradient_has_the_same_precision():
    """The reference's own bf16 gradient (``jax.vjp`` of
    ``layers.attention`` on bf16 inputs, on the CPU) is no closer to the
    fp32 gradient: it exceeds ``NEW_BF16_TOL`` against it, as the rounded
    recipe does on causal rows, and stays within half of ``ATTN_TOL``."""
    q, k, v, do, o, lse = _inputs(CAUSAL, 2)
    qj, kj, vj, doj = (jnp.asarray(t.numpy(), dtype=jnp.bfloat16)
                       for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: JL.attention(a, b, c, causal=True),
                     qj, kj, vj)
    ref = [torch.from_numpy(np.asarray(g, dtype=np.float32))
           for g in vjp(doj)]
    exact = flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    assert _use(ref, exact, *NEW_BF16_TOL) > 1.0
    assert _use(ref, exact, *ATTN_TOL) <= 0.5
    rounded = flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                        round_to=torch.bfloat16)
    assert _use(rounded, exact, *NEW_BF16_TOL) > 1.0


def _recipe_fp64(q, k, v, o, lse, do, causal):
    """The rounded recipe on a second fp32 path: P, dP and dS formed in
    fp64, then cast to fp32 and rounded to bf16 -- the same function as
    ``round_to=torch.bfloat16``, summed in another order."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qd = q.double().reshape(B, Sq, Hkv, G, hd)
    dod = do.double().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qd, k.double()) / hd ** 0.5
    p = torch.exp(s - lse.double().reshape(B, Hkv, G, Sq)[..., None])
    if causal:
        p = p.masked_fill(_masked(Sq, Skv, q.device), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dod, v.double())
    dsum = (do * o).sum(-1).double().reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    rnd = lambda t: t.float().bfloat16().double()
    ds = rnd(p * (dp - dsum[..., None]))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dod)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.double()) / hd ** 0.5
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qd) / hd ** 0.5
    return tuple(t.float() for t in (dq.reshape(B, Sq, H, hd), dk, dv))


def test_two_fp32_paths_round_a_step_apart_within_the_slack():
    """At kimi-k2's head_dim on short causal rows, the rounded recipe on
    a second fp32 path lands one bf16 step of a large dS away from
    ``round_to``'s on some element: beyond ``NEW_BF16_TOL`` alone, within
    it plus the slack (which stays a small fraction of the gradients)."""
    case = (1, 65, 65, 4, 4, 112, True)
    q, k, v, do, o, lse = _inputs(case, 65 + 112)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                     round_to=torch.bfloat16)
    other = [t.bfloat16() for t in _recipe_fp64(q, k, v, o, lse, do, True)]
    slack = flash_attention_bwd_rounding_slack(q, k, v, o, lse, do, True)
    assert _use(other, want, *NEW_BF16_TOL) > 1.0
    assert _use(other, want, *NEW_BF16_TOL, slack) <= 0.75
    for s, w in zip(slack, want):
        assert s.shape == w.shape and float(s.max()) < 0.05 * float(
            w.abs().max())


@pytest.mark.parametrize("case", [CAUSAL, FULL, (2, 9, 13, 6, 2, 8, True)],
                         ids=str)
def test_slack_is_one_step_of_the_largest_term(case):
    """Chunked over query rows it equals the whole computation, and it is
    the largest |term| of each sum times bf16's spacing at it: at least
    2^-8 and below 2^-7 of that term."""
    q, k, v, do, o, lse = _inputs(case, 3)
    whole = flash_attention_bwd_rounding_slack(q, k, v, o, lse, do, case[-1])
    parts = flash_attention_bwd_rounding_slack(q, k, v, o, lse, do, case[-1],
                                               max_elements=1000)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))
    B, Sq, Skv, H, Hkv, hd, causal = case
    G = H // Hkv
    p = torch.exp(_scores(q, k, causal)
                  - lse.reshape(B, Hkv, G, Sq)[..., None])
    if causal:
        p = p.masked_fill(_masked(Sq, Skv, q.device), 0.0)
    dog = do.reshape(B, Sq, Hkv, G, hd)
    big = torch.einsum("bhgqk,bqhgd->bhgqkd", p, dog).abs()
    big = big.amax(3).amax(2).permute(0, 2, 1, 3)      # max |P_ij dO_ic|
    sdv = whole[2]
    assert bool((sdv >= big * 2.0 ** -8 * (1 - 1e-6)).all())
    assert bool((sdv <= big * 2.0 ** -7 * (1 + 1e-6)).all())


@pytest.mark.parametrize("case", [CAUSAL, FULL, (1, 65, 65, 4, 2, 32, True)],
                         ids=str)
def test_bwd_case_check_holds_bf16_to_the_rounded_oracle(case):
    """``bwd_case_check`` on the CPU, where the "kernel" is the wrapper's
    CPU path (the rounded plain version): honest limit uses small, the
    slack in use, and every planted fault above its limit."""
    rec = CS.bwd_case_check("cpu", "bfloat16", case,
                            np.random.default_rng(4))
    assert rec["round_to"] == str(torch.bfloat16)
    assert rec["limit_use"] <= 0.5 and rec["fp32_limit_use"] <= 0.5
    assert min(rec["max_slack"].values()) > 0
    faults = rec["fault_limit_use"]
    assert {"no_delta", "base2_lse", "base2_lse_bwd",
            "dropped_kv_tile"} == set(faults)
    assert min(faults.values()) > 1.0
    rec32 = CS.bwd_case_check("cpu", "float32", case,
                              np.random.default_rng(4))
    assert rec32["round_to"] == "None" and rec32["fault_limit_use"] == {}
    assert max(rec32["max_slack"].values()) == 0.0


def test_backward_route_by_dtype():
    assert ops.bwd_route(torch.bfloat16) == "wgmma"
    assert ops.bwd_route(torch.float32) == "cuda_cores"
    assert {ops.KERNELS[ops.bwd_route(t)] for t in ops.BWD_ROUTES} == {0, 1}
    with pytest.raises(TypeError, match="flash_attention_bwd"):
        ops.bwd_route(torch.float16)
    assert ops.BWD_ROUNDING == {torch.float32: None,
                                torch.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_the_plain_version_with_the_kernels_rounding(dtype):
    q, k, v, do, o, lse = (t.to(dtype) if i != 5 else t for i, t in
                           enumerate(_inputs(CAUSAL, 5)))
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                     round_to=ops.BWD_ROUNDING[dtype])
    assert all(a.dtype == dtype and torch.equal(a, b)
               for a, b in zip(got, want))


def test_check_tma_names_o_and_do():
    ok = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    bad = torch.zeros(1, 4, 2, 17, dtype=torch.bfloat16)[..., 1:]
    ops.check_tma(ok, ok, ok, ok, ok)
    for i, name in enumerate(("q", "k", "v", "o", "do")):
        args = [ok] * 5
        args[i] = bad
        with pytest.raises(ValueError, match=f"^{name} "):
            ops.check_tma(*args)

"""The flash-attention gradient of the port on the CPU.

``flash_attention_bwd_plain`` (the backward kernel's plain version, the
oracle ``chip_smoke.py`` holds the kernel to) against torch's own
gradient of ``flash_attention_plain`` and against ``jax.grad`` of the
reference's ``layers.attention``, causal and full, GQA and Sq != Skv; a
wrong lse must fail the same limit, so the oracle cannot pass vacuously.
Also the wrapper's CPU routes (``flash_attention``, ``flash_attention_fwd``,
``flash_attention_bwd``), ``kernels.refuse_grad``, and the training
forward's helpers (``layers.unstack``, ``layers.checkpointed``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.launch.specs import make_batch
from repro_torch.models import layers as L
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import build

TOL = 1e-5
# B, Sq, Skv, H, Hkv, hd, causal
CASES = [(2, 9, 9, 4, 4, 16, True), (2, 9, 9, 4, 4, 16, False),
         (1, 17, 17, 6, 2, 8, True), (2, 5, 13, 4, 2, 24, False),
         (1, 13, 5, 2, 1, 8, True), (1, 33, 33, 8, 1, 32, True)]


def _inputs(B, Sq, Skv, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return g(B, Sq, H, hd), g(B, Skv, Hkv, hd), g(B, Skv, Hkv, hd), \
        g(B, Sq, H, hd)


def _autograd(q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = flash_attention_plain(qt, kt, vt, causal)
    return o.detach(), torch.autograd.grad(o, (qt, kt, vt),
                                           torch.from_numpy(do))


def _limit(got, want) -> float:
    """max |got - want| / (TOL + TOL |want|) over the three gradients."""
    return max(float(((a - w).abs() / (TOL + TOL * w.abs())).max())
               for a, w in zip(got, want))


@pytest.mark.parametrize("fault", [None, "lse_shift", "no_delta"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_plain_equals_autograd(case, fault):
    B, Sq, Skv, H, Hkv, hd, causal = case
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, hd)
    o, want = _autograd(q, k, v, do, causal)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lse = flash_attention_lse_plain(*t, causal)
    dot = torch.from_numpy(do)
    if fault == "lse_shift":   # a natural log stored as base 2 would do this
        lse = lse * math.log2(math.e)
    if fault == "no_delta":    # D = rowsum(dO o O) left out
        o = torch.zeros_like(o)
    got = flash_attention_bwd_plain(*t, o, lse, dot, causal)
    use = _limit(got, want)
    if fault is None:
        assert use <= 1.0, use
    else:
        assert use > 10.0, f"planted fault {fault} passed ({use})"


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]], ids=str)
def test_bwd_plain_equals_the_reference_gradient(case):
    B, Sq, Skv, H, Hkv, hd, causal = case
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, hd, seed=1)

    def f(q, k, v):
        return jnp.sum(JL.attention(q, k, v, causal=causal) * do)

    want = [torch.from_numpy(np.array(x))
            for x in jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)]
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o = flash_attention_plain(*t, causal)
    got = flash_attention_bwd_plain(*t, o, flash_attention_lse_plain(
        *t, causal), torch.from_numpy(do), causal)
    assert _limit(got, want) <= 1.0


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_wrapper_cpu_routes(case):
    B, Sq, Skv, H, Hkv, hd, causal = case
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, hd, seed=2)
    o_want, g_want = _autograd(q, k, v, do, causal)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal)
    g = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    assert torch.equal(o.detach(), o_want)
    assert all(torch.equal(a, b) for a, b in zip(g, g_want))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o2, lse = ops.flash_attention_fwd(*t, causal)
    assert torch.equal(o2, o_want)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    got = ops.flash_attention_bwd(*t, o2, lse, torch.from_numpy(do), causal)
    assert _limit(got, g_want) <= 1.0
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(*t, o2, lse[:, :, 1:], torch.from_numpy(do),
                                causal)


def test_lse_is_the_row_log_sum_exp():
    q, k, v, _ = _inputs(1, 7, 7, 2, 1, 8, seed=3)
    t = [torch.from_numpy(x).double() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", t[0], t[1].expand(1, 7, 2, 8)) \
        / math.sqrt(8)
    s = s.masked_fill(torch.ones(7, 7, dtype=torch.bool).triu(1), -1e30)
    want = torch.logsumexp(s, -1).float()
    got = flash_attention_lse_plain(*(x.float() for x in t), True)
    assert float((got - want).abs().max()) < 1e-5


def test_refuse_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward: the reason"):
        refuse_grad("k", (x,), "the reason")
    with torch.no_grad():
        refuse_grad("k", (x,), "the reason")
    refuse_grad("k", (x.detach(),), "the reason")


def test_unstack_equals_layer_and_carries_the_gradient():
    blocks = {"a": torch.randn(3, 4, 5, requires_grad=True),
              "n": {"b": torch.randn(3, 2, requires_grad=True)}}
    layers = L.unstack(blocks, 3)
    for i, p in enumerate(layers):
        want = L.layer(blocks, i)
        assert torch.equal(p["a"], want["a"])
        assert torch.equal(p["n"]["b"], want["n"]["b"])
    loss = sum((p["a"] * (i + 1)).sum() + p["n"]["b"].sum() * i
               for i, p in enumerate(layers))
    ga, gb = torch.autograd.grad(loss, (blocks["a"], blocks["n"]["b"]))
    assert torch.equal(ga, torch.tensor([1., 2., 3.])[:, None, None]
                       .expand(3, 4, 5))
    assert torch.equal(gb, torch.tensor([0., 1., 2.])[:, None].expand(3, 2))


@pytest.mark.parametrize("arch", ["olmo-1b", "olmoe-1b-7b", "whisper-tiny",
                                  "zamba2-2.7b"])
def test_remat_changes_no_value(arch):
    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, ShapeCell("t", 16, 2, "train"), seed=1,
                       device="cpu")
    from repro_torch.models import encdec, hybrid, transformer

    fwd = {"dense": transformer.forward_train, "moe": transformer.forward_train,
           "encdec": encdec.forward_train,
           "hybrid": lambda c, p, b, remat: hybrid.forward_full(
               c, p, b["tokens"], remat=remat)}[cfg.family]
    outs = []
    for remat in (True, False):
        leaves = []

        def live(t):
            t = t.detach().requires_grad_()
            leaves.append(t)
            return t

        logits, _ = fwd(cfg, L.tree_map(live, params), batch, remat=remat)
        loss = (logits.float() ** 2).mean()
        outs.append((loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True)))
    (l1, g1), (l2, g2) = outs
    assert torch.equal(l1, l2)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g1, g2))

"""The port's MoE layer against ``repro.models.moe``, on the CPU.

The reference's params (``moe_params(cfg, PRNGKey(0))``) are carried
into the port leaf for leaf, the router kept fp32; the same numpy
inputs go through ``repro.models.moe.moe_apply`` and the port's.  The
expert indices, the capacity slots and which assignments are dropped
must be equal exactly; outputs within rel 1e-5 (fp32) or 2e-2 (bf16)
of max |y|, and the aux loss within 1e-6.  The router's top-k can flip
where the K-th and (K+1)-th probabilities differ by less than the two
packages' fp32 summation orders do: each test prints the smallest such
margin, so a flip can be told from a bug.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import moe as JM
from repro.models.model import build as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import moe as PM
from repro_torch.models.model import build, params_from_numpy

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _cfgs(arch: str, **kw):
    """(reference cfg, port cfg): the reduced ``arch`` with ``kw``."""
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _reference_routing(jcfg, router: np.ndarray, xf: np.ndarray, C: int):
    """The reference's routing, step for step as ``moe_apply`` has it:
    (probs, expert indices (T, K), slots (T * K,), kept (T * K,))."""
    logits = jnp.einsum("td,de->te", jnp.asarray(xf, jnp.float32),
                        jnp.asarray(router))
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, jcfg.experts_per_tok)
    flat_e = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, jcfg.n_experts, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(ranks, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(probs), np.asarray(eidx), np.asarray(pos),
            np.asarray(pos < C))


def _topk_margin(probs: np.ndarray, K: int) -> float:
    """Smallest gap between a token's K-th and (K+1)-th probability."""
    top = -np.sort(-probs, axis=-1)
    return float((top[:, K - 1] - top[:, K]).min())


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 64.0])
@pytest.mark.parametrize("E,K", [(8, 2), (16, 2), (64, 8), (384, 8)])
def test_capacity_equals_reference(E, K, cf):
    jcfg, cfg = _cfgs("olmoe-1b-7b", n_experts=E, experts_per_tok=K,
                      capacity_factor=cf)
    for T in (1, 2, 3, 4, 5, 7, 8, 16, 17, 100, 1_000, 1_984, 16_384):
        for decode in (False, True):
            assert PM._capacity(cfg, T, decode) == \
                JM._capacity(jcfg, T, decode), (T, decode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["prefill", "decode", "gelu"])
def test_moe_apply_equals_reference(arch, dtype, case):
    """Prefill with the capacity binding (factor 0.5: some assignments
    dropped), decode (factor 4: dropless at 8 rows), and the GELU
    expert FFN at prefill."""
    kw = dict(dtype=dtype, param_dtype=dtype, capacity_factor=0.5)
    if case == "gelu":
        kw["act"] = "gelu"
    jcfg, cfg = _cfgs(arch, **kw)
    decode = case == "decode"
    jp = JM.moe_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    p = L.tree_from_numpy(tree, L.pdtype_of(cfg), torch.device("cpu"),
                          ("router",))
    shape = (8, 1) if decode else (2, 24)
    x = np.random.default_rng(1).normal(
        0, 1, shape + (cfg.d_model,)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    want, jaux = JM.moe_apply(jcfg, jp, jx, decode=decode)
    tx = torch.from_numpy(x).to(L.dtype_of(cfg))
    got, aux = PM.moe_apply(cfg, p, tx, decode=decode)

    xf = np.asarray(jx.astype(jnp.float32)).reshape(-1, cfg.d_model)
    T = xf.shape[0]
    C = JM._capacity(jcfg, T, decode)
    probs, eidx, pos, keep = _reference_routing(jcfg, tree["router"], xf, C)
    r = PM.route(cfg, p, tx.reshape(T, -1), decode)
    print(f"{arch} {dtype} {case}: smallest top-k margin "
          f"{_topk_margin(probs, cfg.experts_per_tok):.3e}")
    assert r.C == C
    np.testing.assert_array_equal(r.eidx.numpy(), eidx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if decode:
        assert keep.all()
    else:
        assert not keep.all(), "the capacity did not bind"

    want = np.asarray(want.astype(jnp.float32))
    tol = TOL[dtype] * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=tol)
    assert got.dtype == L.dtype_of(cfg) and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_dropped_assignments_add_and_gather_nothing():
    """A token whose every assignment is dropped gets the shared expert
    alone; without one, exactly zero."""
    for arch in ARCHS:
        _, cfg = _cfgs(arch, capacity_factor=0.01)
        p = PM.moe_params(cfg, torch.Generator().manual_seed(0))
        x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1))
        y, _ = PM.moe_apply(cfg, p, x)
        xf = x.reshape(64, -1)
        r = PM.route(cfg, p, xf)
        gone = ~r.keep.reshape(64, -1).any(dim=1)
        assert gone.any()
        rest = torch.zeros_like(xf) if not cfg.n_shared_experts else \
            L.mlp_apply(cfg, p["shared"], xf)
        assert torch.equal(y[0][gone], rest[gone])


def test_router_stays_fp32_at_bf16():
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
        api = build(cfg)
        jparams = jax.tree_util.tree_map(
            np.asarray, j_build(jcfg).init(jax.random.PRNGKey(0)))
        params = params_from_numpy(cfg, jparams, device="cpu")
        moe = params["blocks"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert np.array_equal(moe["router"].numpy(),
                              jparams["blocks"]["moe"]["router"])
        assert moe["w_gate"].dtype == torch.bfloat16
        ours = api.init(torch.Generator().manual_seed(0), device="cpu")
        assert ours["blocks"]["moe"]["router"].dtype == torch.float32
        assert ours["blocks"]["moe"]["w_up"].dtype == torch.bfloat16

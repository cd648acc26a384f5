"""The port's dense transformer against the reference, on the CPU.

For each of the four dense configs, reduced: the reference's params
(``init_params(cfg, PRNGKey(0))``) are carried into the port with
``params_from_numpy``; ``forward_prefill`` logits and KV and
``forward_decode_paged`` logits and updated pools must equal the
reference's to 1e-5 (fp32; the port's attention runs the kernels'
plain versions, whose fp32 softmax matches the reference's einsum to
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as PT
from repro_torch.models.model import build

ARCHS = ["granite-3-8b", "olmo-1b", "phi3-medium-14b", "chatglm3-6b"]
TOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = j_reduced(j_get_config(request.param))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, PT.params_from_numpy(cfg, tree, device=CPU)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_configs_equal_reference():
    for arch in ARCHS:
        assert vars(get_config(arch)) == vars(j_get_config(arch))
        assert vars(reduced(get_config(arch))) == \
            vars(j_reduced(j_get_config(arch)))
        assert get_config(arch).n_params() == j_get_config(arch).n_params()


def test_prefill_equals_reference(pair):
    jcfg, jparams, cfg, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 21))
    jlogits, jcache = JT.forward_prefill(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        full_logits=True)
    logits, cache = PT.forward_prefill(cfg, params, torch.from_numpy(tokens),
                                       full_logits=True)
    _close(logits, jlogits)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    assert cache.length == 21
    last, _ = PT.forward_prefill(cfg, params, torch.from_numpy(tokens))
    _close(last, jlogits[:, -1:])


def test_decode_paged_equals_reference(pair):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(2)
    N, bs, nb = 24, 4, 6
    lengths = np.array([3, 13, 23], np.int32)      # ragged; +1 fits nb * bs
    B = len(lengths)
    shape = (cfg.n_layers, N, bs, cfg.n_kv_heads, cfg.hd)
    kpool = rng.normal(0, 1, shape).astype(np.float32)
    vpool = rng.normal(0, 1, shape).astype(np.float32)
    bt = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    slot_ids = bt[np.arange(B), lengths // bs].astype(np.int32)
    slot_offs = (lengths % bs).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, (B, 1))
    jl, jk, jv = JT.forward_decode_paged(
        jcfg, jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(kpool),
        jnp.asarray(vpool), jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(slot_ids), jnp.asarray(slot_offs))
    kp, vp = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    api = build(cfg)
    logits, k_out, v_out = api.decode_paged(
        params, torch.from_numpy(tokens), kp, vp, torch.from_numpy(bt),
        torch.from_numpy(lengths), torch.from_numpy(slot_ids),
        torch.from_numpy(slot_offs))
    assert k_out is kp and v_out is vp               # updated in place
    _close(logits, jl)
    _close(kp, jk)
    _close(vp, jv)


def test_params_round_trip_exactly(pair):
    jcfg, jparams, cfg, params = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = PT.params_to_numpy(PT.params_from_numpy(cfg, tree, device=CPU))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_port_init_has_the_reference_tree_and_shapes(pair):
    jcfg, jparams, cfg, _ = pair
    ours = PT.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    theirs = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == theirs
    again = PT.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again)))


def test_other_families_raise():
    import dataclasses
    cfg = dataclasses.replace(reduced(get_config("granite-3-8b")),
                              family="ssm")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build(cfg)
    with pytest.raises(NotImplementedError):
        PT.forward_prefill(cfg, {}, torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, None),
                                           (False, "scalar"),
                                           (False, "per-seq"),
                                           (True, "per-seq")])
def test_layers_equal_reference(causal, kv_len):
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, Hkv, hd = 2, 7, 7, 4, 2, 16
    q = rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    lens = {None: None, "scalar": np.int32(5),
            "per-seq": np.array([3, 7], np.int32)}[kv_len]
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal,
                        kv_len=None if lens is None else jnp.asarray(lens))
    got = PL.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal,
                       kv_len=None if lens is None else torch.as_tensor(lens))
    _close(got, want)
    pos = rng.integers(0, 50, (B, Sq)).astype(np.int32)
    for frac in (1.0, 0.5):
        _close(PL.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                             10_000.0, frac),
               JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0,
                             frac))
    w = rng.normal(0, 1, (hd,)).astype(np.float32)
    b = rng.normal(0, 1, (hd,)).astype(np.float32)
    _close(PL.rmsnorm(torch.from_numpy(q), torch.from_numpy(w)),
           JL.rmsnorm(jnp.asarray(q), jnp.asarray(w)))
    _close(PL.layernorm(torch.from_numpy(q), torch.from_numpy(w),
                        torch.from_numpy(b)),
           JL.layernorm(jnp.asarray(q), jnp.asarray(w), jnp.asarray(b)))

"""The port's encoder-decoder (whisper-tiny) against the reference, on the
CPU, reduced and in fp32.

The reference's params (``encdec.init_params(cfg, PRNGKey(0))``) cross
into the port with ``params_from_numpy``; audio embeddings (the stub
frontend's output) and tokens are made with numpy from a seed.  The
port's attention runs the kernels' plain versions here (CPU tensors):
flash for the encoder, the decoder's prefill and the cross-attention,
``layers.decode_attention`` in decode.  Tolerance 1e-5 absolute and
relative, as ``tests/test_torch_models.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model as JMODEL
from repro_torch.configs import get_config, reduced
from repro_torch.models import encdec as PE
from repro_torch.models import layers as PL
from repro_torch.models.model import (build, params_from_numpy,
                                      params_to_numpy)

ARCH = "whisper-tiny"
TOL = 1e-5
CPU = "cpu"
S_ENC, S_DEC = 24, 5


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port params, inputs)."""
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JE.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    audio = rng.normal(0, 1, (2, S_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, S_DEC))
    return (jcfg, jparams, cfg, params_from_numpy(cfg, tree, device=CPU),
            audio, tokens)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_configs_equal_reference():
    assert vars(get_config(ARCH)) == vars(j_get_config(ARCH))
    assert vars(reduced(get_config(ARCH))) == \
        vars(j_reduced(j_get_config(ARCH)))
    assert get_config(ARCH).n_params() == j_get_config(ARCH).n_params()
    cfg = reduced(get_config(ARCH))
    assert (cfg.n_layers, cfg.n_enc_layers) == (2, 2)
    for L in (1, 16, 64, 448, 2000):
        assert PE.enc_len_for(cfg, L) == JE.enc_len_for(cfg, L)


def test_params_round_trip_exactly(pair):
    jcfg, jparams, cfg, params, _, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(cfg, tree, device=CPU))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_port_init_has_the_reference_tree_and_shapes(pair):
    jcfg, jparams, cfg, _, _, _ = pair
    ours = build(cfg).init(torch.Generator().manual_seed(0), device=CPU)
    theirs = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == theirs
    with pytest.raises(ValueError, match="generator on"):
        PE.init_params(cfg, torch.Generator(), device="meta")


def test_sinusoid_equals_reference():
    for S, D in ((1, 8), (37, 64), (1500, 384)):
        assert np.array_equal(PE.sinusoid(S, D), JE.sinusoid(S, D))


def test_encode_equals_reference(pair):
    jcfg, jparams, cfg, params, audio, _ = pair
    want = JE.encode(jcfg, jparams, jnp.asarray(audio))
    got = PE.encode(cfg, params, torch.from_numpy(audio))
    assert got.shape == (2, S_ENC, cfg.d_model)
    _close(got, want)


def test_mlp_apply_gelu_equals_reference(pair):
    jcfg, jparams, cfg, params, _, _ = pair
    assert cfg.act == "gelu"
    x = np.random.default_rng(2).normal(0, 2, (2, 7, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["dec"]["mlp"])
    p = {k: v[0] for k, v in params["dec"]["mlp"].items()}
    _close(PL.mlp_apply(cfg, p, torch.from_numpy(x)),
           JL.mlp_apply(jcfg, jp, jnp.asarray(x)))


@pytest.mark.parametrize("max_len", [None, S_DEC + 6])
def test_prefill_equals_reference(pair, max_len):
    jcfg, jparams, cfg, params, audio, tokens = pair
    jl, jc = JE.forward_prefill(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                        "audio_embeds": jnp.asarray(audio)}, max_len)
    logits, cache = build(cfg).prefill(params, torch.from_numpy(tokens),
                                       audio_embeds=torch.from_numpy(audio),
                                       max_len=max_len)
    assert logits.shape == (2, 1, cfg.vocab)
    _close(logits, jl)
    assert cache.length == int(jc.length) == S_DEC
    for f in ("k", "v", "xk", "xv"):
        assert getattr(cache, f).shape == getattr(jc, f).shape
        _close(getattr(cache, f), getattr(jc, f))


def test_decode_steps_equal_reference(pair):
    jcfg, jparams, cfg, params, audio, tokens = pair
    max_len = S_DEC + 4
    japi, api = JMODEL.build(jcfg), build(cfg)
    _, jc = japi.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                   "audio_embeds": jnp.asarray(audio)},
                         max_len)
    _, cache = api.prefill(params, torch.from_numpy(tokens),
                           audio_embeds=torch.from_numpy(audio),
                           max_len=max_len)
    k_before = cache.k
    rng = np.random.default_rng(3)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        jl, jc = japi.decode(jparams, jnp.asarray(tok, jnp.int32), jc)
        logits, cache = api.decode(params, torch.from_numpy(tok), cache)
        _close(logits, jl)
    assert cache.length == int(jc.length) == max_len
    assert cache.k is k_before                      # written in place
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)
    with pytest.raises(ValueError, match="forward_decode"):
        api.decode(params, torch.from_numpy(tok), cache)


def test_init_cache_equals_reference(pair):
    jcfg, jparams, cfg, params, _, _ = pair
    japi, api = JMODEL.build(jcfg), build(cfg)
    jc = japi.init_cache(3, 40)
    cache = api.init_cache(3, 40, device=CPU)
    assert cache.length == int(jc.length) == 0
    for f in ("k", "v", "xk", "xv"):
        assert getattr(cache, f).shape == getattr(jc, f).shape
        assert getattr(cache, f).dtype == torch.float32
        assert not getattr(cache, f).any()
    assert len({id(getattr(cache, f)) for f in ("k", "v", "xk", "xv")}) == 4
    # a fresh cache decodes like the reference's
    tok = np.array([[5], [7], [11]])
    jl, _ = japi.decode(jparams, jnp.asarray(tok, jnp.int32), jc)
    logits, _ = api.decode(params, torch.from_numpy(tok), cache)
    _close(logits, jl)


def test_paged_decode_refused_and_unknown_family(pair):
    cfg = pair[2]
    with pytest.raises(NotImplementedError, match="'encdec'"):
        build(cfg).decode_paged({}, None)
    with pytest.raises(ValueError, match="unknown family"):
        build(dataclasses.replace(cfg, family="speech"))

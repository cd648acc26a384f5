"""The port's contiguous-cache and buffered decode paths against the
reference, on the CPU, at reduced sizes in fp32.

For the seven reduced transformer configs (four dense, the vlm, the moe
at its default capacity and dropless): ``prefill(max_len=)`` and four
``decode`` steps, logits and both caches; ``layers.decode_attention``
(the ``paged_attention`` kernel's plain version on the cache seen as one
page a sequence) against the reference's ``attention(kv_len=)``; the
buffered decode's partials and the decode itself across two commits;
``opt_flags`` and the Mamba1 flags; and the three writes past a cache's
end, which the reference clamps and the port refuses.

Inputs are made with numpy from a seed and handed to both packages; the
reference's params cross with ``params_from_numpy``.  Tolerance 1e-5
absolute and relative (fp32), as ``tests/test_torch_models.py``; the
Mamba1 block 1e-4 of the reference's max |x|, as
``tests/test_torch_ssm.py`` (the port's scan is sequential, the
reference's associative).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import opt_flags as JF
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as PL
from repro_torch.models import mamba as PM
from repro_torch.models import opt_flags as PF
from repro_torch.models import transformer as PT
from repro_torch.models.model import build, params_from_numpy

TOL = 1e-5
CPU = "cpu"
DROPLESS = dict(capacity_factor=64.0)   # every assignment kept
CASES = [("granite-3-8b", {}), ("olmo-1b", {}), ("phi3-medium-14b", {}),
         ("chatglm3-6b", {}), ("llava-next-mistral-7b", {}),
         ("olmoe-1b-7b", {}), ("olmoe-1b-7b", DROPLESS),
         ("kimi-k2-1t-a32b", {}), ("kimi-k2-1t-a32b", DROPLESS)]


def _ids(case):
    arch, kw = case
    return arch + ("-dropless" if kw else "")


@functools.lru_cache(maxsize=None)
def _pair(arch: str, capacity_factor=None):
    """(reference cfg, reference params, port cfg, port params); no test
    changes the params."""
    kw = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(cfg, tree, device=CPU)


# the reference's decode steps, compiled once a config (eager, every step
# would trace its layer scan anew)
_j_decode = jax.jit(JT.forward_decode, static_argnums=0)
_j_decode_buffered = jax.jit(JT.forward_decode_buffered, static_argnums=0)


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def pair(request):
    arch, kw = request.param
    return _pair(arch, **kw)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a) -> jnp.ndarray:
    return jnp.asarray(a, jnp.int32 if a.dtype.kind == "i" else None)


# -- prefill(max_len) + decode ----------------------------------------------------

def _decode_both(jcfg, jparams, cfg, params, jcache, cache, steps, seed):
    """``steps`` decode steps of the same tokens in both packages; every
    step's logits equal.  Returns both caches."""
    api = build(cfg)
    rng = np.random.default_rng(seed)
    B = cache.k.shape[1]
    for _ in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1))
        jl, jcache = _j_decode(jcfg, jparams, _j(tok), jcache)
        logits, cache = api.decode(params, _t(tok), cache)
        assert logits.shape == (B, 1, cfg.vocab)
        _close(logits, jl)
    return jcache, cache


def test_prefill_max_len_and_decode_equal_reference(pair):
    jcfg, jparams, cfg, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    jl, jc = JT.forward_prefill(jcfg, jparams, {"tokens": _j(tokens)},
                                max_len=15)
    logits, cache = build(cfg).prefill(params, _t(tokens), max_len=15)
    _close(logits, jl)
    assert cache.k.shape == (cfg.n_layers, 2, 15, cfg.n_kv_heads, cfg.hd)
    assert cache.length == 9 and cache.k is not cache.v
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)
    k_before = cache.k
    jc, cache = _decode_both(jcfg, jparams, cfg, params, jc, cache, 4, 2)
    assert cache.length == 13 and int(jc.length) == 13
    assert cache.k is k_before                      # written in place
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)


def test_vlm_decode_after_patch_prefill_equals_reference():
    jcfg, jparams, cfg, params = _pair("llava-next-mistral-7b")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (2, 5))
    pe = rng.normal(0, 1, (2, cfg.n_patches, cfg.d_model)).astype(np.float32)
    S = cfg.n_patches + 5
    jl, jc = JT.forward_prefill(
        jcfg, jparams, {"tokens": _j(tokens), "patch_embeds": jnp.asarray(pe)},
        max_len=S + 4)
    logits, cache = build(cfg).prefill(params, _t(tokens), max_len=S + 4,
                                       patch_embeds=_t(pe))
    _close(logits, jl)
    assert cache.length == S and cache.k.shape[2] == S + 4
    jc, cache = _decode_both(jcfg, jparams, cfg, params, jc, cache, 4, 5)
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)


def test_init_cache_then_decode_equals_reference():
    jcfg, jparams, cfg, params = _pair("granite-3-8b")
    jc = JT.init_kv_cache(jcfg, 3, 6)
    cache = build(cfg).init_cache(3, 6, device=CPU)
    assert cache.k.shape == jc.k.shape and cache.length == 0
    assert cache.k.dtype == torch.float32 and cache.k is not cache.v
    jc, cache = _decode_both(jcfg, jparams, cfg, params, jc, cache, 3, 6)
    _close(cache.k, jc.k)
    _close(cache.v, jc.v)


# -- the decode-attention helper ----------------------------------------------------

# B, S_max, H, Hkv, hd, length: one position, the whole cache, a cache
# that is no multiple of 16 positions (the kernel's chunk)
HELPER = [(2, 16, 4, 2, 16, 1), (2, 16, 4, 2, 16, 16), (3, 37, 4, 4, 16, 37),
          (3, 37, 4, 4, 16, 20), (1, 50, 8, 2, 32, 1), (2, 45, 4, 1, 8, 44)]


@pytest.mark.parametrize("B,S_max,H,Hkv,hd,length", HELPER)
def test_decode_attention_equals_reference_attention(B, S_max, H, Hkv, hd,
                                                     length):
    rng = np.random.default_rng(S_max + length)
    q = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    kc = rng.normal(0, 1, (B, S_max, Hkv, hd)).astype(np.float32)
    vc = rng.normal(0, 1, (B, S_max, Hkv, hd)).astype(np.float32)
    want = JL.attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        causal=False, kv_len=length)
    got = PL.decode_attention(_t(q), _t(kc), _t(vc), length)
    assert got.shape == (B, 1, H, hd)
    _close(got, want)
    _close(PL.attention(_t(q), _t(kc), _t(vc), causal=False, kv_len=length),
           want)


def test_decode_attention_refuses_a_length_outside_the_cache():
    q, kc = torch.zeros(1, 1, 2, 8), torch.zeros(1, 5, 2, 8)
    for length in (0, 6):
        with pytest.raises(ValueError, match="positions of a cache of 5"):
            PL.decode_attention(q, kc, kc, length)


# -- the buffered decode -------------------------------------------------------------

@pytest.mark.parametrize("kv_len", [None, "scalar", "per-seq", "zero"])
def test_partials_and_merge_equal_reference(kv_len):
    rng = np.random.default_rng(7)
    B, Sq, H, Hkv, hd, S1, S2 = 2, 1, 4, 2, 16, 11, 5
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    q, k1, v1, k2, v2 = r(B, Sq, H, hd), r(B, S1, Hkv, hd), r(B, S1, Hkv, hd), \
        r(B, S2, Hkv, hd), r(B, S2, Hkv, hd)
    lens = {None: None, "scalar": 7, "per-seq": np.array([3, 11], np.int32),
            "zero": 0}[kv_len]
    jlen = None if lens is None else jnp.asarray(lens)
    plen = None if lens is None else torch.as_tensor(lens)
    k1hs, v1hs = k1.transpose(0, 2, 1, 3), v1.transpose(0, 2, 1, 3)
    want_hs = JL.attention_partial_hs(jnp.asarray(q), jnp.asarray(k1hs),
                                      jnp.asarray(v1hs), kv_len=jlen)
    got_hs = PL.attention_partial_hs(_t(q), _t(k1hs), _t(v1hs), kv_len=plen)
    want_p = JL.attention_partial(jnp.asarray(q), jnp.asarray(k2),
                                  jnp.asarray(v2), kv_len=3)
    got_p = PL.attention_partial(_t(q), _t(k2), _t(v2), kv_len=3)
    for got, want in zip(got_hs + got_p, want_hs + want_p):
        assert got.dtype == torch.float32
        _close(got, want)
    _close(PL.merge_partials([got_hs, got_p]),
           JL.merge_partials([want_hs, want_p]))
    # base (unmasked) + ring as one attention over both
    whole = PL.merge_partials([
        PL.attention_partial_hs(_t(q), _t(k1hs), _t(v1hs)),
        PL.attention_partial(_t(q), _t(k2), _t(v2))])
    _close(whole, PL.attention(_t(q), _t(np.concatenate([k1, k2], 1)),
                               _t(np.concatenate([v1, v2], 1)),
                               causal=False))


@pytest.mark.parametrize("arch", ["granite-3-8b", "olmoe-1b-7b"])
def test_buffered_decode_across_two_commits_equals_reference(arch):
    """A prefill's cache as base + a ring of R = 4, 9 steps across two
    commits: logits, base and ring equal the reference's, and the logits
    the contiguous decode's."""
    jcfg, jparams, cfg, params = _pair(arch)
    R, S0, steps = 4, 6, 9
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, cfg.vocab, (2, S0))
    toks = rng.integers(0, cfg.vocab, (steps, 2, 1))
    _, jc = JT.forward_prefill(jcfg, jparams, {"tokens": _j(prompt)},
                               max_len=S0 + steps)
    _, pc = PT.forward_prefill(cfg, params, _t(prompt), max_len=S0 + steps)
    jb = JT.BufferedKVCache(jnp.swapaxes(jc.k, 2, 3), jnp.swapaxes(jc.v, 2, 3),
                            *JT.init_buffered_cache(jcfg, 2, 1, R)[2:4],
                            jnp.int32(S0), jnp.int32(0))
    pb = PT.to_buffered(pc, R)
    assert pb.k.shape == jb.k.shape and pb.bk.shape == jb.bk.shape
    commits = 0
    for s in range(steps):
        if pb.buf_len == R:
            jb, pb = JT.commit_buffer(jcfg, jb), PT.commit_buffer(cfg, pb)
            commits += 1
        jl, jb = _j_decode_buffered(jcfg, jparams, _j(toks[s]), jb)
        logits, pb = PT.forward_decode_buffered(cfg, params, _t(toks[s]), pb)
        _close(logits, jl)
        cl, pc = PT.forward_decode(cfg, params, _t(toks[s]), pc)
        _close(logits, cl.numpy())
    assert commits == 2 and pb.base_len == S0 + 2 * R and pb.buf_len == 1
    assert (int(jb.base_len), int(jb.buf_len)) == (pb.base_len, pb.buf_len)
    for f in ("k", "v", "bk", "bv"):
        _close(getattr(pb, f), getattr(jb, f))


def test_init_buffered_cache_equals_reference():
    jcfg, _, cfg, _ = _pair("olmo-1b")
    jb = JT.init_buffered_cache(jcfg, 3, 20, buf_len=5)
    pb = PT.init_buffered_cache(cfg, 3, 20, buf_len=5, device=CPU)
    for f in ("k", "v", "bk", "bv"):
        assert getattr(pb, f).shape == getattr(jb, f).shape
        assert not getattr(pb, f).any()
    assert (pb.base_len, pb.buf_len) == (0, 0)
    assert len({id(getattr(pb, f)) for f in ("k", "v", "bk", "bv")}) == 4


# -- the writes past a cache's end: the reference clamps, the port raises -------------

@pytest.mark.parametrize("where", ["decode", "ring", "commit"])
def test_writes_past_the_cache_raise(where):
    _, _, cfg, params = _pair("granite-3-8b")
    tok = torch.zeros((1, 1), dtype=torch.long)
    if where == "decode":
        cache = PT.init_kv_cache(cfg, 1, 3, device=CPU)._replace(length=3)
        with pytest.raises(ValueError, match="forward_decode"):
            PT.forward_decode(cfg, params, tok, cache)
    elif where == "ring":
        b = PT.init_buffered_cache(cfg, 1, 8, buf_len=2, device=CPU)
        b = b._replace(buf_len=2)
        with pytest.raises(ValueError, match="ring write"):
            PT.forward_decode_buffered(cfg, params, tok, b)
    else:
        b = PT.init_buffered_cache(cfg, 1, 8, buf_len=3, device=CPU)
        b = b._replace(base_len=6)
        with pytest.raises(ValueError, match="commit_buffer"):
            PT.commit_buffer(cfg, b)
        assert PT.commit_buffer(cfg, b._replace(base_len=5)).base_len == 8


# -- opt flags ------------------------------------------------------------------------------

def test_opt_flags_equal_reference_and_nest():
    assert dataclasses.asdict(PF.OptFlags()) == dataclasses.asdict(
        JF.OptFlags())
    assert dataclasses.asdict(PF.FLAGS) == dataclasses.asdict(PF.OptFlags())
    with PF.use_flags(mamba_seq_scan=True) as outer:
        assert PF.FLAGS is outer and outer.mamba_seq_scan
        with PF.use_flags(mamba_chunk_override=8, decode_buffer_len=4):
            assert PF.FLAGS.mamba_seq_scan
            assert PF.FLAGS.mamba_chunk_override == 8
            assert PF.FLAGS.decode_buffer_len == 4
        assert PF.FLAGS is outer and PF.FLAGS.mamba_chunk_override == 0
        with pytest.raises(RuntimeError):
            with PF.use_flags(moe_local_dispatch=True):
                raise RuntimeError
        assert PF.FLAGS is outer
    assert PF.FLAGS == PF.OptFlags()
    with pytest.raises(TypeError):
        with PF.use_flags(no_such_flag=True):
            pass


@pytest.fixture(scope="module")
def mamba1():
    jcfg = j_reduced(j_get_config("falcon-mamba-7b"))
    cfg = reduced(get_config("falcon-mamba-7b"))
    jp = JM.mamba1_params(jcfg, jax.random.PRNGKey(3))
    p = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp), CPU)
    x = np.random.default_rng(9).normal(0, 1, (2, 45, cfg.d_model)).astype(
        np.float32)
    return jcfg, cfg, jp, p, x


def _rel(got: torch.Tensor, want, tol: float = 1e-4) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("flags", [{}, {"mamba_seq_scan": True},
                                   {"mamba_chunk_override": 16},
                                   {"mamba_chunk_override": 7,
                                    "mamba_seq_scan": True}],
                         ids=["none", "seq", "chunk16", "chunk7-seq"])
def test_mamba1_flags_equal_reference(mamba1, flags):
    jcfg, cfg, jp, p, x = mamba1
    with JF.use_flags(**flags):
        jout, (jconv, jssm) = JM.mamba1_full(jcfg, jp, jnp.asarray(x),
                                             return_state=True)
    with PF.use_flags(**flags):
        out, (conv, ssm) = PM.mamba1_full(cfg, p, _t(x), return_state=True)
    _rel(out, jout)
    _rel(conv, jconv)
    _rel(ssm, jssm)
    # the flags only reorder the reference's recurrence: the port's path is
    # the same with or without them
    assert torch.equal(PM.mamba1_full(cfg, p, _t(x)), out)



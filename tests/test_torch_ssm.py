"""The port's SSM (falcon-mamba) and hybrid (zamba2) paths against the
reference, on the CPU, at reduced sizes in fp32.

Inputs are made with numpy from a seed and handed to both packages; the
reference's params cross with ``params_from_numpy``.  The port's
selective scan runs the ``mamba_scan`` kernel's plain version here (CPU
tensors).  The reference's Pallas scan is not called: under the
installed jax it fails on ``pl.store`` (tests/test_kernels.py), so the
plain version is held to its oracle ``mamba_scan_ref`` instead.

Tolerances: the plain scan 1e-4 absolute (the bound of
tests/test_kernels.py::test_mamba_scan); blocks and states 1e-4 of the
reference's largest magnitude; logits 2e-4 of it (the bound of
tests/test_models.py::test_prefill_decode_consistency).  The port's scan
is sequential where the reference's is an associative scan over chunks,
so the two differ by rounding only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro.models import hybrid as JH
from repro.models import mamba as JM
from repro.models import model as JMODEL
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_plain
from repro_torch.models import hybrid as PH
from repro_torch.models import mamba as PM
from repro_torch.models import model as PMODEL

ARCHS = ["falcon-mamba-7b", "zamba2-2.7b"]
CPU = "cpu"
BLOCK_TOL, LOGIT_TOL = 1e-4, 2e-4


def _rel(got: torch.Tensor, want, tol: float) -> None:
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) + 1e-9
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the scan ----------------------------------------------------------------

def _scan_inputs(B, S, din, N, seed):
    """As tests/test_kernels.py makes them: dt = |randn| 0.1, A_log =
    randn 0.5."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return (r(B, S, din), np.abs(r(B, S, din)) * 0.1, r(B, S, N),
            r(B, S, N), r(din, N) * 0.5)


def _final_state(u, dt, Bc, Cc, A_log):
    """The reference recurrence's last state, in float64 numpy."""
    A = -np.exp(A_log.astype(np.float64))
    h = np.zeros((u.shape[0],) + A.shape)
    for t in range(u.shape[1]):
        h = np.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
    return h


@pytest.mark.parametrize("B,S,din,N", [(2, 64, 128, 16), (1, 100, 96, 8),
                                       (2, 32, 64, 4)])
def test_plain_scan_equals_reference(B, S, din, N):
    ins = _scan_inputs(B, S, din, N, seed=S)
    want = mamba_scan_ref(*(jnp.asarray(a) for a in ins))
    y, h = mamba_scan_plain(*(_t(a) for a in ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), _final_state(*ins), atol=1e-4)
    before = scan_ops.launch_count
    y2, h2 = scan_ops.mamba_scan(*(_t(a) for a in ins))   # CPU: plain only
    assert scan_ops.launch_count == before
    assert torch.equal(y2, y) and torch.equal(h2, h)


def test_plain_scan_keeps_u_dtype():
    u, dt, Bc, Cc, Al = (_t(a) for a in _scan_inputs(1, 9, 16, 4, seed=0))
    y, h = scan_ops.mamba_scan(u.bfloat16(), dt, Bc.bfloat16(),
                               Cc.bfloat16(), Al)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want, _ = mamba_scan_plain(u.bfloat16(), dt, Bc.bfloat16(),
                               Cc.bfloat16(), Al)
    assert torch.equal(y, want)


def _bad(case):
    u, dt, Bc, Cc, Al = (_t(a) for a in _scan_inputs(2, 8, 16, 4, seed=1))
    if case == "rank":
        u = u[0]
    elif case == "din":
        Al = Al[:8]
    elif case == "state":
        Bc = Bc[..., :3]
    elif case == "big_state":
        Bc, Cc, Al = (torch.zeros(t.shape[:-1] + (65,)) for t in (Bc, Cc, Al))
    elif case == "dtype":
        u = u.double()
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "a_dtype":
        Al = Al.bfloat16()
    elif case == "bc_dtype":
        Bc = Bc.bfloat16()
    elif case == "stride":
        u = u.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "device":
        Al = Al.to("meta")
    return u, dt, Bc, Cc, Al


@pytest.mark.parametrize("case", ["rank", "din", "state", "big_state",
                                  "dtype", "dt_dtype", "a_dtype",
                                  "bc_dtype", "stride", "device"])
def test_scan_wrapper_rejects(case):
    with pytest.raises((ValueError, TypeError)):
        scan_ops.mamba_scan(*_bad(case))


def test_scan_wrapper_takes_strided_b_and_c():
    """The model hands B and C as views into the x_proj output."""
    u, dt, Bc, Cc, Al = (_t(a) for a in _scan_inputs(2, 11, 16, 4, seed=2))
    dbc = torch.cat([torch.zeros(2, 11, 5), Bc, Cc], dim=-1)
    y, h = scan_ops.mamba_scan(u, dt, dbc[..., 5:9], dbc[..., 9:], Al)
    y0, h0 = mamba_scan_plain(u, dt, Bc, Cc, Al)
    assert torch.equal(y, y0) and torch.equal(h, h0)


# -- the blocks ----------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    """(reference cfg, port cfg, reference params, port params) of one
    Mamba1 and one Mamba2 block, reduced, fp32."""
    out = {}
    for arch, fn in (("falcon-mamba-7b", JM.mamba1_params),
                     ("zamba2-2.7b", JM.mamba2_params)):
        jcfg = j_reduced(j_get_config(arch))
        cfg = reduced(get_config(arch))
        jp = fn(jcfg, jax.random.PRNGKey(3))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        out[arch] = (jcfg, cfg, jp, PMODEL.params_from_numpy(cfg, tree, CPU))
    return out


def _x(cfg, S, seed, B=2):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


# S: shorter than the conv, odd, one exact chunk (ssm_chunk 32), a ragged tail
@pytest.mark.parametrize("S", [1, 3, 32, 100])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_full_equals_reference(blocks, arch, S):
    jcfg, cfg, jp, p = blocks[arch]
    jfull, pfull = {"falcon-mamba-7b": (JM.mamba1_full, PM.mamba1_full),
                    "zamba2-2.7b": (JM.mamba2_full, PM.mamba2_full)}[arch]
    x = _x(cfg, S, seed=S)
    jout, (jconv, jssm) = jfull(jcfg, jp, jnp.asarray(x), return_state=True)
    out, (conv, ssm) = pfull(cfg, p, _t(x), return_state=True)
    _rel(out, jout, BLOCK_TOL)
    _rel(conv, jconv, BLOCK_TOL)
    _rel(ssm, jssm, BLOCK_TOL)
    assert torch.equal(pfull(cfg, p, _t(x)), out)
    # the states own their memory: a view would keep the layer's whole
    # input projection alive while a prefill collects every layer's state
    for t in (conv, ssm):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_block_decode_equals_reference(blocks, arch):
    jcfg, cfg, jp, p = blocks[arch]
    jdec, pdec = {"falcon-mamba-7b": (JM.mamba1_decode, PM.mamba1_decode),
                  "zamba2-2.7b": (JM.mamba2_decode, PM.mamba2_decode)}[arch]
    rng = np.random.default_rng(4)
    din, N = cfg.d_inner, cfg.ssm_state
    conv = rng.normal(0, 1, (2, cfg.ssm_conv - 1, din)).astype(np.float32)
    if arch == "falcon-mamba-7b":
        ssm = rng.normal(0, 1, (2, din, N)).astype(np.float32)
    else:
        nh = din // cfg.ssm_head_dim
        ssm = rng.normal(0, 1, (2, nh, N, cfg.ssm_head_dim)).astype(
            np.float32)
    x = _x(cfg, 1, seed=5)
    jout, jconv, jssm = jdec(jcfg, jp, jnp.asarray(x), jnp.asarray(conv),
                             jnp.asarray(ssm))
    out, pconv, pssm = pdec(cfg, p, _t(x), _t(conv), _t(ssm))
    _rel(out, jout, BLOCK_TOL)
    _rel(pconv, jconv, BLOCK_TOL)
    _rel(pssm, jssm, BLOCK_TOL)


def test_segsum_equals_reference():
    x = np.random.default_rng(6).normal(0, 1, (3, 2, 7)).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(x)))
    got = PM._segsum(_t(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5)


# -- the models ------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference api, reference params, port cfg, port
    api, port params) of one reduced model."""
    jcfg = j_reduced(j_get_config(request.param))
    japi = JMODEL.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(request.param))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return (jcfg, japi, jparams, cfg, PMODEL.build(cfg),
            PMODEL.params_from_numpy(cfg, tree, device=CPU))


def _full_reference(jcfg, jparams, tokens):
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    if jcfg.family == "ssm":
        return JMODEL._ssm_forward_train(jcfg, jparams, batch, remat=False)[0]
    return JH.forward_full(jcfg, jparams, batch, remat=False)[0]


def _cache_close(cache, jcache):
    for f in cache._fields:
        if f == "length":
            assert cache.length == int(jcache.length)
        else:
            _rel(getattr(cache, f), getattr(jcache, f), BLOCK_TOL)


def test_prefill_equals_reference(pair):
    jcfg, japi, jparams, cfg, api, params = pair
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 37))
    jlogits, jcache = japi.prefill(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, max_len=45)
    logits, cache = api.prefill(params, _t(tokens), max_len=45)
    assert logits.shape == (2, 1, cfg.vocab)
    _rel(logits, jlogits, LOGIT_TOL)
    _cache_close(cache, jcache)
    full, _ = api.prefill(params, _t(tokens), full_logits=True)
    _rel(full, _full_reference(jcfg, jparams, tokens), LOGIT_TOL)


def test_decode_equals_reference(pair):
    jcfg, japi, jparams, cfg, api, params = pair
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20))
    _, jcache = japi.prefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :16], jnp.int32)},
        max_len=24)
    _, cache = api.prefill(params, _t(tokens[:, :16]), max_len=24)
    for i in range(16, 20):
        step = tokens[:, i:i + 1]
        jlogits, jcache = japi.decode(jparams, jnp.asarray(step, jnp.int32),
                                      jcache)
        logits, cache = api.decode(params, _t(step), cache)
        _rel(logits, jlogits, LOGIT_TOL)
        _cache_close(cache, jcache)
    # decode against a teacher-forced prefill of the same 20 tokens
    full, _ = api.prefill(params, _t(tokens), full_logits=True)
    _rel(logits[:, 0], full[:, -1].numpy(), LOGIT_TOL)


def test_init_cache_equals_reference(pair):
    jcfg, japi, jparams, cfg, api, params = pair
    jcache = japi.init_cache(3, 11)
    cache = api.init_cache(3, 11, device=CPU)
    for f in cache._fields:
        if f == "length":
            assert cache.length == int(jcache.length) == 0
            continue
        got, want = getattr(cache, f), np.asarray(getattr(jcache, f))
        assert tuple(got.shape) == want.shape and not got.any()
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    # a fresh cache decodes like the reference's
    step = np.array([[5], [7], [11]])
    jlogits, _ = japi.decode(jparams, jnp.asarray(step, jnp.int32), jcache)
    logits, _ = api.decode(params, _t(step), cache)
    _rel(logits, jlogits, LOGIT_TOL)


def test_paged_decode_refused(pair):
    api = pair[4]
    with pytest.raises(NotImplementedError, match="decode"):
        api.decode_paged({}, None)


# -- params and configs ------------------------------------------------------------

def test_params_round_trip_exactly(pair):
    jcfg, japi, jparams, cfg, api, params = pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = PMODEL.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_port_init_has_the_reference_tree_and_shapes(pair):
    jcfg, japi, jparams, cfg, api, params = pair
    ours = api.init(torch.Generator().manual_seed(0), device=CPU)
    theirs = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == theirs
    again = api.init(torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_leaves_stay_fp32_under_bf16(arch):
    """The reference keeps Mamba1's A_log and Mamba2's A_log and dt_bias
    fp32 whatever the parameter dtype; so do init and the carry-across."""
    import dataclasses
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)),
                               dtype="bfloat16", param_dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16",
                              param_dtype="bfloat16")
    jparams = JMODEL.build(jcfg).init(jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(k): str(v.dtype) for k, v in
            jax.tree_util.tree_leaves_with_path(jparams)}
    assert "float32" in want.values() and "bfloat16" in want.values()
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jparams)
    for params in (PMODEL.params_from_numpy(cfg, tree, CPU),
                   PMODEL.build(cfg).init(torch.Generator().manual_seed(0),
                                          device=CPU)):
        got = {jax.tree_util.keystr(k): str(v.dtype).split(".")[-1]
               for k, v in jax.tree_util.tree_leaves_with_path(params)}
        assert got == want


def test_configs_equal_reference():
    for arch in ARCHS:
        assert vars(get_config(arch)) == vars(j_get_config(arch))
        assert vars(reduced(get_config(arch))) == \
            vars(j_reduced(j_get_config(arch)))
        c, j = get_config(arch), j_get_config(arch)
        assert (c.d_inner, c.dt_rank_, c.n_params()) == \
            (j.d_inner, j.dt_rank_, j.n_params())
        assert PH.n_shared_invocations(c) == JH.n_shared_invocations(j)

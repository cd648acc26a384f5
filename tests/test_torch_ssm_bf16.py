"""The ``mamba_bf16_scan`` path of the port against the reference, on the
CPU, at reduced sizes.

Under that flag the reference's ``mamba1_full`` rounds dA and dt u B to
bf16 and combines them in bf16 by ``jax.lax.associative_scan`` over
chunks of ``mamba_chunk_override or ssm_chunk`` steps.  The port's
``mamba_scan_bf16_plain`` (the CPU path of the ``mamba_scan_bf16``
kernel) copies that recursion; ``scan_walk_bf16``, the kernel's order,
is held to it bit for bit.  Inputs are made with numpy from a seed and
handed to both packages; the reference's params cross with
``params_from_numpy``.

Tolerances and their reasons:

* The scan (``_ref_scan``: the reference's chunk body, which it runs
  inside ``mamba1_full``, as a function of the scan's inputs): h_last
  bit-equal; y within ``Y_TOL`` (relative Frobenius norm): XLA fuses the
  last level of its recursion into the einsum and keeps some sums in
  fp32 there, and sums y in another order.
* The block (``mamba1_full`` with its state): the projections before the
  scan differ from XLA's by fp32 rounding, and where such a value lies at
  a bf16 rounding boundary dA or dBu rounds the other way, one bf16 step
  (2^-8) in a rare element, carried on by the scan.  So the block's
  increment ``out - x`` is held at ``OUT_TOL`` (relative Frobenius norm)
  or an eighth of the fp32 function's distance from the reference at the
  same inputs, whichever is smaller: the fp32 function (the flag off)
  and a sequential bf16 walk (``h <- bf16(a h) + b`` step by step, the
  order the reference does not use) both fail it wherever they differ
  from the bf16 scan at all (a walk of up to 3 steps is the same
  order).  The state ``ssm`` holds bf16 values: at most ``SHARE_TOL`` of
  its elements differ from the reference's, none by more than 2^-8 of its
  largest magnitude (a flip in a large term, seen in a small element);
  the fp32 function's state differs almost everywhere.
* Gradients: straight through the roundings (the fp32 reverse recurrence
  on the rounded a and dt u B), so each leaf is held to ``jax.grad`` of
  the reference's loss under the flag at ``GRAD_TOL`` (relative
  Frobenius norm): XLA differentiates the bf16 ops themselves, and the
  two gradients differ by about half a percent (the flag's gradient and
  the fp32 one differ by about as much).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.specs import make_batch as j_make_batch
from repro.models import mamba as JM
from repro.models import model as JMODEL
from repro.models import opt_flags as JF
from repro.models.config import ShapeCell as JShapeCell
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.kernels.mamba_scan import ref as R
from repro_torch.launch.specs import make_batch
from repro_torch.models import layers as PL
from repro_torch.models import mamba as PM
from repro_torch.models import model as PMODEL
from repro_torch.models import opt_flags as PF
from repro_torch.models.config import ShapeCell

CPU = "cpu"
ARCH = "falcon-mamba-7b"
Y_TOL = 1e-4
OUT_TOL = 2e-5
SHARE_TOL = 1e-2
LOGIT_TOL = 1e-4
GRAD_TOL = 2e-2
BF16 = torch.bfloat16


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _relnorm(got, want) -> float:
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{pre}/{k}")]
    return [(pre, tree)]


def _one_step_off(got: torch.Tensor, want) -> tuple:
    """(share of elements not equal, whether each is within 2^-8 of the
    largest |want|, a bf16 step at that scale)."""
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    diff = (got - want).abs()
    return (float((diff > 0).float().mean()),
            bool((diff <= 2.0 ** -8 * want.abs().max()).all()))


# -- the scan -----------------------------------------------------------------

def _ref_scan(u, dt, Bc, Cc, A_log, C):
    """The reference's scan under ``mamba_bf16_scan``
    (src/repro/models/mamba.py:119-147) as a function of its inputs."""
    B, S, din = u.shape
    N = A_log.shape[1]
    A = -jnp.exp(A_log)
    pad = (-S) % C
    padS = lambda t: jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
    up, dtp, Bp, Cp = padS(u), padS(dt), padS(Bc), padS(Cc)
    nck = (S + pad) // C

    def chunk(h, inp):
        uc, dtc, bc, cc = inp
        dA = jnp.exp(dtc[..., None] * A).astype(jnp.bfloat16)
        dBu = ((dtc * uc.astype(jnp.float32))[..., None]
               * bc.astype(jnp.float32)[:, :, None, :]).astype(jnp.bfloat16)

        def comb(e1, e2):
            a1, b1 = e1
            a2, b2 = e2
            return a1 * a2, b1 * a2 + b2

        a_cum, b_cum = jax.lax.associative_scan(comb, (dA, dBu), axis=1)
        hs = b_cum + a_cum * h[:, None].astype(jnp.bfloat16)
        y = jnp.einsum("bcin,bcn->bci", hs, cc.astype(jnp.bfloat16))
        return hs[:, -1].astype(jnp.float32), y.astype(u.dtype)

    reshp = lambda t: t.reshape(B, nck, C, *t.shape[2:]).swapaxes(0, 1)
    h, ys = jax.lax.scan(chunk, jnp.zeros((B, din, N), jnp.float32),
                         (reshp(up), reshp(dtp), reshp(Bp), reshp(Cp)))
    return ys.swapaxes(0, 1).reshape(B, S + pad, din)[:, :S], h


def _scan_inputs(B, S, din, N, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return (r(B, S, din), np.abs(r(B, S, din)) * 0.1, r(B, S, N),
            r(B, S, N), r(din, N) * 0.5)


def seq_walk_bf16(u, dt, Bc, Cc, A_log, chunk, chunk_states=False):
    """A planted fault: the bf16 scan as a sequential walk, h <- bf16(a h)
    + b a step (rounded), from one chunk to the next; y as the plain
    version sums it."""
    A = -torch.exp(A_log.float())
    h = torch.zeros((u.shape[0],) + tuple(A.shape), dtype=BF16)
    ys = []
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t].float()[..., None] * A).to(BF16)
        b = ((dt[:, t].float() * u[:, t].float())[..., None]
             * Bc[:, t].float()[:, None, :]).to(BF16)
        h = a * h + b
        ys.append((h.float() * Cc[:, t].to(BF16).float()[:, None, :]).sum(-1))
    return torch.stack(ys, dim=1).to(u.dtype), h.float()


# C: falcon-mamba's 256, the reduced config's 32, an odd 7; S ragged
@pytest.mark.parametrize("C,S,dtype", [(256, 300, "float32"),
                                       (32, 100, "float32"),
                                       (7, 45, "float32"),
                                       (32, 70, "bfloat16"),
                                       (7, 20, "bfloat16")])
def test_plain_scan_equals_reference(C, S, dtype):
    u, dt, Bc, Cc, Al = _scan_inputs(2, S, 24, 8, seed=C + S)
    jdt = getattr(jnp, dtype)
    jy, jh = jax.jit(_ref_scan, static_argnums=5)(
        jnp.asarray(u).astype(jdt), jnp.asarray(dt),
        jnp.asarray(Bc).astype(jdt), jnp.asarray(Cc).astype(jdt),
        jnp.asarray(Al), C)
    tdt = getattr(torch, dtype)
    ins = (_t(u).to(tdt), _t(dt), _t(Bc).to(tdt), _t(Cc).to(tdt), _t(Al))
    y, h = R.mamba_scan_bf16_plain(*ins, C)
    assert y.dtype == tdt and h.dtype == torch.float32
    assert torch.equal(h, _t(np.asarray(jh)))
    jy = np.asarray(jy.astype(jnp.float32))
    err = _relnorm(y, jy)
    assert err <= Y_TOL, err
    # the fp32 function is far outside it
    y32, _ = R.mamba_scan_plain(*ins)
    assert _relnorm(y32, jy) > 4 * Y_TOL


@pytest.mark.parametrize("C", [1, 2, 7, 37, 64, 256])
def test_walk_is_the_recursion_bit_for_bit(C):
    rng = np.random.default_rng(C)
    a = _t(rng.uniform(0.3, 1.0, (2, C, 5, 4)).astype(np.float32)).to(BF16)
    b = _t(rng.normal(0, 1, (2, C, 5, 4)).astype(np.float32)).to(BF16)
    ra, rb = R.associative_scan_bf16(a, b, 1)
    wa, wb = R.scan_walk_bf16(a, b)
    assert torch.equal(ra, wa) and torch.equal(rb, wb)
    # and the order matters: a sequential fold differs past 3 steps
    sa, sb = [a[:, 0]], [b[:, 0]]
    for t in range(1, C):
        sa.append(sa[-1] * a[:, t])
        sb.append(sb[-1] * a[:, t] + b[:, t])
    if C > 3:
        assert not torch.equal(torch.stack(sb, 1), rb)


def test_plain_scan_states_and_padding():
    u, dt, Bc, Cc, Al = (_t(a) for a in _scan_inputs(1, 45, 6, 4, seed=3))
    y, h, st = R.mamba_scan_bf16_plain(u, dt, Bc, Cc, Al, 7,
                                       chunk_states=True)
    y2, h2 = R.mamba_scan_bf16_plain(u, dt, Bc, Cc, Al, 7)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert st.shape == (1, 3, 6, 4) and not st[:, 0].any()
    # each state is the carry of a run cut there, where it starts a chunk
    # (step 16 does not, 32 does not; the carry of 42 = 6 x 7 steps does)
    assert torch.equal(st, st.to(BF16).float())
    _, h42 = R.mamba_scan_bf16_plain(u[:, :42], dt[:, :42], Bc[:, :42],
                                     Cc[:, :42], Al, 7)
    _, _, st42 = R.mamba_scan_bf16_plain(u[:, :43], dt[:, :43], Bc[:, :43],
                                         Cc[:, :43], Al, 7, chunk_states=True)
    assert st42.shape[1] == 3
    # a ragged chunk's carry is its padded prefix: dt = 0 steps appended
    # give the same h_last
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :4])], dim=1)
    _, hp = R.mamba_scan_bf16_plain(pad(u), pad(dt), pad(Bc), pad(Cc), Al, 7)
    assert torch.equal(hp, h)
    assert h42.shape == h.shape


def test_wrapper_routes_and_checks():
    u, dt, Bc, Cc, Al = (_t(a) for a in _scan_inputs(2, 20, 8, 4, seed=4))
    got = sops.mamba_scan(u, dt, Bc, Cc, Al, 7)
    want = R.mamba_scan_bf16_plain(u, dt, Bc, Cc, Al, 7)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fwd = sops.mamba_scan_fwd(u, dt, Bc, Cc, Al, 7)
    assert torch.equal(fwd[0], want[0]) and fwd[2].shape == (2, 2, 8, 4)
    assert all(torch.equal(a, b) for a, b in zip(
        sops.mamba_scan(u, dt, Bc, Cc, Al), R.mamba_scan_plain(
            u, dt, Bc, Cc, Al)))
    for bad in (-1, sops.MAX_BF16_CHUNK + 1):
        with pytest.raises(ValueError, match="bf16_chunk"):
            sops.mamba_scan(u, dt, Bc, Cc, Al, bad)
    assert [sops.bf16_plan(1, 1, 8, n, 8).split
            for n in (1, 2, 3, 8, 16, 17, 64)] == [1, 1, 1, 1, 2, 4, 8]


def test_fake_trace_runs_the_bf16_operators():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        u, dt = torch.empty(2, 20, 8), torch.empty(2, 20, 8)
        Bc, Cc, Al = (torch.empty(2, 20, 4), torch.empty(2, 20, 4),
                      torch.empty(8, 4))
        y, h = sops.mamba_scan(u, dt, Bc, Cc, Al, 7)
        _, _, st = sops.mamba_scan_fwd(u, dt, Bc, Cc, Al, 7)
        g = sops.mamba_scan_bwd(u, dt, Bc, Cc, Al, st, y, h, 7)
    assert y.shape == (2, 20, 8) and h.shape == (2, 8, 4)
    assert st.shape == (2, 2, 8, 4) and [t.shape for t in g][4] == (8, 4)


def _straight_through(u, dt, Bc, Cc, A_log, C):
    """The bf16 scan's gradient by torch autograd of a sequential fp32
    recurrence whose roundings pass gradients straight through."""
    st = lambda x: x + (x.to(BF16).float() - x).detach()
    A = -torch.exp(A_log)
    h = torch.zeros((u.shape[0],) + tuple(A.shape))
    ys = []
    for t in range(u.shape[1]):
        if t % C == 0:
            h = st(h)
        a = st(torch.exp(dt[:, t, :, None] * A))
        h = a * h + st((dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :])
        ys.append(torch.sum(h * st(Cc[:, t, None, :]), dim=-1))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("S,C", [(45, 7), (40, 16), (33, 32)])
def test_plain_backward_is_the_straight_through_gradient(S, C):
    ins = [_t(a).requires_grad_() for a in _scan_inputs(2, S, 8, 4,
                                                        seed=S)]
    rng = np.random.default_rng(S + 1)
    dy = _t(rng.normal(0, 1, (2, S, 8)).astype(np.float32))
    dh = _t(rng.normal(0, 1, (2, 8, 4)).astype(np.float32))
    y, h = _straight_through(*ins, C)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    _, _, states = R.mamba_scan_bf16_plain(*(t.detach() for t in ins), C,
                                           chunk_states=True)
    got = R.mamba_scan_bwd_plain(*(t.detach() for t in ins), states, dy, dh,
                                 bf16_chunk=C)
    # the plain backward recomputes h from the bf16 scan's states, the
    # autograd oracle keeps its own fp32 h: they differ by bf16 rounding
    for g, w in zip(got, want):
        assert _relnorm(g, w) <= 1e-2, _relnorm(g, w)
    # through MambaScan the wrapper runs the same plain backward
    yy, hh = sops.mamba_scan(*ins, C)
    via = torch.autograd.grad((yy * dy).sum() + (hh * dh).sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(via, got))


# -- the block and the model --------------------------------------------------

@pytest.fixture(scope="module")
def block():
    jcfg = j_reduced(j_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = JM.mamba1_params(jcfg, jax.random.PRNGKey(3))
    p = PMODEL.params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                                 CPU)
    return jcfg, cfg, jp, p


def _block_run(cfg, p, x, **flags):
    with PF.use_flags(**flags):
        out, (conv, ssm) = PM.mamba1_full(cfg, p, _t(x), return_state=True)
    return out - _t(x), conv, ssm


# S: shorter than the conv, odd, one exact chunk (ssm_chunk 32), a ragged
# tail; the chunk overridden to 7 and 16
@pytest.mark.parametrize("S,override", [(1, 0), (3, 0), (32, 0), (100, 0),
                                        (100, 7), (100, 16), (3, 16),
                                        (32, 7)])
def test_mamba1_full_bf16_equals_reference(block, S, override):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(S).normal(0, 1, (2, S, cfg.d_model)).astype(
        np.float32)
    flags = dict(mamba_bf16_scan=True, mamba_chunk_override=override)
    with JF.use_flags(**flags):
        jout, (jconv, jssm) = JM.mamba1_full(jcfg, jp, jnp.asarray(x),
                                             return_state=True)
    want = np.asarray(jout) - x
    inc, conv, ssm = _block_run(cfg, p, x, **flags)
    inc32, _, ssm32 = _block_run(cfg, p, x, mamba_chunk_override=override)
    d32 = _relnorm(inc32, want)
    tol = min(OUT_TOL, d32 / 8)
    assert tol < d32 / 4
    assert _relnorm(inc, want) <= tol, (_relnorm(inc, want), tol)
    assert _relnorm(conv, jconv) <= 1e-6      # fp32, before the scan
    share, one_step = _one_step_off(ssm, jssm)
    assert share <= SHARE_TOL and one_step, (share, one_step)
    share32, _ = _one_step_off(ssm32, jssm)
    assert share32 > SHARE_TOL
    # the sequential bf16 walk fails wherever its order differs (S > 3)
    plain = sops.mamba_scan_bf16_plain
    sops.mamba_scan_bf16_plain = seq_walk_bf16
    try:
        inc_seq, _, _ = _block_run(cfg, p, x, **flags)
    finally:
        sops.mamba_scan_bf16_plain = plain
    if S > 3:
        assert _relnorm(inc_seq, want) > tol
    else:
        assert torch.equal(inc_seq, inc)
    # the chunk changes the result under the flag
    if override:
        inc_c, _, _ = _block_run(cfg, p, x, mamba_bf16_scan=True)
        assert not torch.equal(inc_c, inc) or S <= min(override, 32)


def test_seq_scan_flag_overrides_bf16(block):
    jcfg, cfg, jp, p = block
    x = np.random.default_rng(5).normal(0, 1, (2, 40, cfg.d_model)).astype(
        np.float32)
    both = _block_run(cfg, p, x, mamba_bf16_scan=True, mamba_seq_scan=True)
    off = _block_run(cfg, p, x)
    assert all(torch.equal(a, b) for a, b in zip(both, off))


@pytest.fixture(scope="module")
def model_pair():
    jcfg = j_reduced(j_get_config(ARCH))
    japi = JMODEL.build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return (jcfg, japi, jparams, cfg, PMODEL.build(cfg),
            PMODEL.params_from_numpy(cfg, tree, device=CPU))


def test_prefill_and_decode_bf16_equal_reference(model_pair):
    jcfg, japi, jparams, cfg, api, params = model_pair
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 41))
    with JF.use_flags(mamba_bf16_scan=True):
        jlogits, jcache = japi.prefill(
            jparams, {"tokens": jnp.asarray(tokens[:, :37], jnp.int32)},
            max_len=45)
        jcache_prefill = jcache
        jsteps = []
        for i in range(37, 41):
            jl, jcache = japi.decode(
                jparams, jnp.asarray(tokens[:, i:i + 1], jnp.int32), jcache)
            jsteps.append(np.asarray(jl))
    with PF.use_flags(mamba_bf16_scan=True):
        logits, cache = api.prefill(params, _t(tokens[:, :37]), max_len=45)
        share, one_step = _one_step_off(cache.ssm, jcache_prefill.ssm)
        assert share <= SHARE_TOL and one_step, (share, one_step)
        steps = []
        for i in range(37, 41):
            lg, cache = api.decode(params, _t(tokens[:, i:i + 1]), cache)
            steps.append(lg)
    logits32, _ = api.prefill(params, _t(tokens[:, :37]), max_len=45)
    want = np.asarray(jlogits)
    d32 = _relnorm(logits32, want)
    tol = min(LOGIT_TOL, d32 / 8)
    assert _relnorm(logits, want) <= tol, (_relnorm(logits, want), tol)
    # decode is the fp32 recurrence under the flag too, from that state
    for got, w in zip(steps, jsteps):
        assert _relnorm(got, w) <= LOGIT_TOL
    assert _relnorm(cache.ssm, jcache.ssm) <= LOGIT_TOL


def test_gradients_bf16_equal_reference(model_pair):
    jcfg, japi, jparams, cfg, api, params = model_pair
    cell = ("t", 32, 4, "train")
    jbatch = j_make_batch(jcfg, JShapeCell(*cell), seed=5)
    with JF.use_flags(mamba_bf16_scan=True, mamba_chunk_override=16):
        (jl, _), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
            jparams, jbatch)
    (jl32, _), jg32 = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jbatch)
    p = PL.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    batch = make_batch(cfg, ShapeCell(*cell), seed=5, device=CPU)
    with PF.use_flags(mamba_bf16_scan=True, mamba_chunk_override=16):
        loss, _ = api.loss(p, batch)
    leaves = dict(_paths(p))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    jleaves = dict(_paths(jax.tree.map(np.asarray, jg)))
    jleaves32 = dict(_paths(jax.tree.map(np.asarray, jg32)))
    assert set(jleaves) == set(grads)
    worst, flag_vs_fp32 = 0.0, 0.0
    for path, w in jleaves.items():
        if not np.any(w):
            continue
        worst = max(worst, _relnorm(grads[path], w))
        flag_vs_fp32 = max(flag_vs_fp32, _relnorm(jleaves32[path], w))
    assert worst <= GRAD_TOL, worst
    # the flag moves the reference's gradient itself by about as much
    assert flag_vs_fp32 > 1e-3


# -- chip_smoke.py's checks, rehearsed on the CPU -----------------------------

def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


# falcon-mamba's N 16 at C 32 and 7 (S ragged), bf16 and fp32 u
@pytest.mark.parametrize("case", [(2, 200, 48, 16, "bfloat16", "float32", 32,
                                   0),
                                  (1, 150, 40, 16, "float32", "float32", 7,
                                   0),
                                  (1, 90, 24, 8, "bfloat16", "bfloat16", 16,
                                   8)])
def test_scan_bf16_check_passes_and_catches_every_fault(case):
    """``chip_smoke.scan_bf16_case`` on the CPU (the wrapper runs the plain
    version, so the check passes at use 0) with its planted faults: the
    sequential walk, the fp32 function and the unrounded carry each beyond
    the forward's limit."""
    c = CS.scan_bf16_case("cpu", case, torch.Generator().manual_seed(0),
                          faults=True)
    assert c["max_limit_use"] == 0.0 and c["states_bit_equal"]
    assert set(c["fault_limit_use"]) == set(CS.SCAN_BF16_FAULTS)
    for f, use in c["fault_limit_use"].items():
        assert use > 1.0, (f, use)


def test_scan_bf16_bwd_check_runs_on_the_cpu():
    c = CS.scan_bf16_bwd_case(
        "cpu", (2, 40, 24, 4, "bfloat16", "float32", 7, 0, True),
        torch.Generator().manual_seed(1))
    # the wrapper returns bf16 du and dB: within half a bf16 step
    assert c["max_limit_use"] <= 1.0 and c["bit_equal_calls"]


def test_hidden_errors_of_a_patch_prefill():
    """``chip_smoke.hidden_errors`` (what ``vlm_consistency`` prints when
    its check fails): the embedding and each layer's hidden state, here the
    CPU against itself, 0 throughout."""
    cfg = reduced(get_config("llava-next-mistral-7b"))
    api = PMODEL.build(cfg)
    params = api.init(torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(5)
    pe = rng.normal(0, 1, (1, cfg.n_patches, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (1, 6))
    errs = CS.hidden_errors(cfg, params, params, toks, pe, torch.device(CPU))
    assert errs == [0.0] * (cfg.n_layers + 1)

"""The port's training stack against the reference, on the CPU.

AdamW (fp32 and bf16 moments, warm-up and clipping), the train step
(three steps of the reduced olmo-1b from one state, microbatches),
int8 gradient compression, the token pipeline and ``make_batch`` (bit
for bit), checkpoints of train states across the two packages (bf16
leaves too) and a resume, the launcher, and serving after training.
Every input is made with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCkpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.specs import make_batch as j_make_batch
from repro.models.config import ShapeCell as JShapeCell
from repro.models.model import build as j_build
from repro.training import optim as j_optim
from repro.training import step as j_step
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.launch.specs import make_batch
from repro_torch.models import layers as L
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import build
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import optim
from repro_torch.training import step as step_lib

CELL = ("t", 32, 4, "train")
ARCHS = ["olmo-1b", "chatglm3-6b", "olmoe-1b-7b", "llava-next-mistral-7b",
         "zamba2-2.7b", "whisper-tiny", "falcon-mamba-7b"]


def _leaves(tree):
    out = []
    L.tree_map(out.append, tree)
    return out


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def olmo():
    """The reduced olmo-1b in both packages, the reference's initial
    train state and the step's batch (numpy)."""
    jcfg = j_reduced(j_get_config("olmo-1b"))
    japi = j_build(jcfg)
    cfg = reduced(get_config("olmo-1b"))
    oc = dict(lr=1e-3, warmup_steps=2)
    jstate = j_step.init_train_state(japi, jax.random.PRNGKey(0),
                                     j_optim.AdamWConfig(**oc))
    batch = {k: np.asarray(v) for k, v in
             j_make_batch(jcfg, JShapeCell(*CELL), seed=5).items()}
    return dict(jcfg=jcfg, japi=japi, cfg=cfg, api=build(cfg), oc=oc,
                jstate=jstate, batch=batch)


@pytest.fixture(scope="module")
def ref_steps(olmo):
    """The reference's three steps from ``jstate``: losses, and the
    state after each."""
    step = jax.jit(j_step.make_train_step(
        olmo["japi"], j_step.RunConfig(adamw=j_optim.AdamWConfig(
            **olmo["oc"]))))
    state, losses, states = olmo["jstate"], [], []
    for _ in range(3):
        state, m = step(state, olmo["batch"])
        losses.append(float(m["loss"]))
        states.append(state)
    return losses, states


def _port_state(olmo, oc=None):
    return step_lib.train_state_from_numpy(
        olmo["cfg"], jax.tree.map(np.asarray, olmo["jstate"]),
        oc or optim.AdamWConfig(**olmo["oc"]), device="cpu")


def _batch(olmo):
    return {k: torch.from_numpy(v.copy()) for k, v in olmo["batch"].items()}


# -- AdamW -------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(moments):
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}
    make = lambda f: jax.tree.map(
        f, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = make(lambda s: rng.normal(0, 1, s).astype(np.float32))
    grads = make(lambda s: rng.normal(0, 3, s).astype(np.float32))
    mdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[moments]
    mu = make(lambda s: rng.normal(0, 0.1, s).astype(mdt))
    nu = make(lambda s: rng.uniform(0, 0.1, s).astype(mdt))
    # warm-up at step 2 of 5, and a clip far below the gradients' norm
    kw = dict(lr=1e-2, warmup_steps=5, clip_norm=0.5, moment_dtype=moments)
    joc, oc = j_optim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    jp, jst, jm = j_optim.adamw_update(
        params, grads, j_optim.OptState(mu, nu, jnp.int32(2)), joc)
    tt = lambda tree, dt=torch.float32: L.tree_map(
        lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dt), tree)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    state = optim.OptState(tt(mu, tdt), tt(nu, tdt),
                           torch.tensor(2, dtype=torch.int32))
    pp, pst, pm = optim.adamw_update(tt(params), tt(grads), state, oc)
    assert float(jm["grad_norm"]) > 10 * kw["clip_norm"]   # clipping on
    assert abs(float(pm["lr"]) - 0.6 * kw["lr"]) < 1e-9    # warm-up on
    for k in ("grad_norm", "lr"):
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    assert int(pst.step) == int(jst.step) == 3
    for want, got in ((jp, pp), (jst.mu, pst.mu), (jst.nu, pst.nu)):
        for w, g in zip(jax.tree.leaves(want), _leaves(got)):
            assert g.dtype == {"float32": torch.float32}.get(
                str(np.asarray(w).dtype), torch.bfloat16)
            err = np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()
            assert err <= 1e-6, err
    # the inputs are left as they were
    assert torch.equal(state.step, torch.tensor(2, dtype=torch.int32))


def test_grad_compression_roundtrip():
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.01, (256, 64)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    q, scale = optim.compress_int8(g, gen)
    back = optim.decompress_int8(q, scale)
    rel = float(torch.linalg.norm(back - g) / torch.linalg.norm(g))
    assert q.dtype == torch.int8 and rel < 0.02
    q2, _ = optim.compress_int8(g, torch.Generator().manual_seed(0))
    assert torch.equal(q, q2)   # the noise is the generator's


# -- the train step ------------------------------------------------------------------

def test_three_train_steps_equal_reference(olmo, ref_steps):
    """Losses to 1e-4 relative at each step.  Parameters are not compared
    elementwise after several steps: Adam's first update is about
    lr * sign(g), so an element whose gradient is at rounding level may
    step either way in the two packages."""
    jlosses, jstates = ref_steps
    step = step_lib.make_train_step(olmo["api"], step_lib.RunConfig(
        adamw=optim.AdamWConfig(**olmo["oc"])))
    state = _port_state(olmo)
    for i in range(3):
        state, m = step(state, _batch(olmo))
        assert abs(float(m["loss"]) - jlosses[i]) <= 1e-4 * jlosses[i]
        assert int(state.opt.step) == i + 1
    assert jlosses[-1] < jlosses[0]


def test_first_step_state_equals_reference(olmo, ref_steps):
    """After one step every moment equals the reference's (first-moment
    leaves to 1e-4 of their max); the params that moved are within
    2 lr of the reference's (the sign argument above)."""
    _, jstates = ref_steps
    step = step_lib.make_train_step(olmo["api"], step_lib.RunConfig(
        adamw=optim.AdamWConfig(**olmo["oc"])))
    state, _ = step(_port_state(olmo), _batch(olmo))
    got = step_lib.train_state_to_numpy(state)
    for w, g in zip(jax.tree.leaves(_np(jstates[0].opt.mu)),
                    _leaves_state(got.opt.mu)):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-9
    lr = olmo["oc"]["lr"] * 0.5
    for w, g in zip(jax.tree.leaves(_np(jstates[0].params)),
                    _leaves_state(got.params)):
        assert np.abs(g - w).max() <= 2 * lr


def test_microbatches_match_the_full_batch(olmo):
    oc = optim.AdamWConfig()
    s1 = step_lib.make_train_step(olmo["api"], step_lib.RunConfig(adamw=oc))
    s4 = step_lib.make_train_step(olmo["api"], step_lib.RunConfig(
        microbatches=4, adamw=oc))
    st1, m1 = s1(_port_state(olmo, oc), _batch(olmo))
    st4, m4 = s4(_port_state(olmo, oc), _batch(olmo))
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in zip(
        _leaves(st1.params), _leaves(st4.params)))
    assert d < 1e-4


def test_microbatch_gradients_accumulate_in_fp32(olmo):
    """With one microbatch the gradients keep the params' dtype (bf16
    here); with two they are summed into fp32 buffers."""
    cfg = dataclasses.replace(olmo["cfg"], dtype="bfloat16",
                              param_dtype="bfloat16")
    api = build(cfg)
    seen = []
    real = optim.adamw_update

    def spy(params, grads, state, oc):
        seen.append({g.dtype for g in _leaves(grads)})
        return real(params, grads, state, oc)

    oc = optim.AdamWConfig()
    state = step_lib.init_train_state(api, torch.Generator().manual_seed(0),
                                      oc, device="cpu")
    optim.adamw_update = spy
    try:
        for mb in (1, 2):
            step_lib.make_train_step(api, step_lib.RunConfig(
                microbatches=mb, adamw=oc))(state, _batch(olmo))
    finally:
        optim.adamw_update = real
    assert seen == [{torch.bfloat16}, {torch.float32}]


# -- data --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,steps,host,hosts",
                         [(0, (0, 1, 2), 0, 1), (7, (5, 3, 40), 0, 1),
                          (9, (3, 4), 1, 2), (1, (0, 0, 9), 2, 4)])
def test_pipeline_equals_reference(seed, steps, host, hosts):
    kw = dict(vocab=1000, seq_len=48, global_batch=8, seed=seed)
    jp = JPipeline(JDataConfig(**kw), host_id=host, n_hosts=hosts)
    pp = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=hosts)
    for s in steps:
        jb, pb = jp.batch(s), pp.batch(s)
        assert set(jb) == set(pb)
        for k in jb:
            assert pb[k].dtype == jb[k].dtype
            assert np.array_equal(pb[k], jb[k])
    assert (pp.lookups, pp.io_misses) == (jp.lookups, jp.io_misses)
    assert pp.index_hit_ratio == jp.index_hit_ratio


def test_pipeline_determinism_and_index_cache():
    dc = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=7)
    p1, p2 = TokenPipeline(dc), TokenPipeline(dc)
    b1, b2 = p1.batch(5), p2.batch(5)
    assert (b1["tokens"] == b2["tokens"]).all()
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    for s in range(30):
        p1.batch(s)
    assert p1.index_hit_ratio > 0.3


def test_pipeline_elastic_host_slices():
    dc = DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=9)
    whole = TokenPipeline(dc).batch(3)["tokens"]
    h0 = TokenPipeline(dc, host_id=0, n_hosts=2).batch(3)["tokens"]
    h1 = TokenPipeline(dc, host_id=1, n_hosts=2).batch(3)["tokens"]
    assert (np.concatenate([h0, h1]) == whole).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cell", [CELL, ("p", 24, 2, "prefill"),
                                  ("d", 24, 2, "decode")], ids=str)
def test_make_batch_equals_reference(arch, cell):
    jb = j_make_batch(j_reduced(j_get_config(arch)), JShapeCell(*cell),
                      seed=5)
    pb = make_batch(reduced(get_config(arch)), ShapeCell(*cell), seed=5,
                    device="cpu")
    assert set(jb) == set(pb)
    for k in jb:
        want = np.asarray(jb[k])
        got = pb[k].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), k


# -- checkpoints -------------------------------------------------------------------

def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers of its width."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_the_reference(olmo, dtype, tmp_path):
    cfg, jcfg = olmo["cfg"], olmo["jcfg"]
    if dtype == "bfloat16":
        cfg, jcfg = _bf16(cfg), _bf16(jcfg)
    oc = optim.AdamWConfig(moment_dtype=dtype)
    state = step_lib.init_train_state(build(cfg), torch.Generator()
                                      .manual_seed(1), oc, device="cpu")
    CheckpointManager(str(tmp_path)).save(7, state)
    like = jax.eval_shape(lambda: j_step.init_train_state(
        j_build(jcfg), jax.random.PRNGKey(0),
        j_optim.AdamWConfig(moment_dtype=dtype)))
    got = JCkpt(str(tmp_path)).restore(7, like, verify=True)
    n_bf16 = 0
    for w, g in zip(_leaves_state(state), jax.tree.leaves(got)):
        assert np.array_equal(_bits(w), _bits(g))
        n_bf16 += w.dtype == torch.bfloat16
    assert len(_leaves_state(state)) == len(jax.tree.leaves(got))
    assert (n_bf16 > 0) == (dtype == "bfloat16")


def _leaves_state(state):
    """A train state's leaves in the reference's pytree order (dict keys
    sorted, the namedtuples' fields in order)."""
    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k])
        elif hasattr(t, "_fields"):
            for f in t._fields:
                yield from walk(getattr(t, f))
        else:
            yield t
    return list(walk(state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(olmo, dtype, tmp_path):
    cfg, jcfg = olmo["cfg"], olmo["jcfg"]
    if dtype == "bfloat16":
        cfg, jcfg = _bf16(cfg), _bf16(jcfg)
    jstate = j_step.init_train_state(j_build(jcfg), jax.random.PRNGKey(2),
                                     j_optim.AdamWConfig(moment_dtype=dtype))
    JCkpt(str(tmp_path)).save(5, jstate)
    oc = optim.AdamWConfig(moment_dtype=dtype)
    like = step_lib.init_train_state(build(cfg), torch.Generator()
                                     .manual_seed(0), oc, device="cpu")
    got = CheckpointManager(str(tmp_path)).restore(5, like, device="cpu",
                                                   verify=True)
    assert isinstance(got, step_lib.TrainState)
    for w, g in zip(jax.tree.leaves(jstate), _leaves_state(got)):
        assert np.array_equal(_bits(w), _bits(g))
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype)


def test_resume_equals_the_uninterrupted_run(olmo, tmp_path):
    step = step_lib.make_train_step(olmo["api"], step_lib.RunConfig(
        adamw=optim.AdamWConfig(**olmo["oc"])))
    batch = _batch(olmo)
    state = _port_state(olmo)
    for _ in range(2):
        state, _ = step(state, batch)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(2, state)
    a, _ = step(state, batch)
    restored = mgr.restore(None, state, device="cpu")
    b, _ = step(restored, batch)
    for x, y in zip(_leaves_state(a), _leaves_state(b)):
        assert torch.equal(x, y)


# -- the launcher, serving after training -----------------------------------------

def test_launcher_runs_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "4", "--ckpt", str(tmp_path),
            "--ckpt-every", "2", "--seq", "32", "--batch", "4"]
    first = launch_train.main(argv)
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"]))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    second = launch_train.main(argv[:3] + ["6"] + argv[4:])
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert "resumed from step 4" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]


def test_serving_after_training(olmo, tmp_path):
    """Train 4 steps, then serve the live params and the restored ones:
    the same tokens, and no output requires grad."""
    api = olmo["api"]
    step = step_lib.make_train_step(api, step_lib.RunConfig(
        adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=2)))
    state = _port_state(olmo)
    pipe = TokenPipeline(DataConfig(vocab=olmo["cfg"].vocab, seq_len=32,
                                    global_batch=4, seed=3))
    for i in range(4):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in pipe.batch(i).items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    restored = mgr.restore(None, state, device="cpu")
    reqs = [Request(0, [1, 2, 3, 4, 5], max_new=4),
            Request(1, [1, 2, 3, 9, 9], max_new=4)]
    outs = []
    for params in (state.params, restored.params):
        eng = ServingEngine(api, params, block_size=8, hbm_blocks=16,
                            max_batch=2, device="cpu")
        outs.append({c.req_id: c.tokens for c in eng.run(
            [dataclasses.replace(r) for r in reqs])})
    assert outs[0] == outs[1]
    assert all(len(t) == 4 for t in outs[0].values())


def test_engine_builds_no_graph_from_params_that_require_grad(olmo):
    api = olmo["api"]
    params = L.tree_map(lambda t: t.requires_grad_(),
                        _port_state(olmo).params)
    seen = []

    def prefill(*a, **kw):
        out = api.prefill(*a, **kw)
        seen.append(torch.is_grad_enabled() or out[0].requires_grad)
        return out

    def decode_paged(*a, **kw):
        out = api.decode_paged(*a, **kw)
        seen.append(torch.is_grad_enabled() or out[0].requires_grad)
        return out

    spy = dataclasses.replace(api, prefill=prefill, decode_paged=decode_paged)
    eng = ServingEngine(spy, params, block_size=8, hbm_blocks=16,
                        max_batch=2, device="cpu")
    outs = eng.run([Request(0, [1, 2, 3, 4, 5], max_new=3)])
    assert len(outs[0].tokens) == 3
    assert seen and not any(seen)

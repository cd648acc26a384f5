"""The training loss of every family of the port against the reference.

For each reduced config (fp32) the same numpy params (the reference's
``init``, carried across with ``params_from_numpy``) and the same batch
(``make_batch(ShapeCell("t", 32, 4, "train"), seed=5)``) go through the
reference's ``api.loss`` under ``jax.value_and_grad`` and the port's
``api.loss`` under ``torch.autograd``: the loss and its metrics to 1e-5
relative, every gradient leaf to 1e-4 x max |g_ref| + 1e-7.  The
reference's results are computed once per family (module-scoped cache).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch.specs import make_batch as j_make_batch
from repro.models.config import ShapeCell as JShapeCell
from repro.models.model import build as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.launch.specs import make_batch
from repro_torch.models import layers as L
from repro_torch.models.config import ShapeCell
from repro_torch.models.model import build, cross_entropy, params_from_numpy

ARCHS = ["olmo-1b", "chatglm3-6b", "olmoe-1b-7b", "llava-next-mistral-7b",
         "zamba2-2.7b", "whisper-tiny", "falcon-mamba-7b"]
CELL = ("t", 32, 4, "train")
_CACHE = {}


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _paths(tree[k], f"{pre}/{k}")
        return out
    return [(pre, tree)]


def _run(arch):
    """(reference (loss, metrics, {path: grad}), port's the same)."""
    if arch in _CACHE:
        return _CACHE[arch]
    jcfg = j_reduced(j_get_config(arch))
    japi = j_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    jbatch = j_make_batch(jcfg, JShapeCell(*CELL), seed=5)
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jbatch)
    ref = (float(jl), {k: float(v) for k, v in jm.items()},
           {p: np.asarray(g) for p, g in _paths(jax.tree.map(np.asarray, jg))})

    cfg = reduced(get_config(arch))
    api = build(cfg)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    leaves = []

    def live(t):
        t = t.requires_grad_()
        leaves.append(t)
        return t

    params = L.tree_map(live, params)
    batch = make_batch(cfg, ShapeCell(*CELL), seed=5, device="cpu")
    loss, metrics = api.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    port = (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {p: (np.zeros(tuple(t.shape), np.float32) if g is None
                 else g.numpy())
             for (p, t), g in zip(_paths(params), grads)})
    _CACHE[arch] = ref, port
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_equal_reference(arch):
    (jl, jm, _), (pl, pm, _) = _run(arch)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert set(pm) == set(jm)
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1e-6), k
    if j_get_config(arch).family == "moe":  # the aux loss is in the sum
        assert jm["aux"] > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_equal_reference(arch):
    (_, _, jg), (_, _, pg) = _run(arch)
    assert set(pg) == set(jg)
    for p, g in jg.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        err = float(np.abs(pg[p] - g).max())
        assert err <= tol, f"{arch} {p}: {err} > {tol}"


def test_vlm_batch_labels_the_patches_minus_one():
    cfg = reduced(get_config("llava-next-mistral-7b"))
    b = make_batch(cfg, ShapeCell(*CELL), seed=5, device="cpu")
    P = b["patch_embeds"].shape[1]
    assert (b["labels"][:, :P] == -1).all() and (b["labels"][:, P:] >= 0).all()
    assert b["tokens"].shape[1] + P == b["labels"].shape[1]


def test_cross_entropy_ignores_minus_one_and_detaches_the_max():
    logits = torch.randn(2, 3, 7, requires_grad=True)
    labels = torch.tensor([[1, -1, 3], [-1, -1, 6]])
    ce = cross_entropy(logits, labels)
    lp = torch.log_softmax(logits.double(), -1)
    want = -(lp[0, 0, 1] + lp[0, 2, 3] + lp[1, 2, 6]) / 3
    assert abs(float(ce) - float(want)) < 1e-6
    g, = torch.autograd.grad(ce, logits)
    assert torch.equal(g[0, 1], torch.zeros(7)) and torch.equal(
        g[1, :2], torch.zeros(2, 7))
    assert float(cross_entropy(logits, torch.full((2, 3), -1))) == 0.0

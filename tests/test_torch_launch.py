"""The port's launch layer against the reference's, on the CPU:

* ``launch.serve.main`` on reduced granite-3-8b (with a live pool
  shrink) gives the tokens and pool stats of the reference's
  ``ServingEngine`` on the same params, carried across with
  ``params_from_numpy``;
* ``launch.specs.input_specs`` and ``training.step.abstract_train_state``
  give the reference's shapes and dtypes, for every architecture (at
  full size: fake tensors, nothing allocated);
* the sharding hints ``_maybe_shard_scores`` and ``_constrain`` are the
  identity on plain tensors, flags on or off.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.launch import specs as j_specs
from repro.models.config import SHAPES as J_SHAPES
from repro.models.model import build as j_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.training import optim as j_optim
from repro.training import step as j_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve, specs
from repro_torch.models import layers as L
from repro_torch.models import moe, opt_flags
from repro_torch.models.config import SHAPES
from repro_torch.models.model import build, params_from_numpy
from repro_torch.training import optim, step

SERVE_ARGS = ["--arch", "granite-3-8b", "--requests", "8", "--max-new", "8",
              "--hbm-blocks", "28", "--shrink-to", "14", "--device", "cpu"]


def test_serve_main_equals_reference_engine():
    jcfg = j_reduced(j_get_config("granite-3-8b"))
    japi = j_build(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = serve.reduced(serve.get_config("granite-3-8b"))
    out = serve.main(SERVE_ARGS, params=params_from_numpy(cfg, tree, "cpu"))

    # the reference launcher's run, on the same requests
    reqs = serve.requests(cfg.vocab, 8, 32, 8)
    jeng = JEngine(japi, jparams, block_size=8, hbm_blocks=28, max_batch=4)
    jreqs = [JRequest(**dataclasses.asdict(r)) for r in reqs]
    jdone = jeng.run(jreqs[:4])
    jeng.pool.resize(14)
    jdone += jeng.run(jreqs[4:])
    assert [(c.req_id, c.tokens) for c in out["completions"]] == \
        [(c.req_id, c.tokens) for c in jdone]
    js, jf = jeng.stats
    assert dataclasses.asdict(out["stats"]) == dataclasses.asdict(js)
    assert out["flows"] == jf
    assert all(len(c.tokens) == 8 for c in out["completions"])


def test_serve_refuses_families_without_paged_kv():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "falcon-mamba-7b", "--device", "cpu"])


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_arch_registries_agree():
    assert ARCH_IDS == J_ARCH_IDS
    assert [s.shape for s in SHAPES] == [s.shape for s in J_SHAPES]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch):
    for cell, jcell in zip(SHAPES, J_SHAPES):
        got = specs.input_specs(get_config(arch), cell)
        want = j_specs.input_specs(j_get_config(arch), jcell)
        assert set(got) == set(want)
        for k, t in got.items():
            assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
            assert _dtype_name(t.dtype) == str(want[k].dtype), (arch, k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape), _dtype_name(tree.dtype))}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_equals_reference(arch):
    mdt = "bfloat16" if arch == "kimi-k2-1t-a32b" else "float32"
    got = step.abstract_train_state(build(get_config(arch)),
                                    optim.AdamWConfig(moment_dtype=mdt))
    want = j_step.abstract_train_state(
        j_build(j_get_config(arch)), j_optim.AdamWConfig(moment_dtype=mdt))
    g, w = _flat(got), _flat(want)
    assert g == {k: (s, str(d)) for k, (s, d) in w.items()}
    leaf = got.params["embed"]["tok"]
    assert isinstance(leaf, torch._subclasses.fake_tensor.FakeTensor)


@pytest.mark.parametrize("flags", [{}, {"decode_shard_scores": True,
                                        "moe_local_dispatch": True}])
def test_sharding_hints_are_identity_on_plain_tensors(flags):
    x = torch.randn(2, 3, 1, 5)
    b = torch.randn(8, 4)
    with opt_flags.use_flags(**flags):
        assert L._maybe_shard_scores(x) is x
        assert moe._constrain(b, ("data_batch", None)) is b
        c = torch.randn(4, 2, 3)
        assert moe._constrain(c, ("model", None, None)) is c

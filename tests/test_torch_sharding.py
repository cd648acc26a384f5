"""The port's sharding rules against the reference's, entry for entry.

For every architecture at full size, on meshes (16, 16), (2, 16, 16),
(4, 2) and (2, 2): ``param_specs`` and ``opt_state_specs`` of the
params, ``batch_specs`` of every shape cell's batch, and
``cache_specs`` of ``init_cache``'s shapes for every decode cell that
applies, with the divisibility fallbacks each records.  The reference
gets a ``jax.sharding.AbstractMesh`` (no devices), the port a
``MeshShape`` and its shape-only params (fake tensors) and caches (on
the meta device).  Then ``placements`` on axis tuples, and
``distribute`` on a one-rank mesh.
"""

from __future__ import annotations

import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.models.config import SHAPES as J_SHAPES
from repro.models.config import cell_applicable as j_applicable
from repro.models.model import build as j_build
from repro.sharding import rules as j_rules
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs
from repro_torch.models.config import SHAPES, cell_applicable
from repro_torch.models.model import build
from repro_torch.sharding import rules
from repro_torch.training import optim, step

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _abstract_mesh(sizes, names):
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:  # older jax: one tuple of (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and namedtuples."""
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
    return {prefix[:-1]: tree}


def _same(port_tree, ref_tree, what):
    p, r = _flat(port_tree), _flat(ref_tree)
    assert set(p) == set(r), what
    for k in r:
        assert tuple(p[k]) == tuple(r[k]), (what, k, p[k], r[k])


@pytest.fixture(scope="module")
def params():
    """{arch: (port shape-only params, reference eval_shape params)}."""
    out = {}
    for arch in ARCH_IDS:
        state = step.abstract_train_state(build(get_config(arch)),
                                          optim.AdamWConfig())
        jp = jax.eval_shape(j_build(j_get_config(arch)).init,
                            jax.random.PRNGKey(0))
        out[arch] = (state.params, jp)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_reference(params, arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    mesh = rules.MeshShape(sizes, names)
    jmesh = _abstract_mesh(sizes, names)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    pp, jp = params[arch]
    log, jlog = rules.RuleLog(), j_rules.RuleLog()

    ps = rules.param_specs(cfg, mesh, pp, log)
    jps = j_rules.param_specs(jcfg, jmesh, jp, jlog)
    _same(ps, jps, "params")
    _same(rules.opt_state_specs(cfg, mesh, pp, ps, log),
          j_rules.opt_state_specs(jcfg, jmesh, jp, jps, jlog), "moments")
    for cell, jcell in zip(SHAPES, J_SHAPES):
        _same(rules.batch_specs(cfg, mesh, specs.batch_shapes(cfg, cell),
                                log),
              j_rules.batch_specs(jcfg, jmesh,
                                  j_specs.batch_shapes(jcfg, jcell), jlog),
              f"batch {cell.shape}")
        if cell.kind != "decode" or cell_applicable(cfg, cell):
            assert bool(cell_applicable(cfg, cell)) == \
                bool(j_applicable(jcfg, jcell))
            continue
        B, S = cell.global_batch, cell.seq_len
        cache = build(cfg).init_cache(B, S, device="meta")
        jcache = jax.eval_shape(lambda: j_build(jcfg).init_cache(B, S))
        _same(rules.cache_specs(cfg, mesh, cache, log),
              j_rules.cache_specs(jcfg, jmesh, jcache, jlog),
              f"cache {cell.shape}")
    assert sorted(log.fallbacks) == sorted(jlog.fallbacks)


def test_placements_of_axis_tuples():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # placements() reads only the dim names
        mesh_dim_names = ("pod", "data", "model")

    assert rules.placements(Mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert rules.placements(Mesh, (None, ("data",))) == \
        (Replicate(), Shard(1), Replicate())
    assert rules.placements(Mesh, ()) == (Replicate(),) * 3
    assert rules.batch_axes(rules.MeshShape((2, 4), ("data", "model"))) \
        == ("data",)


def test_distribute_on_one_rank(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(4, 4, device_type="cpu")   # clamped to 1x1
        assert tuple(mesh.shape) == (1, 1)
        tree = {"a": torch.arange(6.).reshape(2, 3), "n": 3}
        out = rules.distribute(tree, mesh, {"a": (("data",), "model"),
                                            "n": ()})
        assert out["n"] == 3
        assert torch.equal(out["a"].full_tensor(), tree["a"])
        assert tuple(out["a"].placements) == rules.placements(
            mesh, (("data",), "model"))
    finally:
        dist.destroy_process_group()

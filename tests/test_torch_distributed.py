"""The port's sharded train step on 4 gloo CPU ranks, held against the
port's one-device step and the reference's one-device
``make_train_step`` (which runs without a mesh), at reduced size:

* olmo-1b, one step on a (2, 2) mesh in two microbatches, then a
  checkpoint restored elastically onto (1, 4) and onto (4, 1), and the
  next step on each from the restored state;
* granite-3-8b on (1, 4): its 2 kv heads do not divide the "model" dim,
  so wk/wv are replicated while wq is split (the GQA case);
* falcon-mamba-7b on (2, 2): the scan local over batch and d_inner;
* olmoe-1b-7b on (2, 2), with ``moe_local_dispatch`` on and off;
* kimi-k2-1t-a32b on (1, 4): two of its 8 experts a rank, the unpinned
  dispatch, its outputs gathered from the expert-split buffer;
* granite-3-8b's decode step on a cache whose sequence the rules split
  over "model", on (2, 2) and (1, 4) (where two ranks hold no position
  yet): the ``paged_attention`` wrapper on each rank's shards, merged by
  its lse, equal to the one-device decode.

One spawn of 4 processes (a ``FileStore`` under ``tmp_path``, so test
workers never share a port) runs every case and writes its numbers;
each test reads one case.  The reference runs in this process, on one
device.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import pytest

WORLD = 4
LR = dict(lr=1e-3, warmup_steps=1)
CASES = {  # name: (arch, mesh, microbatches)
    "olmo": ("olmo-1b", (2, 2), 2),
    "granite": ("granite-3-8b", (1, 4), 1),
    "mamba": ("falcon-mamba-7b", (2, 2), 1),
    "olmoe": ("olmoe-1b-7b", (2, 2), 1),
    "kimi": ("kimi-k2-1t-a32b", (1, 4), 1),
}
CELL = ("t", 32, 8, "train")   # seq 32, global batch 8
RESTORE_MESHES = ((1, 4), (4, 1))
DECODE_MESHES = ((2, 2), (1, 4))


def _ref_state_to_numpy(state):
    import jax
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), state.params)
    return {"params": tree,
            "mu": jax.tree.map(lambda x: np.asarray(x, np.float32),
                               state.opt.mu),
            "nu": jax.tree.map(lambda x: np.asarray(x, np.float32),
                               state.opt.nu),
            "step": int(np.asarray(state.opt.step))}


def _reference(tmp):
    """The reference's one-device steps: for each case its initial state
    and first-step loss; for olmo also the second step's loss from the
    state after the first."""
    import jax
    from repro.configs import get_config, reduced
    from repro.launch.specs import make_batch
    from repro.models.config import ShapeCell
    from repro.models.model import build
    from repro.training import optim, step as step_lib

    out = {}
    for name, (arch, _, mb) in CASES.items():
        cfg = reduced(get_config(arch))
        api = build(cfg)
        oc = optim.AdamWConfig(**LR)
        rc = step_lib.RunConfig(microbatches=mb, adamw=oc)
        state = step_lib.init_train_state(api, jax.random.PRNGKey(0), oc)
        init = _ref_state_to_numpy(state)
        step = jax.jit(step_lib.make_train_step(api, rc))
        state, m = step(state, make_batch(cfg, ShapeCell(*CELL), seed=5))
        out[name] = {"init": init, "loss1": float(m["loss"])}
        if name == "olmo":
            _, m2 = step(state, make_batch(cfg, ShapeCell(*CELL), seed=6))
            out[name]["loss2"] = float(m2["loss"])
    with open(os.path.join(tmp, "ref.pkl"), "wb") as f:
        pickle.dump(out, f)
    return out


def _state(cfg, tree, oc):
    from repro_torch.training import optim, step as step_lib
    holder = step_lib.TrainState(
        params=tree["params"],
        opt=optim.OptState(mu=tree["mu"], nu=tree["nu"],
                           step=np.int32(tree["step"])))
    return step_lib.train_state_from_numpy(cfg, holder, oc, device="cpu")


def _max_diff(a, b):
    from repro_torch.models import layers as L
    out = []
    L.tree_map(out.append, L.tree_map(lambda t: t, a))
    ref = []
    L.tree_map(ref.append, b)
    return max(float((x.full_tensor() if hasattr(x, "full_tensor") else x)
                     .sub(y).abs().max()) for x, y in zip(out, ref))


def _worker(rank, tmp):
    import torch
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD)
    try:
        _run_cases(rank, tmp)
    finally:
        dist.destroy_process_group()


def _run_cases(rank, tmp):
    import torch
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import batch_shapes, make_batch
    from repro_torch.models import opt_flags
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.model import build
    from repro_torch.sharding import rules
    from repro_torch.training import optim, step as step_lib

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    cell = ShapeCell(*CELL)
    res = {}

    def sharded_step(cfg, api, rc, state, mesh_shape, seed):
        mesh = make_host_mesh(*mesh_shape, device_type="cpu")
        specs = step_lib.state_specs(cfg, mesh, state.params)
        dstate = rules.distribute(state, mesh, specs)
        batch = make_batch(cfg, cell, seed=seed, device="cpu")
        bspecs = rules.batch_specs(cfg, mesh, batch_shapes(cfg, cell))
        dbatch = rules.distribute(batch, mesh, bspecs)
        new, m = step_lib.make_train_step(api, rc)(dstate, dbatch)
        return mesh, specs, new, float(m["loss"]), float(m["grad_norm"])

    for name, (arch, mesh_shape, mb) in CASES.items():
        cfg = reduced(get_config(arch))
        api = build(cfg)
        oc = optim.AdamWConfig(**LR)
        rc = step_lib.RunConfig(microbatches=mb, adamw=oc)
        state0 = _state(cfg, ref[name]["init"], oc)
        plain_step = step_lib.make_train_step(api, rc)
        plain1, pm = plain_step(state0, make_batch(cfg, cell, seed=5,
                                                   device="cpu"))
        r = {"ref": ref[name]["loss1"], "plain": float(pm["loss"]),
             "plain_gn": float(pm["grad_norm"])}
        mesh, specs, new, r["mesh"], r["mesh_gn"] = sharded_step(
            cfg, api, rc, state0, mesh_shape, 5)
        r["param_diff"] = _max_diff(new.params, plain1.params)
        if name == "olmoe":
            with opt_flags.use_flags(moe_local_dispatch=True):
                _, _, _, r["local_dispatch"], _ = sharded_step(
                    cfg, api, rc, state0, mesh_shape, 5)
        if name == "olmo":
            mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
            mgr.save(1, new, blocking=True)
            like = plain1
            _, pm2 = plain_step(mgr.restore(1, like, device="cpu"),
                                make_batch(cfg, cell, seed=6, device="cpu"))
            r["ref2"] = ref[name]["loss2"]
            r["plain2"] = float(pm2["loss"])
            for ms in RESTORE_MESHES:
                m2 = make_host_mesh(*ms, device_type="cpu")
                sp2 = step_lib.state_specs(cfg, m2, plain1.params)
                restored = mgr.restore(1, like, shardings=(m2, sp2))
                ok = all(
                    tuple(x.placements) == rules.placements(m2, s)
                    for x, s in zip(_leaves(restored), _leaves(sp2)))
                batch = rules.distribute(
                    make_batch(cfg, cell, seed=6, device="cpu"), m2,
                    rules.batch_specs(cfg, m2, batch_shapes(cfg, cell)))
                _, m = step_lib.make_train_step(api, rc)(restored, batch)
                r[f"restored_{ms[0]}x{ms[1]}"] = float(m["loss"])
                r[f"placed_{ms[0]}x{ms[1]}"] = ok
        res[name] = r
    res["decode"] = _sharded_decode(cell)
    if rank == 0:
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


def _sharded_decode(cell):
    """granite-3-8b's decode step on a rules-placed DTensor cache of 32
    positions holding 10, on each of ``DECODE_MESHES``: the largest
    difference of its logits from the one-device decode's, and this
    rank's calls of ``paged_attention_lse`` (the wrapper that runs the
    kernel on a card) in that step."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.model import build
    from repro_torch.sharding import dtensor as dt
    from repro_torch.sharding import rules
    from repro_torch.training import step as step_lib

    cfg = reduced(get_config("granite-3-8b"))
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = make_batch(cfg, cell, seed=7, device="cpu")["tokens"][:4, :11]
    _, cache = api.prefill(params, tokens[:, :10], max_len=32)
    want, _ = api.decode(params, tokens[:, 10:], cache)
    calls = [0]
    lse = pops.paged_attention_lse

    def counted(*args, **kw):
        calls[0] += 1
        return lse(*args, **kw)

    out = {"n_layers": cfg.n_layers}
    pops.paged_attention_lse = counted
    try:
        for ms in DECODE_MESHES:
            mesh = make_host_mesh(*ms, device_type="cpu")
            dcache = rules.distribute(cache, mesh,
                                      rules.cache_specs(cfg, mesh, cache))
            dtok = rules.distribute(tokens[:, 10:], mesh, rules.batch_specs(
                cfg, mesh, {"tokens": ((4, 1), torch.int32)})["tokens"])
            dparams = rules.distribute(params, mesh,
                                       rules.param_specs(cfg, mesh, params))
            calls[0] = 0
            with dt.implicit():
                got, _ = step_lib.make_decode_step(api)(dparams, dtok,
                                                        dcache)
            name = f"{ms[0]}x{ms[1]}"
            out[f"split_{name}"] = [str(p) for p in dcache.k.placements]
            out[f"calls_{name}"] = calls[0]
            out[f"diff_{name}"] = float((dt.plain(got) - want).abs().max())
    finally:
        pops.paged_attention_lse = lse
    return out


def _leaves(tree):
    from repro_torch.checkpoint.ckpt import _leaf_paths
    return [x for _, x in _leaf_paths(tree)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("dist"))
    _reference(tmp)
    mp.spawn(_worker, args=(tmp,), nprocs=WORLD, join=True)
    with open(os.path.join(tmp, "result.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_device_steps(results, name):
    r = results[name]
    assert abs(r["mesh"] - r["plain"]) < 1e-3, r
    assert abs(r["mesh"] - r["ref"]) < 1e-3, r
    assert abs(r["mesh_gn"] - r["plain_gn"]) < 1e-3 * max(1.0, r["plain_gn"])
    assert r["param_diff"] < 1e-4, r


@pytest.mark.parametrize("mesh", ["1x4", "4x1"])
def test_elastic_restore_then_step(results, mesh):
    r = results["olmo"]
    assert r[f"placed_{mesh}"]
    assert abs(r[f"restored_{mesh}"] - r["plain2"]) < 1e-3, r
    assert abs(r[f"restored_{mesh}"] - r["ref2"]) < 1e-3, r


def test_moe_local_dispatch_is_the_same_step(results):
    r = results["olmoe"]
    assert abs(r["local_dispatch"] - r["mesh"]) < 1e-5, r


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_decode_runs_the_kernel_wrapper_on_each_shard(results, mesh):
    r = results["decode"]
    assert "S(2)" in r[f"split_{mesh}"], r   # the sequence split
    assert r[f"diff_{mesh}"] < 1e-5, r
    # rank 0 holds positions 0.. of every layer's cache: one call a layer
    assert r[f"calls_{mesh}"] == r["n_layers"], r

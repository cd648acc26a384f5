"""The port's dry-run, cost counts and roofline, on the CPU.

The fake process group runs in a subprocess, so it never leaks into
other tests of the worker.  In it:

* ``launch.cost.CostMode`` on the reference's ``test_hlo_cost.py``
  program: L = 8 products of a (64, 512) batch with 512 x 512 weights,
  the batch split over "data" and the weights' output columns over
  "model" of a (2, 2) mesh.  Per-device flops are 2 B D D L / 4.  The
  collectives are the ones DTensor runs: each layer after the first
  needs its input's columns whole, so it all-gathers them over
  "model": L - 1 = 7 all-gathers (XLA's scan, which the reference
  counts, gathers once per trip: L).
* one cell of each kind (train, prefill, decode, and decode under
  ``--variant opt``) of reduced granite-3-8b on a fake (4, 2) mesh
  writes an OK record with the reference's keys, whose fallbacks equal
  the reference rules' for that cell.

And ``roofline.model_flops`` equals the reference's for every
architecture and shape.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCH = "granite-3-8b"
CELLS = [("train_4k", "base"), ("prefill_32k", "base"),
         ("decode_32k", "base"), ("decode_32k", "opt")]
# the keys of the reference's dry-run records (repro/launch/dryrun.py)
REF_KEYS = {"status", "arch", "shape", "variant", "commit_amortized", "mesh",
            "n_chips", "kind", "lower_s", "compile_s", "memory_analysis",
            "cost_flops", "cost_bytes_accessed", "xla_cost_flops_looponce",
            "xla_cost_bytes_looponce", "collectives",
            "collective_wire_bytes", "byte_categories", "roofline",
            "sharding_fallbacks", "hlo_bytes", "wall_s"}

SCRIPT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config, reduced
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_host_mesh

out = {}
dryrun.fake_process_group(4)
mesh = make_host_mesh(2, 2, device_type="cpu")
D, L, B = 512, 8, 64
with FakeTensorMode():
    W = distribute_tensor(torch.zeros(L, D, D, dtype=torch.bfloat16), mesh,
                          [Replicate(), Shard(2)], src_data_rank=None)
    x = distribute_tensor(torch.zeros(B, D, dtype=torch.bfloat16), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    with cost.CostMode() as cm:
        c = x
        for i in range(L):
            c = torch.relu(c @ W[i])
        torch.sum(c.float())
out["matmul"] = cm.totals()
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.kernels.paged_attention import ops as pops
refused = []
with FakeTensorMode():
    d = lambda *s: distribute_tensor(torch.zeros(*s), mesh,
                                     [Shard(0), Replicate()],
                                     src_data_rank=None)
    calls = {
        "flash_attention": lambda: fops.flash_attention(
            d(2, 8, 2, 8), d(2, 8, 2, 8), d(2, 8, 2, 8)),
        "mamba_scan": lambda: sops.mamba_scan(
            d(2, 8, 4), d(2, 8, 4), d(2, 8, 2), d(2, 8, 2), d(4, 2)),
        "paged_attention": lambda: pops.paged_attention(
            d(2, 2, 8), d(2, 8, 2, 8), d(2, 8, 2, 8),
            torch.zeros(2, 1, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), validate=False)}
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            if "not DTensors" in str(e):
                refused.append(name)
out["refused"] = refused
dryrun.fake_process_group(8)
cfg = reduced(get_config(sys.argv[1]))
for shape, variant in json.loads(sys.argv[2]):
    out[shape + "/" + variant] = dryrun.lower_cell(
        sys.argv[1], shape, False, variant, cfg=cfg, mesh_shape=(4, 2))
import torch.distributed as dist
dist.destroy_process_group()
print("RESULT" + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", SCRIPT, ARCH,
                        json.dumps(CELLS)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    return json.loads(line[-1][len("RESULT"):])


def test_cost_counts_local_flops_and_dtensor_collectives(records):
    r = records["matmul"]
    D, L, B = 512, 8, 64
    exp = 2 * B * D * D * L / 4
    assert abs(r["flops"] - exp) / exp < 0.01, r["flops"]
    ag = r["collectives"]["all-gather"]
    assert ag["count"] == L - 1, ag
    # each gathers a (B/2, D) bf16 activation, on the wire once
    assert ag["bytes"] == (L - 1) * (B // 2) * D * 2
    assert ag["wire_bytes"] == ag["bytes"]
    assert r["collectives"]["all-reduce"]["count"] == 0


def test_a_dtensor_reaching_a_kernel_wrapper_raises(records):
    # the kernels take each rank's local shards, never a DTensor, and
    # never fall back to their plain versions for one
    assert records["refused"] == ["flash_attention", "mamba_scan",
                                  "paged_attention"]


def _reference_fallbacks(shape, variant, arch=ARCH, cfg=None,
                         mesh_shape=(4, 2)):
    """The fallbacks the reference's rules record for ``arch``'s cell, as
    its dry-run computes them, for its config ``cfg`` (by default the
    reduced one) on an abstract mesh of ``mesh_shape``: (data, model), or
    (pod, data, model)."""
    from repro.configs import get_config, reduced
    from repro.launch import specs
    from repro.launch.dryrun import flags_for
    from repro.models import opt_flags, transformer as T
    from repro.models.config import shape_by_name
    from repro.models.model import build
    from repro.sharding import rules

    cfg = cfg or reduced(get_config(arch))
    api = build(cfg)
    cell = shape_by_name(shape)
    names = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    try:
        mesh = jax.sharding.AbstractMesh(tuple(mesh_shape), names)
    except TypeError:
        mesh = jax.sharding.AbstractMesh(tuple(zip(names, mesh_shape)))
    log = rules.RuleLog()
    with opt_flags.use_flags(**flags_for(arch, shape, variant)):
        params = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        ps = rules.param_specs(cfg, mesh, params, log)
        rules.batch_specs(cfg, mesh, specs.batch_shapes(cfg, cell), log)
        binputs = specs.input_specs(cfg, cell)
        if cell.kind == "train":
            rules.opt_state_specs(cfg, mesh, params, ps, log)
        elif cell.kind == "prefill":
            cache = jax.eval_shape(lambda p, b: api.prefill(p, b)[1],
                                   params, binputs)
            rules.cache_specs(cfg, mesh, cache, log)
        else:
            B, S = cell.global_batch, cell.seq_len
            if opt_flags.FLAGS.decode_buffered:
                R = opt_flags.FLAGS.decode_buffer_len
                cache = jax.eval_shape(
                    lambda: T.init_buffered_cache(cfg, B, S, buf_len=R))
            else:
                cache = jax.eval_shape(lambda: api.init_cache(B, S))
            rules.cache_specs(cfg, mesh, cache, log)
            rules.batch_specs(cfg, mesh, {"tokens": ((B, 1), None)}, log)
    return log.fallbacks


@pytest.mark.parametrize("shape,variant", CELLS)
def test_cell_record_ok(records, shape, variant):
    rec = records[f"{shape}/{variant}"]
    assert rec["status"] == "OK", rec
    assert set(rec) - {"wall_s"} <= REF_KEYS, set(rec) - REF_KEYS
    assert rec["n_chips"] == 8 and rec["mesh"] == "4x2"
    assert rec["cost_flops"] > 0 and rec["cost_bytes_accessed"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["roofline"]["bound_s"] > 0
    assert sorted(rec["sharding_fallbacks"]) == \
        sorted(_reference_fallbacks(shape, variant))
    if variant == "opt":
        assert rec["commit_amortized"]["amortize_over"] == 256
    if rec["kind"] == "train":   # gradients reduced over "data"
        assert rec["collective_wire_bytes"] > 0


def test_roofline_constants_are_the_h100s():
    from repro_torch.launch import cost
    assert cost.PEAK_FLOPS == 989e12 and cost.HBM_BW == 3.35e12
    assert cost.LINK_BW * cost.LINKS == 450e9
    t = cost.roofline_terms(989e12, 0.0, 0.0, 1)
    assert t["dominant"] == "compute" and abs(t["bound_s"] - 1.0) < 1e-12


def test_model_flops_equal_reference():
    from repro.configs import ARCH_IDS
    from repro.launch import roofline as j_roofline
    from repro.models.config import SHAPES
    from repro_torch.launch import roofline
    for arch in ARCH_IDS:
        for s in SHAPES:
            assert roofline.model_flops(arch, s.shape) == \
                j_roofline.model_flops(arch, s.shape), (arch, s.shape)


def test_each_kernel_is_one_op_charged_by_name_in_a_shape_only_trace():
    """Under ``FakeTensorMode`` the wrappers hand fake CPU tensors to the
    kernels' operators, not to the plain versions: ``CostMode`` sees one
    op a kernel, forward and backward, charged ``KERNEL_FLOPS``, and no
    product of a plain version; nothing launches."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.launch import cost

    B, S, H, Hkv, hd, din, N = 2, 64, 4, 2, 32, 48, 8
    counts = (fops.launch_count, fops.bwd_launch_count, sops.launch_count,
              sops.bwd_launch_count, pops.launch_count)
    with FakeTensorMode():
        e = lambda *s, **kw: torch.empty(*s, requires_grad=True, **kw)
        q, k, v = e(B, S, H, hd), e(B, S, Hkv, hd), e(B, S, Hkv, hd)
        u, dt_, Bc, Cc = e(B, S, din), e(B, S, din), e(B, S, N), e(B, S, N)
        A_log = e(din, N)
        pq, pool = torch.empty(B, H, hd), torch.empty(B, S, Hkv, hd)
        tables = torch.zeros(B, 1, dtype=torch.int32)
        lens = torch.full((B,), S, dtype=torch.int32)
        with cost.CostMode() as cm:
            o = fops.flash_attention(q, k, v, causal=True)
            y, h = sops.mamba_scan(u, dt_, Bc, Cc, A_log)
            torch.autograd.grad((o.sum(), y.sum() + h.sum()),
                                (q, k, v, u, dt_, Bc, Cc, A_log))
            out = pops.paged_attention(pq, pool, pool, tables, lens,
                                       validate=False)
    assert tuple(out.shape) == (B, H, hd)
    attn = 4.0 * B * H * S * S * hd * 0.5
    assert cm.flops == attn * 3.5 + 4.0 * B * H * S * hd
    cats = set(cm.byte_categories)
    assert {"flash_attention_lse", "flash_attention_bwd", "mamba_scan_states",
            "mamba_scan_bwd", "paged_attention"} <= cats, cats
    assert not cats & {"bmm", "mm", "matmul", "einsum", "softmax"}, cats
    assert counts == (fops.launch_count, fops.bwd_launch_count,
                      sops.launch_count, sops.bwd_launch_count,
                      pops.launch_count)


def test_sweep_summary_counts_every_record(tmp_path, monkeypatch):
    """``roofline.sweep_summary`` (the table PERF.md keeps) counts each
    mesh's and variant's records by status and gives each cell its
    per-device counts, useful share and training bytes, "= base" where
    the opt variant counted the same, and the SKIPs by reason."""
    from repro_torch.launch import roofline
    monkeypatch.setattr(roofline, "OUT_DIR", tmp_path)
    ok = {"status": "OK", "n_chips": 256, "kind": "train",
          "cost_flops": 2.0e13, "cost_bytes_accessed": 3.0e12,
          "collective_wire_bytes": 4.0e10,
          "roofline": {"dominant": "memory", "bound_s": 0.25},
          "memory_analysis": {"argument_size_in_bytes": 1.5e9,
                              "temp_size_in_bytes": 8.5e9}}
    skip = {"status": "SKIP", "reason": "why"}
    recs = {("dryrun_torch", "16x16", "train_4k"): ok,
            ("dryrun_torch_opt", "16x16", "train_4k"): ok,
            ("dryrun_torch", "16x16", "long_500k"): skip,
            ("dryrun_torch_opt", "16x16", "long_500k"): skip,
            ("dryrun_torch", "2x16x16", "long_500k"): skip,
            ("dryrun_torch_opt", "2x16x16", "long_500k"): skip,
            ("dryrun_torch", "2x16x16", "train_4k"): {"status": "FAIL"}}
    for (var, mesh, shape), rec in recs.items():
        d = tmp_path / var / mesh
        d.mkdir(parents=True, exist_ok=True)
        (d / f"olmo-1b__{shape}.json").write_text(json.dumps(rec))
    text = roofline.sweep_summary()
    lines = text.splitlines()
    assert "| 16x16 | base | 1 | 1 | 0 | 2 |" in lines
    assert "| 2x16x16 | base | 0 | 1 | 1 | 2 |" in lines
    assert "| 2x16x16 | opt | 0 | 1 | 0 | 1 |" in lines
    u = roofline.model_flops("olmo-1b", "train_4k") / 256 / 2.0e13
    row = [ln for ln in lines if ln.startswith("| olmo-1b | train_4k |")]
    assert row == [
        f"| olmo-1b | train_4k | 2.00e+13 / 3.00e+12 / 4.00e+10; memo "
        f"0.25 s; u {u:.3f}; 10.0 GB | = base | FAIL | missing |"]
    assert text.endswith("SKIP in every mesh and variant (why): "
                         "olmo-1b x long_500k.\n")

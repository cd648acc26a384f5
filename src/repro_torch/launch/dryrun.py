"""Multi-pod dry-run: per-device memory, flops, bytes and
collectives of every (architecture x input-shape x mesh) cell, in one
CPU process, with no device memory.

The port of ``repro.launch.dryrun``.  A shape-only tool, as the
reference's: it allocates no device memory and runs on a machine with
no card, the one exception to the port's card-by-default entry points.
For each cell it starts a ``"fake"`` process group of the mesh's 256 or
512 ranks (``torch.testing._internal.distributed.fake_pg``: collectives
return at once, this process plays rank 0), builds the production
``DeviceMesh`` on it, and under ``FakeTensorMode`` (tensors with shapes
and dtypes and no storage) makes the state (``abstract_train_state``)
or params and batch (``input_specs``), places them by the sharding
rules as DTensors, and runs the step once: the train step (with the
reference's ``TRAIN_KNOBS``), the prefill, or one decode step (under
``--variant opt`` the reference's ``flags_for``, the buffered decode
with ``commit_buffer`` amortised over its R steps).  ``cost.CostMode``
counts rank 0's local ops as they run: its flops, bytes and
collectives, and the peak of the tensors they made.  The kernels' call
sites hand their wrappers fake tensors, which go to the kernels'
operators: each kernel is one op, charged by ``cost.KERNEL_FLOPS``.

A host read on the step's path (``.item()``, ``.numpy()``, a value
check) cannot run on fake tensors: the cell records ``FAIL`` with the
reason, as the reference records a failed lowering.  Records go to
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json`` (``--variant
opt``: ``dryrun_torch_opt``), with the reference's keys where they mean
something in torch; existing records are skipped unless ``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
      [--shape S] [--mesh single|multi|both] [--variant base|opt]
      [--force] [--list]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cost, specs as specs_lib
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as L, opt_flags, transformer as T_lib
from repro_torch.models.config import SHAPES, cell_applicable
from repro_torch.models.model import build
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding import rules
from repro_torch.training import optim, step as step_lib

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESHES = {False: ("16x16", (16, 16)), True: ("2x16x16", (2, 16, 16))}


def flags_for(arch: str, shape: str, variant: str) -> dict:
    """Per-cell optimization flags for the 'opt' variant."""
    if variant != "opt":
        return {}
    cfg = get_config(arch)
    cell = [s for s in SHAPES if s.shape == shape][0]
    f = {}
    if cell.kind == "decode":
        f["decode_shard_scores"] = True
        if cfg.family in ("dense", "vlm", "moe"):
            f["decode_buffered"] = True
    if cfg.family == "ssm" and cell.kind in ("train", "prefill"):
        f["mamba_seq_scan"] = True
    if arch == "kimi-k2-1t-a32b" and cell.kind == "train":
        f["moe_local_dispatch"] = True
    return f


# per-arch training knobs (microbatches, moment dtype) chosen for HBM
TRAIN_KNOBS = {
    "kimi-k2-1t-a32b": dict(microbatches=8, moment_dtype="bfloat16"),
    "phi3-medium-14b": dict(microbatches=4, moment_dtype="float32"),
    "granite-3-8b": dict(microbatches=4, moment_dtype="float32"),
    "llava-next-mistral-7b": dict(microbatches=4, moment_dtype="float32"),
    "chatglm3-6b": dict(microbatches=4, moment_dtype="float32"),
    "falcon-mamba-7b": dict(microbatches=4, moment_dtype="float32"),
    "zamba2-2.7b": dict(microbatches=2, moment_dtype="float32"),
}


def fake_process_group(world: int) -> None:
    """Start a ``"fake"`` process group of ``world`` ranks in this
    process (rank 0), after tearing down any group already started."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            out.append(cost.nbytes(t.to_local() if dt.is_dtensor(t) else t))
    walk(tree)
    return sum(out)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "base", cfg=None, mesh_shape=None):
    """The record of one cell, on the fake process group already
    started (``fake_process_group``) with the mesh's ranks.  ``cfg`` and
    ``mesh_shape`` replace the arch's config and the production mesh
    (tests run a reduced config on a small mesh): ``(data, model)``, or
    ``(pod, data, model)`` for the multi-pod mesh's three axes."""
    cfg = cfg or get_config(arch)
    cell = [s for s in SHAPES if s.shape == shape_name][0]
    skip = cell_applicable(cfg, cell)
    if skip:
        return {"status": "SKIP", "reason": skip}
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mesh_name = MESHES[multi_pod][0]
    else:
        *pod, data, model = mesh_shape
        mesh = make_host_mesh(data, model, device_type="cpu",
                              pod=pod[0] if pod else None)
        mesh_name = "x".join(str(n) for n in mesh_shape)
    L.clear_device_caches()
    try:
        with opt_flags.use_flags(**flags_for(arch, shape_name, variant)):
            return _lower_cell_inner(cfg, cell, mesh, mesh_name, arch,
                                     shape_name, variant)
    finally:
        L.clear_device_caches()


def _lower_cell_inner(cfg, cell, mesh, mesh_name, arch, shape_name,
                      variant):
    from torch._subclasses.fake_tensor import FakeTensorMode
    api = build(cfg)
    log = rules.RuleLog()
    t0 = time.time()
    fake = FakeTensorMode()
    commit_extra = None
    with fake, dt.implicit(), torch.no_grad():
        bshapes = specs_lib.batch_shapes(cfg, cell)
        bspecs = rules.batch_specs(cfg, mesh, bshapes, log)
        binputs = specs_lib.input_specs(cfg, cell, fake)
        if cell.kind == "train":
            knobs = TRAIN_KNOBS.get(arch, dict(microbatches=1,
                                               moment_dtype="float32"))
            oc = optim.AdamWConfig(moment_dtype=knobs["moment_dtype"])
            rc = step_lib.RunConfig(microbatches=knobs["microbatches"],
                                    adamw=oc)
            state = step_lib.abstract_train_state(api, oc, fake)
            sspec = step_lib.state_specs(cfg, mesh, state.params, log)
            args = (rules.distribute(state, mesh, sspec),
                    rules.distribute(binputs, mesh, bspecs))
            del state
            run = step_lib.make_train_step(api, rc)
        else:
            params = step_lib.abstract_train_state(
                api, optim.AdamWConfig(), fake).params
            pspecs = rules.param_specs(cfg, mesh, params, log)
            if cell.kind == "prefill":
                run = step_lib.make_prefill_step(api)
                # the cache's rules (the reference's out_shardings of the
                # prefill), on its shapes: those of a cache of seq_len
                rules.cache_specs(cfg, mesh, api.init_cache(
                    cell.global_batch, cell.seq_len, device="cpu"), log)
                args = (rules.distribute(params, mesh, pspecs),
                        rules.distribute(binputs, mesh, bspecs))
            else:  # decode: one token against a seq_len-sized cache
                B, S = cell.global_batch, cell.seq_len
                buffered = (opt_flags.FLAGS.decode_buffered
                            and cfg.family in ("dense", "vlm", "moe"))
                if buffered:
                    R = opt_flags.FLAGS.decode_buffer_len
                    cache = T_lib.init_buffered_cache(cfg, B, S, buf_len=R,
                                                      device="cpu")
                    run = lambda p, t, c: T_lib.forward_decode_buffered(
                        cfg, p, t, c)
                else:
                    cache = api.init_cache(B, S, device="cpu")
                    run = step_lib.make_decode_step(api)
                cspecs = rules.cache_specs(cfg, mesh, cache, log)
                tok_spec = rules.batch_specs(
                    cfg, mesh, {"tokens": ((B, 1), torch.int32)},
                    log)["tokens"]
                dcache = rules.distribute(cache, mesh, cspecs)
                if buffered:  # the state the decode steps start from
                    dcache = dcache._replace(base_len=S - R)
                elif hasattr(dcache, "length"):
                    dcache = dcache._replace(length=S - 1)
                del cache
                args = (rules.distribute(params, mesh, pspecs),
                        rules.distribute(binputs["tokens"], mesh, tok_spec),
                        dcache)
        arg_bytes = _local_bytes(args)
        with cost.CostMode() as cm:
            out = run(*args)
        out_bytes = _local_bytes(out)
        del out
        if cell.kind == "decode" and buffered:
            # the amortised ring -> base flush, every R steps
            flush = dcache._replace(base_len=S - R, buf_len=R)
            with cost.CostMode() as cc:
                T_lib.commit_buffer(cfg, flush)
            commit_extra = {
                "flops": cc.flops, "hbm_bytes": cc.hbm_bytes,
                "collective_wire_bytes": cc.wire_bytes,
                "amortize_over": R}
    t_lower = time.time() - t0

    n_chips = mesh.size()
    la = cm.totals()
    flops, bytes_acc = la["flops"], la["hbm_bytes"]
    wire = la["collective_wire_bytes"]
    if commit_extra is not None:  # fold in the amortised commit cost
        R = commit_extra["amortize_over"]
        flops += commit_extra["flops"] / R
        bytes_acc += commit_extra["hbm_bytes"] / R
        wire += commit_extra["collective_wire_bytes"] / R
    terms = cost.roofline_terms(flops, bytes_acc, wire, n_chips)
    return {
        "status": "OK",
        "arch": arch, "shape": shape_name,
        "variant": variant,
        "commit_amortized": commit_extra,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "kind": cell.kind,
        "lower_s": round(t_lower, 1),
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "output_size_in_bytes": out_bytes,
                            "temp_size_in_bytes": la["peak_bytes"]},
        "cost_flops": flops,
        "cost_bytes_accessed": bytes_acc,
        "collectives": la["collectives"],
        "collective_wire_bytes": wire,
        "byte_categories": la["byte_categories"],
        "roofline": terms,
        "sharding_fallbacks": log.fallbacks,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="base", choices=["base", "opt"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.shape for s in SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    if args.list:
        for c in cells:
            print(c)
        return

    import torch.distributed as dist
    world = None
    try:
        for arch, shape_name, multi in cells:
            root = OUT_DIR if args.variant == "base" else \
                OUT_DIR.parent / "dryrun_torch_opt"
            mname, mshape = MESHES[multi]
            mdir = root / mname
            mdir.mkdir(parents=True, exist_ok=True)
            out = mdir / f"{arch}__{shape_name}.json"
            if out.exists() and not args.force:
                print(f"[skip-cached] {out.name} ({mname})")
                continue
            n = 1
            for d in mshape:
                n *= d
            if world != n:
                fake_process_group(n)
                world = n
            label = f"{arch} x {shape_name} x {mname}"
            print(f"[dryrun] {label} ...", flush=True)
            t0 = time.time()
            try:
                rec = lower_cell(arch, shape_name, multi,
                                 variant=args.variant)
            except Exception as e:  # noqa: BLE001 — record, keep going
                rec = {"status": "FAIL", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            rec["wall_s"] = round(time.time() - t0, 1)
            out.write_text(json.dumps(rec, indent=1, default=str))
            status = rec["status"]
            extra = ""
            if status == "OK":
                r = rec["roofline"]
                extra = (f" flops={rec['cost_flops']:.3e}"
                         f" dom={r['dominant']} bound={r['bound_s']:.4f}s")
            elif status == "FAIL":
                extra = " " + rec["error"][:200]
            print(f"[{status}] {label}{extra} ({rec['wall_s']}s)",
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

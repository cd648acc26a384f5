#!/usr/bin/env python3
"""Check and time the bf16 scan's kernels (the ``mamba_bf16_scan`` path).

    python3 tools/scan_bf16_probe.py [--main] [--sass] [--sass-of DIR]
        [--previous DIR ...] [--pairs K]

Builds ``mamba_scan.cu``, ``mamba_scan_bwd.cu`` and ``mamba_scan_bf16.cu``,
prints ptxas' register and spill lines of the bf16 forward and of the
backward's bf16 variants, then runs ``chip_smoke.py``'s
``scan_bf16_vs_plain`` (the forward and backward kernels under the flag
against their plain versions, the planted faults, the times) and, with
``--main``, ``ssm_bf16_main``
(falcon-mamba-7b at full width cut to 8 layers under the flag: prefill,
decode, training steps, the card against the CPU): one JSON line each.

With ``--sass`` it first counts SASS a state-step at falcon-mamba's types
(bf16 u, fp32 dt, N 16; ``tools/sass_loop_count.py``, grouped by unit:
MUFU, conversions, HFMA2, FP32, INT, LDS/STS, SHFL, other): the bf16
forward's group loop (no states; one exponential a state-step) and the
backward's kBf16 variant's first-pass and walk sub-chunk loops (the walk:
recompute, walk back and column sums; 4 steps x 8 states a thread each),
with the exponentials a state-step.  Each is
counted on a copy of the source (``build/scan_probe/``, built, never
launched) in which the forward's per-step walk, which only a ragged
group takes, is cut (``SASS_EDITS``), so the loop holds the path every
whole group runs.  ``--sass-of DIR`` also counts DIR's sources (a
checkout of an earlier commit, e.g. ``git archive`` under ``build/``) the
same way, before this tree's.

``--previous DIR`` (repeatable) runs ``chip_smoke.py``'s
``scan_previous`` against each checkout DIR: its fp32 and bf16 scans
timed beside these and every output held bit for bit.  With ``--pairs
K`` it then times the two trees' bf16 forward and backward at those
shapes in K alternating pairs (DIR first in odd pairs, this tree first
in even ones), each a CUDA-event median of 10 (forward) or 5 (backward)
calls with the L2 emptied before each call.
Exits non-zero on a mismatch or without a card.  A quick loop for work on
the bf16 scan.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
FWD_NAME = "mamba_scan_bf16_kernelI13__nv_bfloat16fLb0E"
BWD_NAME = "mamba_scan_bwd_kernelI13__nv_bfloat16fLi16ELb0ELi2ELb1E"
# The copies' edits (present text, copy's), each made where the text is
# found: every group takes the whole-group path (this tree's condition,
# then the earlier one-pair kernel's).
SASS_EDITS = (
    ("      if ((w.cnt & (kGroup - 1)) == 0 && w.cnt + kGroup <= chunk &&\n"
     "          (gn == kGroup || aligned)) {\n", "      if (true) {\n"),
    ("      if (gn == kGroup && (w.cnt & (kGroup - 1)) == 0 &&\n"
     "          w.cnt + kGroup <= chunk) {\n", "      if (true) {\n"),
)
# SASS opcodes (the part before the first dot) by the unit that runs them
UNITS = dict(
    MUFU=("MUFU",),
    conversions=("F2F", "F2FP", "F2I", "I2F", "I2FP", "FRND"),
    HFMA2=("HFMA2", "HMUL2", "HADD2", "HMNMX2", "HSETP2"),
    FP32=("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET"),
    INT=("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "LEA", "ISETP", "SEL",
         "PRMT", "IABS", "IMNMX", "VIMNMX", "FLO", "POPC", "PLOP3", "P2R",
         "R2P", "MOV", "UMOV", "IMUL", "VIADD"),
    **{"LDS/STS": ("LDS", "STS")},
    SHFL=("SHFL",))


def by_unit(opcodes: dict, per: int) -> dict:
    """``opcodes`` ({opcode: count}) summed by ``UNITS``, each over
    ``per`` (the exponentials of the loop)."""
    unit = {op: u for u, ops in UNITS.items() for op in ops}
    out = collections.Counter()
    for op, n in opcodes.items():
        out[unit.get(op.split(".")[0], "other")] += n
    return {u: out[u] / per for u in (*UNITS, "other")}


def _copy(source: pathlib.Path, tag: str) -> pathlib.Path:
    """``source`` and its ``scan.cuh`` with ``SASS_EDITS`` made, written
    under ``build/scan_probe/`` (the source's other quoted includes made
    absolute)."""
    out = pathlib.Path(ROOT, "build", "scan_probe")
    out.mkdir(parents=True, exist_ok=True)
    for f in (source, source.with_name("scan.cuh")):
        text = f.read_text()
        for old, new in SASS_EDITS:
            text = text.replace(old, new)
        text = text.replace('#include "scan.cuh"', f'#include "{tag}_scan.cuh"')
        text = text.replace('#include "../', f'#include "{source.parent}/../')
        (out / f"{tag}_{f.name}").write_text(text)
    return out / f"{tag}_{source.name}"


def sass_counts(tree: str) -> list:
    """The counts of the module docstring for the sources of ``tree``,
    one dict each."""
    from repro_torch.kernels import build

    csrc = pathlib.Path(os.path.abspath(tree), "src", "repro_torch",
                        "kernels", "mamba_scan", "csrc")
    tag = hashlib.sha1(os.path.abspath(tree).encode()).hexdigest()[:8]
    libs = {k: (f"scan_probe_{k}_{tag}", _copy(csrc / src, tag))
            for k, src in (("fwd", "mamba_scan_bf16.cu"),
                           ("bwd", "mamba_scan_bwd.cu"))}
    build.build_many(list(libs.values()))
    tool = os.path.join(ROOT, "tools", "sass_loop_count.py")
    out = []
    # (what, library, kernel, the op that picks the loop, its state-steps
    # a thread: the forward's group one an exponential, the backward's
    # sub-chunk 4 steps x 8 states)
    for what, k, name, op, steps in (
            ("forward group", "fwd", FWD_NAME, "MUFU.EX2", None),
            ("backward first-pass sub-chunk", "bwd", BWD_NAME, "MUFU.EX2", 32),
            ("backward walk sub-chunk (recompute, walk, column sums)", "bwd",
             BWD_NAME, "SHFL.BFLY", 32)):
        run = subprocess.run(
            [sys.executable, tool, str(build._target(*libs[k])), name,
             "--op", op], capture_output=True, text=True)
        if run.returncode != 0:
            out.append(dict(sass=what, tree=tree, error=run.stderr[-2000:]))
            continue
        rec = json.loads(run.stdout)
        exps = collections.Counter(rec["opcodes"]).get("MUFU.EX2", 0)
        state_steps = steps or exps
        out.append(dict(
            sass=what, tree=tree, loop=rec["loop"],
            instructions=rec["instructions"], state_steps=state_steps,
            exponentials_per_state_step=exps / state_steps,
            per_state_step=rec["instructions"] / state_steps,
            per_exponential=rec["instructions"] / exps,
            by_unit=by_unit(rec["opcodes"], state_steps),
            opcodes=rec["opcodes"],
            ptxas=build.info(libs[k][0]).get("ptxas")))
    return out


def alternating_pairs(cs, dev, tree: str, pairs: int) -> dict:
    """``tree``'s bf16 forward (at ``SCAN_MAIN``) and backward (at
    ``SCAN_TRAIN_SHAPE``, from each tree's own states) beside this tree's,
    C ``SCAN_BF16_CHUNK``, bf16 u/B/C/dy, fp32 dt: ``pairs`` pairs of
    medians, ``tree`` first in odd pairs and this tree first in even
    ones."""
    from repro_torch.kernels.mamba_scan import ops

    old = cs.previous_scan_ops(tree)
    trees = dict(previous=old, present=ops)
    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    C = cs.SCAN_BF16_CHUNK
    rec = dict(phase="scan_bf16_pairs", tree=tree, pairs=pairs)
    for what, shape, reps in (("fwd", cs.SCAN_MAIN, 10),
                              ("bwd", cs.SCAN_TRAIN_SHAPE, 5)):
        ins = cs.scan_inputs_on(dev, shape, torch.bfloat16, gen,
                                R=cs.SCAN_DT_RANK)
        if what == "fwd":
            fns = {k: (lambda m=m: m.mamba_scan(*ins, C))
                   for k, m in trees.items()}
        else:
            dy = torch.randn(ins[0].shape, generator=gen, device=dev).to(
                torch.bfloat16)
            st = {k: m.mamba_scan_fwd(*ins, C)[2] for k, m in trees.items()}
            fns = {k: (lambda m=m, s=st[k]: m.mamba_scan_bwd(*ins, s, dy,
                                                             None, C))
                   for k, m in trees.items()}
        ms = {k: [] for k in trees}
        for i in range(pairs):
            for k in (("previous", "present") if i % 2 == 0
                      else ("present", "previous")):
                ms[k].append(statistics.median(cs.warm_ms(fns[k], flush,
                                                          reps)))
        diff = [b - a for a, b in zip(ms["present"], ms["previous"])]
        rec[what] = dict(shape=shape, previous_ms=ms["previous"],
                         ms=ms["present"],
                         previous_median=statistics.median(ms["previous"]),
                         median=statistics.median(ms["present"]),
                         previous_minus_present=diff,
                         present_faster_in=sum(d > 0 for d in diff))
        del ins, fns
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--main", action="store_true",
                    help="also run ssm_bf16_main")
    ap.add_argument("--sass", action="store_true",
                    help="count the bf16 kernels' SASS a state-step first")
    ap.add_argument("--sass-of", metavar="DIR",
                    help="with --sass, also count DIR's sources, first")
    ap.add_argument("--previous", metavar="DIR", action="append",
                    default=[], help="time and hold the scans of checkout "
                    "DIR beside these (repeatable)")
    ap.add_argument("--pairs", type=int, default=0,
                    help="with --previous, also time the bf16 kernels in "
                         "this many alternating pairs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", 0)
    # this tree's sources last: build.info keeps a name's last build
    build.build_many([(k, pathlib.Path(cs._kernel_dir(tree), "mamba_scan",
                                       "csrc", f"{k}.cu"))
                      for tree in args.previous
                      for k in ("mamba_scan", "mamba_scan_bwd",
                                "mamba_scan_bf16")]
                     + [("mamba_scan", ops.SOURCE),
                        ("mamba_scan_bwd", ops.BWD_SOURCE),
                        ("mamba_scan_bf16", ops.BF16_SOURCE)])
    print(json.dumps(dict(
        phase="build", device=torch.cuda.get_device_name(0),
        mamba_scan_bf16=build.info("mamba_scan_bf16"),
        mamba_scan_bwd_bf16=cs.ptxas_entries(
            build.info("mamba_scan_bwd").get("ptxas", []), "Lb1EEEvPKf"),
        mamba_scan_bwd_seconds=build.info("mamba_scan_bwd").get("seconds"))),
        flush=True)
    if args.sass:
        for tree in ([args.sass_of] if args.sass_of else []) + [ROOT]:
            for rec in sass_counts(tree):
                print(json.dumps(rec), flush=True)
    for tree in args.previous:
        cs.emit(cs.scan_previous(dev, tree))
        if args.pairs:
            cs.emit(alternating_pairs(cs, dev, tree, args.pairs))
    cs.emit(cs.scan_bf16_vs_plain(dev))
    if args.main:
        cs.emit(cs.ssm_bf16_main(dev)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Check and time the selective scan's backward kernel alone.

    python3 tools/scan_bwd_probe.py [--quick] [--train] [--sass]

Builds ``mamba_scan.cu`` and ``mamba_scan_bwd.cu``, prints ptxas'
register and spill lines of both, then runs ``chip_smoke.py``'s
``scan_bwd_vs_plain`` (the forward's states against the plain
``chunk_states``, the five gradients against the plain backward, two
calls bit-equal, the planted faults) and, without ``--quick``, its
``scan_bwd_time``: one JSON line each.  With ``--train`` it then runs
the ssm training phases too (``ssm_train_main``, ``ssm_bf16_grad``,
``train_consistency``).  With ``--sass`` it counts SASS at falcon-mamba's
N 16 (``tools/sass_loop_count.py``): the walk's step of 8 states, on a
copy of the source whose walk is a loop (``WALK_LOOP``: the kernel
unrolls the walk's steps, so its walk is no loop of its own; the copy is
only built, never launched), and the kernel's loops over a sub-chunk of
the walk (recompute, walk, column sums) and of the first pass; it writes
the kernel's SASS to ``build/scan_probe/scan_bwd.sass``.  Exits non-zero
on a mismatch or without a card.  A quick loop for work on the backward
kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
SASS_NAME = "bwd_kernelI13__nv_bfloat16fLi16ELb1ELi2ELb0E"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# The walk's steps as a loop, for counting its SASS: (present text, copy's).
WALK_LOOP = ("#pragma unroll\n      for (int j = kSub - 1; j > 0; --j) {\n"
             "        if (j >= ss) continue;\n",
             "#pragma unroll 1\n      for (int j = ss - 1; j > 0; --j) {\n")


def _walk_loop(source: pathlib.Path) -> pathlib.Path:
    """``source`` with ``WALK_LOOP``'s edit, its quoted includes made
    absolute, written under ``build/scan_probe/``."""
    text = source.read_text()
    if text.count(WALK_LOOP[0]) != 1:
        raise SystemExit("--sass: the walk's loop has changed; update "
                         "WALK_LOOP")
    text = text.replace(WALK_LOOP[0], WALK_LOOP[1])
    text = text.replace('#include "', f'#include "{source.parent}/')
    out = pathlib.Path(ROOT, "build", "scan_probe", "bwd_walk_loop.cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def sass_count(lib: str) -> None:
    """The SASS counts of the module docstring, one JSON line each."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ops

    loop = ("mamba_scan_bwd_walk_loop", _walk_loop(ops.BWD_SOURCE))
    build.build_many([loop])
    tool = os.path.join(ROOT, "tools", "sass_loop_count.py")
    for what, path, op in (
            ("walk step (WALK_LOOP copy)", build._target(*loop),
             "SHFL.BFLY"),
            ("walk sub-chunk", lib, "SHFL.BFLY"),
            ("first-pass sub-chunk", lib, "MUFU.EX2")):
        out = subprocess.run([sys.executable, tool, str(path), SASS_NAME,
                              "--op", op], capture_output=True, text=True,
                             check=True).stdout
        print(json.dumps(dict(sass=what, **json.loads(out))), flush=True)
    out = pathlib.Path(ROOT, "build", "scan_probe", "scan_bwd.sass")
    out.parent.mkdir(parents=True, exist_ok=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    keep, on = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            on = SASS_NAME in ln
        if on:
            keep.append(ln)
    out.write_text("\n".join(keep) + "\n")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ops

    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.set_grad_enabled(False)
    build.build_many([("mamba_scan", ops.SOURCE),
                      ("mamba_scan_bwd", ops.BWD_SOURCE)])
    print(json.dumps(dict(ptxas={k: build.info(k) for k in (
        "mamba_scan", "mamba_scan_bwd")})), flush=True)
    if "--sass" in argv:
        sass_count(str(build._target("mamba_scan_bwd", ops.BWD_SOURCE)))
    dev = torch.device("cuda", 0)
    print(json.dumps(cs.scan_bwd_vs_plain(dev)), flush=True)
    if "--quick" not in argv:
        print(json.dumps(cs.scan_bwd_time(dev)), flush=True)
    if "--train" in argv:
        print(json.dumps(cs.ssm_train_main(dev)[0]), flush=True)
        print(json.dumps(cs.ssm_bf16_grad(dev)), flush=True)
        print(json.dumps(cs.train_consistency(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

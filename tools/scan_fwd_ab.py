#!/usr/bin/env python3
"""Compare the scan's forward kernel of several sources: the code of its
inference kernel (without states) and the times with and without states.

    python3 tools/scan_fwd_ab.py SRC [SRC ...] [--diff-dir DIR]   # on a card

Each SRC is a ``mamba_scan.cu`` or a checkout whose
``src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu`` is taken; the
first is the baseline.  Builds each as its own library (one ``nvcc``
each, all at once), and for the kernel the serving paths launch
(bf16 u/B/C, fp32 dt, N 16: ``mamba_scan_kernel<__nv_bfloat16, float,
16, true, 2, false>``) prints ptxas' register and spill lines, its SASS
length, the address of its step loop (``tools/sass_loop_count.py``), and
how many SASS lines differ from the baseline's, addresses stripped; with
``--diff-dir`` the diffs are written there.  Then it launches each
library's C entry point alone at ``chip_smoke.SCAN_MAIN`` (falcon-mamba's
prefill, bf16 u/B/C as views of x_proj's output, fp32 dt): CUDA-event
medians of 20, the L2 emptied by a 1 GiB read before each launch, the
sources in turn and then in reverse, and checks that every y and h_last
equals the baseline's bit for bit; then the same with the states output
(``states_ms``; a buffer for a state every ``STATE_CHUNK`` steps, which
holds a source's fewer states too).  One JSON line a source.  Exits
non-zero on a mismatch or without a card.
"""

from __future__ import annotations

import ctypes
import difflib
import importlib.util
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
KERNEL = "mamba_scan_kernelI13__nv_bfloat16fLi16ELb1ELi2ELb0E"
IN_TREE = pathlib.Path("src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu")


def source_of(arg: str) -> pathlib.Path:
    p = pathlib.Path(arg).resolve()
    return p / IN_TREE if p.is_dir() else p


def kernel_sass(lib: pathlib.Path) -> tuple:
    """(mangled name, [SASS lines without their addresses]) of KERNEL."""
    import sass_loop_count as slc

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    code = slc.functions(sass)
    name = next(k for k in code if KERNEL in k)
    return name, code[name], [f"{op}{args}" for _, op, args in code[name]]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("scan_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ops

    import sass_loop_count as slc

    diff_dir = None
    if "--diff-dir" in argv:
        i = argv.index("--diff-dir")
        diff_dir = pathlib.Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    srcs = [source_of(a) for a in argv]
    if not srcs:
        print(__doc__, file=sys.stderr)
        return 2
    libs = [(f"mamba_scan_ab{i}", s) for i, s in enumerate(srcs)]
    build.build_many(libs)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.set_grad_enabled(False)

    recs = []
    for i, (name, src) in enumerate(libs):
        target = build._target(name, src)
        fn, code, lines = kernel_sass(target)
        lo, _, body = slc.hottest_loop(code, "MUFU.EX2")
        ptxas = build.info(name).get("ptxas", [])
        at = next((j for j, ln in enumerate(ptxas)
                   if KERNEL in ln and "Compiling" in ln), None)
        recs.append(dict(source=str(src), function=fn,
                         ptxas=[] if at is None else ptxas[at + 1:at + 3],
                         sass_lines=len(lines), loop_start=hex(lo),
                         loop_instructions=len(body), lines=lines))
    base = recs[0]["lines"]
    for i, r in enumerate(recs):
        diff = list(difflib.unified_diff(base, r["lines"], "baseline",
                                         f"source {i}", lineterm="", n=2))
        r["sass_lines_differing"] = sum(
            1 for ln in diff if ln[:1] in "+-" and ln[:3] not in ("+++",
                                                                 "---"))
        # the same code placed elsewhere differs only in branch targets
        strip = lambda xs: [re.sub(r"0x[0-9a-f]+", "ADDR", x)
                            if x.startswith(("BRA", "BSSY", "CALL")) else x
                            for x in xs]
        r["sass_equal_but_targets"] = strip(base) == strip(r["lines"])
        if diff_dir is not None and diff:
            diff_dir.mkdir(parents=True, exist_ok=True)
            (diff_dir / f"source{i}.diff").write_text("\n".join(diff) + "\n")

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    u, dt, Bc, Cc, A = cs.scan_inputs(dev, cs.SCAN_MAIN, torch.bfloat16,
                                      np.random.default_rng(3),
                                      R=cs.SCAN_DT_RANK)
    B, S, din = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    h = torch.empty((B, din, N), dtype=torch.float32, device=dev)
    strides = ops._strides(u, dt, Bc, Cc)
    loaded = [build.load(name, src, ops.SYMBOLS) for name, src in libs]

    st = torch.empty((B, -(-S // ops.STATE_CHUNK), din, N),
                     dtype=torch.float32, device=dev)

    def run(lib, states=None):
        err = lib.mamba_scan_launch(
            u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(), states, strides, B, S,
            din, N, ops.DTYPES[u.dtype], ops.DTYPES[dt.dtype], stream)
        if err != 0:
            raise RuntimeError(f"mamba_scan_launch: CUDA error {err}")

    flush = torch.empty(256 << 20, dtype=torch.float32, device=dev)
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    ms = [[] for _ in libs]
    states_ms = [[] for _ in libs]
    for out, states in ((ms, None), (states_ms, st.data_ptr())):
        for i in order:
            out[i].append(statistics.median(
                cs.warm_ms(lambda: run(loaded[i], states), flush, 20)))
    outs = []
    for lib in loaded:
        run(lib)
        outs.append((y.clone(), h.clone()))
    ok = True
    for i, r in enumerate(recs):
        del r["lines"]
        r.update(ms=ms[i], states_ms=states_ms[i], order=order,
                 bit_equal=all(torch.equal(a, b)
                               for a, b in zip(outs[i], outs[0])),
                 shape=f"bf16 u/B/C (views of x_proj's output), fp32 dt, "
                       f"(B, S, din, N) = {cs.SCAN_MAIN}")
        ok &= r["bit_equal"]
        print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Check and time the bf16 scan's kernels (the ``mamba_bf16_scan`` path).

    python3 tools/scan_bf16_probe.py [--main] [--sass]

Builds ``mamba_scan.cu``, ``mamba_scan_bwd.cu`` and ``mamba_scan_bf16.cu``,
prints ptxas' register and spill lines of the bf16 forward and of the
backward's bf16 variants, then runs ``chip_smoke.py``'s
``scan_bf16_vs_plain`` (the forward and backward kernels under the flag
against their plain versions, the planted faults, the times) and, with
``--main``, ``ssm_bf16_main`` (falcon-mamba-7b at full width cut to 8
layers under the flag: prefill, decode, training steps, the card against
the CPU): one JSON line each.  With ``--sass`` it first counts the SASS
of the bf16 forward's hottest loop at falcon-mamba's types (bf16 u, fp32
dt, no states; ``tools/sass_loop_count.py``, per exponential).
Exits non-zero on a mismatch or without a card.  A quick loop for work on
the bf16 scan.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
SASS_NAME = "mamba_scan_bf16_kernelI13__nv_bfloat16fLb0E"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--main", action="store_true",
                    help="also run ssm_bf16_main")
    ap.add_argument("--sass", action="store_true",
                    help="count the bf16 forward's loop SASS first")
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
    build.build_many([("mamba_scan", ops.SOURCE),
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
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "sass_loop_count.py"),
             str(build._target("mamba_scan_bf16", ops.BF16_SOURCE)),
             SASS_NAME, "--op", "MUFU.EX2"],
            capture_output=True, text=True, check=True).stdout
        print(json.dumps(dict(sass="bf16 forward loop", **json.loads(out))),
              flush=True)
    cs.emit(cs.scan_bf16_vs_plain(dev))
    if args.main:
        cs.emit(cs.ssm_bf16_main(dev)[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

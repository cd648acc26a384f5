#!/usr/bin/env python3
"""Check and time the selective scan's backward kernel alone.

    python3 tools/scan_bwd_probe.py [--quick] [--train]   # on a CUDA card

Builds ``mamba_scan.cu`` and ``mamba_scan_bwd.cu``, prints ptxas'
register and spill lines of both, then runs ``chip_smoke.py``'s
``scan_bwd_vs_plain`` (the forward's states against the plain
``chunk_states``, the five gradients against the plain backward, two
calls bit-equal, the planted faults) and, without ``--quick``, its
``scan_bwd_time``: one JSON line each.  With ``--train`` it then runs
the ssm training phases too (``ssm_train_main``, ``ssm_bf16_grad``,
``train_consistency``).  Exits non-zero on a mismatch or without a card.
A quick loop for work on the backward kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(quick: bool, train: bool) -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ops

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.set_grad_enabled(False)
    build.build_many([("mamba_scan", ops.SOURCE),
                      ("mamba_scan_bwd", ops.BWD_SOURCE)])
    print(json.dumps(dict(ptxas={k: build.info(k) for k in (
        "mamba_scan", "mamba_scan_bwd")})), flush=True)
    dev = torch.device("cuda", 0)
    print(json.dumps(cs.scan_bwd_vs_plain(dev)), flush=True)
    if not quick:
        print(json.dumps(cs.scan_bwd_time(dev)), flush=True)
    if train:
        print(json.dumps(cs.ssm_train_main(dev)[0]), flush=True)
        print(json.dumps(cs.ssm_bf16_grad(dev)), flush=True)
        print(json.dumps(cs.train_consistency(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main("--quick" in sys.argv[1:], "--train" in sys.argv[1:]))

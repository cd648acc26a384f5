#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel alone.

    python3 tools/flash_bwd_probe.py [--quick]   # on a CUDA card

Builds ``flash_attention.cu`` and ``flash_attention_bwd.cu``, prints
ptxas' register and spill lines of the backward, then runs
``chip_smoke.py``'s ``flash_bwd_vs_plain`` (the forward's out and lse
against the plain forward, dq, dk, dv against the plain backward, the
planted faults) and, without ``--quick``, its ``flash_bwd_time``: one
JSON line each.  Exits non-zero on a mismatch or without a card.  A
quick loop for work on the backward kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(quick: bool) -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.set_grad_enabled(False)
    build.build_many([("flash_attention", ops.SOURCE),
                      ("flash_attention_bwd", ops.BWD_SOURCE)])
    print(json.dumps(dict(ptxas=build.info("flash_attention_bwd"))),
          flush=True)
    dev = torch.device("cuda", 0)
    print(json.dumps(cs.flash_bwd_vs_plain(dev)), flush=True)
    if not quick:
        print(json.dumps(cs.flash_bwd_time(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main("--quick" in sys.argv[1:]))

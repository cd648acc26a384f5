#!/usr/bin/env python3
"""Check and time the flash-attention backward kernel alone.

    python3 tools/flash_bwd_probe.py [--quick] [--profile]   # on a CUDA card

Builds ``flash_attention.cu`` and ``flash_attention_bwd.cu``, prints
ptxas' register and spill lines of both (the backward's tensor-core
kernels ``dkdv_kernel_sm90`` and ``dq_kernel_sm90`` among them), then runs
``chip_smoke.py``'s ``flash_bwd_vs_plain`` (the forward's out and lse
against the plain forward, dq, dk, dv against the plain backward, the
planted faults) and, without ``--quick``, its ``flash_bwd_time``: one
JSON line each.  With ``--profile``, only the backward at
``chip_smoke.FLASH_TRAIN_SHAPE`` (bf16, causal) under ``torch.profiler``:
the device ms of each of its kernels (D, dK/dV, dQ) per call, and each
one's share.  Exits non-zero on a mismatch or without a card.  A quick
loop for work on the backward kernel.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def profile(cs, dev, calls: int = 10) -> dict:
    """Device ms per call of each kernel of ``calls`` backward calls at
    train_main's attention shape (one warm-up call first)."""
    import numpy as np
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.kernels.flash_attention import ops

    B, S, H, Hkv, hd = cs.FLASH_TRAIN_SHAPE
    rng = np.random.default_rng(24)
    g = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dev, torch.bfloat16)
    q, k, v, do = g(B, S, H, hd), g(B, S, Hkv, hd), g(B, S, Hkv, hd), \
        g(B, S, H, hd)
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if "flash_bwd" in e.key and t > 0:
            ms[e.key] = t / 1e3 / calls
    total = sum(ms.values())
    return dict(phase="flash_bwd_profile", shape=f"bf16, B={B}, S={S}, "
                f"H={H}, Hkv={Hkv}, hd={hd}, causal", calls=calls,
                device_ms_per_call=ms, total_ms=total,
                share={k: t / total for k, t in ms.items()} if total else {})


def main(quick: bool, prof: bool = False) -> int:
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
    print(json.dumps(dict(ptxas={k: build.info(k) for k in (
        "flash_attention", "flash_attention_bwd")})), flush=True)
    dev = torch.device("cuda", 0)
    if prof:
        print(json.dumps(profile(cs, dev)), flush=True)
        return 0
    print(json.dumps(cs.flash_bwd_vs_plain(dev)), flush=True)
    if not quick:
        print(json.dumps(cs.flash_bwd_time(dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main("--quick" in sys.argv[1:], "--profile" in sys.argv[1:]))

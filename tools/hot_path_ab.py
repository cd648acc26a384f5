#!/usr/bin/env python3
"""The training and serving paths of two checkouts on one card, in
turns A, B, B, A, each run in a process of its own with its checkout's
own code: ``chip_smoke.py``'s ``train_main`` (olmo-1b), ``ssm_train_main``
(falcon-mamba-7b, 8 layers), ``moe_main`` (olmoe-1b-7b) and
``serve_main`` (granite-3-8b) phases, gates included.

    python3 tools/hot_path_ab.py A_DIR B_DIR [--phases P ...]   # on the card
    python3 tools/hot_path_ab.py --one DIR [--phases P ...]     # one run

``--phases`` picks among them (by default the first three).  Each run
prints one JSON line: the step ms (p50 and every timed step) of a
training phase; the prefill and decode step ms p50 and p99 of a serving
phase (``moe_main`` also its ``moe_stage_ms``: CUDA events, each stage
at T 8 and 1,536); and the card's name and power limit.  Given two
checkouts, it then prints one line ``{"summary": ...}`` with each
checkout's p50s in run order.
"""
import argparse
import json
import os
import subprocess
import sys


TRAIN = ("train_main", "ssm_train_main")
SERVE = ("moe_main", "serve_main")
SERVE_KEYS = ("prefill_ms_p50", "prefill_ms_p99", "decode_step_ms_p50",
              "decode_step_ms_p99")


def one(src: str, phases) -> dict:
    """``src``'s ``phases`` in this process; returns the record."""
    src = os.path.abspath(src)
    sys.path.insert(0, os.path.join(src, "src"))
    sys.path.insert(0, src)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.cache_sim import build as cbuild
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba_scan import ops as sops
    from repro_torch.kernels.paged_attention import ops as pops

    assert cs.__file__.startswith(src), cs.__file__
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    kbuild.build_many([("cache_sim", cbuild.SOURCE),
                       ("flash_attention", fops.SOURCE),
                       ("flash_attention_bwd", fops.BWD_SOURCE),
                       ("paged_attention", pops.SOURCE),
                       ("mamba_scan", sops.SOURCE),
                       ("mamba_scan_bwd", sops.BWD_SOURCE)])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cbuild.load()
    rec = dict(src=src, nvidia_smi=smi, torch=torch.__version__)
    for name in phases:
        r = getattr(cs, name)(dev)[0]
        if name in TRAIN:
            rec[name] = dict(step_ms_p50=r["step_ms_p50"],
                             step_ms_timed=r["step_ms_timed"],
                             first_loss=r["first_loss"])
        else:
            rec[name] = {k: r[k] for k in SERVE_KEYS + ("moe_stage_ms",)
                         if k in r}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", metavar="DIR")
    ap.add_argument("--one", metavar="DIR")
    ap.add_argument("--phases", nargs="+", choices=TRAIN + SERVE,
                    default=list(TRAIN) + ["moe_main"])
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.phases)), flush=True)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkouts, A_DIR and B_DIR")
    a, b = args.dirs
    runs = []
    for src in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", src, "--phases", *args.phases],
                             capture_output=True, text=True, timeout=1500)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for phase in args.phases:
        keys = (("step_ms_p50",) if phase in TRAIN else
                ("prefill_ms_p50", "decode_step_ms_p50"))
        for key in keys:
            summary[f"{phase}.{key}"] = [
                [os.path.basename(r["src"].rstrip("/")), r[phase][key]]
                for r in runs]
    if "moe_main" in args.phases:
        summary["moe_main.dispatch_ms"] = [
            [os.path.basename(r["src"].rstrip("/")),
             [s["dispatch"] for s in r["moe_main"]["moe_stage_ms"]]]
            for r in runs]
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

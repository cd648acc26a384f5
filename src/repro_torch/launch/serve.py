"""Serving launcher: batched requests through the Clock2Q+-paged engine.

The port of ``repro.launch.serve``, with its flags, plus ``--device``
(``cuda`` unless named), as ``launch/train.py`` has.  It serves the
paged-KV families only (dense, vlm, moe), as the reference does.
``main(argv)`` takes the arguments as a list, so a script can call it in
process, and returns the completions and the pool's stats; ``params``
replaces the seeded random params (a test carries the reference's
across with ``models.model.params_from_numpy``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
        --requests 8 --max-new 8 [--hbm-blocks 28] [--shrink-to 14] \\
        [--device cpu] [--full-config]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build
from repro_torch.serving.engine import Request, ServingEngine


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--hbm-blocks", type=int, default=28)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--shrink-to", type=int, default=0,
                    help="live-resize the pool mid-run (paper §4.2)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (default cuda)")
    return ap.parse_args(argv)


def requests(vocab: int, n: int, prefix_len: int, max_new: int):
    """The reference's requests: one shared random prefix, each with a
    random tail of 4 to 11 tokens, from numpy seed 0."""
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(0, vocab, prefix_len)]
    return [Request(i, prefix + [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(4, 12)))], max_new=max_new)
        for i in range(n)]


def main(argv=None, params=None) -> dict:
    """Serve and return {"completions", "stats", "flows", "cfg",
    "params", "requests"}."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    if cfg.family not in ("dense", "vlm", "moe"):
        raise SystemExit(f"{cfg.family} archs have no paged-KV serving path")
    api = build(cfg)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    reqs = requests(cfg.vocab, args.requests, args.prefix_len, args.max_new)
    eng = ServingEngine(api, params, block_size=args.block_size,
                        hbm_blocks=args.hbm_blocks,
                        max_batch=args.max_batch, device=dev)
    half = len(reqs) // 2 if args.shrink_to else len(reqs)
    t0 = time.time()
    done = eng.run(reqs[:half])
    if args.shrink_to:
        print(f"live-shrinking pool {args.hbm_blocks} -> {args.shrink_to}")
        eng.pool.resize(args.shrink_to)
        done += eng.run(reqs[half:])
    dt = time.time() - t0
    stats, flows = eng.stats
    n_tok = sum(len(c.tokens) for c in done)
    print(f"{len(done)} completions, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / dt:.1f} tok/s)")
    print(f"pool: hit_ratio={stats.hit_ratio:.2f} swap_out={stats.swap_out} "
          f"swap_in={stats.swap_in}  flows={flows}")
    return {"completions": done, "stats": stats, "flows": flows,
            "cfg": cfg, "params": params, "requests": reqs}


if __name__ == "__main__":
    main()

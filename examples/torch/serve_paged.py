"""Serve a small model with batched requests through the Clock2Q+-paged
KV cache — the paper's technique as a serving substrate.

The port of ``examples/serve_paged.py`` on ``repro_torch``, on the card
unless ``--device cpu`` is given: prefill through the ``flash_attention``
kernel, decode through ``paged_attention``.  Demonstrates: prefix-cache
sharing (correlated references at admission), HBM pressure -> Clock2Q+
eviction to the host tier, dirty-block flushing, and LIVE HBM-pool
resizing mid-service (paper §4.2).

    PYTHONPATH=src python examples/torch/serve_paged.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None, params=None) -> dict:
    """Serve both phases; ``params`` replaces the seeded random params
    (a test carries the reference's across with
    ``models.model.params_from_numpy``).  Returns {"phase1", "phase2"
    (completions), "stats1", "flows1", "stats2", "flows2", "capacity2"
    (the pool's blocks in phase 2), "api", "params", "requests"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config("granite-3-8b"))
    api = build(cfg)
    if params is None:
        params = api.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)

    system_prompt = [int(t) for t in rng.integers(0, cfg.vocab, 32)]
    reqs = [Request(i, system_prompt
                    + [int(t) for t in rng.integers(
                        0, cfg.vocab, int(rng.integers(4, 12)))],
                    max_new=8) for i in range(8)]

    eng = ServingEngine(api, params, block_size=8, hbm_blocks=28,
                        max_batch=4, device=dev)
    t0 = time.time()
    done = eng.run(reqs[:4])
    stats1, flows1 = eng.stats
    print(f"phase 1: {len(done)} completions in {time.time()-t0:.1f}s")
    print(f"  pool: hits={stats1.hits} misses={stats1.misses} "
          f"hit_ratio={stats1.hit_ratio:.2f} swap_out={stats1.swap_out} "
          f"swap_in={stats1.swap_in}")
    print(f"  clock2q+ flows: {flows1}")

    print("live-shrinking the HBM pool 28 -> 14 blocks (paper §4.2) ...")
    eng.pool.resize(14)
    capacity2 = eng.pool.policy.capacity
    done2 = eng.run(reqs[4:])
    stats2, flows2 = eng.stats
    print(f"phase 2 (half HBM): {len(done2)} completions")
    print(f"  pool: hits={stats2.hits} misses={stats2.misses} "
          f"hit_ratio={stats2.hit_ratio:.2f} swap_out={stats2.swap_out} "
          f"swap_in={stats2.swap_in}")
    sample = done[0]
    print(f"sample completion req{sample.req_id}: {sample.tokens}")
    return {"phase1": done, "phase2": done2, "stats1": stats1,
            "flows1": flows1, "stats2": stats2, "flows2": flows2,
            "capacity2": capacity2, "api": api, "params": params,
            "requests": reqs}


if __name__ == "__main__":
    main()

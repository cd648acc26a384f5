#!/usr/bin/env python3
"""Time the port's S3-FIFO, FIFO, Clock and LRU replay kernels alone.

    python3 tools/policy_sweep_probe.py [TRACE ...]   # on a CUDA card

For each named SUITE trace (``w01-skewed``, ``w01-skewed/meta``,
``w04-scans`` by default; ``name/meta`` is the metadata trace) it builds
each family's grid at the 8 sweep capacities (0.5-50 % of the
footprint; S3-FIFO with bits 2 and 1, 16 lanes), times one
``grid_hit_counts`` launch of it with CUDA events, prints the miss
ratios, and holds each family's lane at ``suite_capacity`` against the
port's pure-Python zoo request for request.  One JSON line a trace and
family; exits non-zero on a mismatch or without a card.  A quick loop
for work on ``s3fifo_sim`` and ``simple_sim``: ``chip_smoke.py`` runs
the same kernels inside its whole path.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

FRACS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5)
FAMILIES = (("s3fifo", ({}, dict(bits=1))), ("fifo", ({},)),
            ("clock", ({},)), ("lru", ({},)))


def main(names) -> int:
    if not torch.cuda.is_available():
        print("policy_sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import make_policy, traces
    from repro_torch.core.engine import (
        get_engine, grid_hit_arrays, grid_hit_counts, grid_init,
    )
    from repro_torch.tuning.sweep import relabel

    dev = torch.device("cuda")
    specs = {s.name: s for s in traces.SUITE}
    ok = True
    for name in names:
        data = specs[name.split("/")[0]].data()
        tr = traces.derive_metadata(data) if name.endswith("/meta") else data
        d, u = relabel(tr)
        universe = 1 << max(1, u - 1).bit_length()
        shared = torch.as_tensor(d, device=dev)
        cap = traces.suite_capacity(d)
        for fam, knobs in FAMILIES:
            eng = get_engine(fam)
            cfgs = [eng.config(max(8, int(u * f)), **kw) for kw in knobs
                    for f in FRACS]
            st = grid_init(cfgs, universe, device=dev)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            counts = grid_hit_counts(fam, st, shared)
            b.record()
            torch.cuda.synchronize()
            lane = grid_hit_arrays(fam, grid_init([eng.config(cap)], universe,
                                                  device=dev), shared)
            h = lane[0].cpu().numpy()
            pol = make_policy(fam, cap)
            oracle = np.fromiter((pol.access(k) for k in d.tolist()), bool,
                                 count=len(d))
            equal = bool(np.array_equal(h, oracle))
            ok &= equal
            print(json.dumps(dict(
                trace=name, family=fam, requests=len(d), unique=u,
                lanes=len(cfgs), ms=a.elapsed_time(b),
                miss_ratios=[float(x) for x in 1 - counts.cpu().numpy()
                             / len(d)],
                suite_capacity=cap, zoo_equal=equal)), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["w01-skewed", "w01-skewed/meta",
                                   "w04-scans"]))

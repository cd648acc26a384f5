"""Cache-policy explorer — a mini libCacheSim over the synthetic suite.

The port of ``examples/cache_explorer.py`` on ``repro_torch``: compare
any registered policies on data / derived-metadata / object traces at
several cache sizes; optionally cross-check Clock2Q+ with the
lane-batched engine, which replays the trace through the ``cache_sim``
kernel on the card (``--device cpu`` runs its plain version).

    PYTHONPATH=src python examples/torch/cache_explorer.py \\
        --policies clock,arc,s3fifo,clock2q+ --kind meta --fracs 0.01,0.1 \\
        [--engine-check] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import policy_names, stats, traces
from repro_torch.core import torch_engine as te


def main(argv=None) -> dict:
    """Print the miss-ratio table (and the cross-check); return
    {"trace", "rows": [(frac, cap, {policy: miss ratio})], "check"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", default="clock,arc,s3fifo,clock2q+")
    ap.add_argument("--kind", default="meta", choices=["meta", "data",
                                                       "object"])
    ap.add_argument("--fracs", default="0.01,0.05,0.1")
    ap.add_argument("--trace", default="w01-skewed",
                    choices=[s.name for s in traces.SUITE] + ["object"])
    ap.add_argument("--engine-check", action="store_true",
                    help="cross-check clock2q+ with the lane-batched engine")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda)")
    args = ap.parse_args(argv)

    pols = args.policies.split(",")
    unknown = set(pols) - set(policy_names())
    if unknown:
        raise SystemExit(f"unknown policies {unknown}; have {policy_names()}")
    dev = resolve_device(args.device)

    if args.kind == "object":
        tr = traces.object_trace(300_000, seed=1)
    else:
        spec = next(s for s in traces.SUITE if s.name == args.trace)
        tr = spec.metadata() if args.kind == "meta" else spec.data()
    fp = traces.footprint(tr)
    print(f"trace={args.trace} kind={args.kind} requests={len(tr)} "
          f"footprint={fp}")
    header = "frac   cap     " + "  ".join(f"{p:>10s}" for p in pols)
    print(header)
    rows = []
    for frac in [float(f) for f in args.fracs.split(",")]:
        cap = max(8, int(frac * fp))
        mrs = stats.miss_ratios(pols, tr, cap)
        rows.append((frac, cap, mrs))
        print(f"{frac:<6} {cap:<7} "
              + "  ".join(f"{mrs[p]:>10.4f}" for p in pols))
    check = None
    if args.engine_check and "clock2q+" in pols:
        cap = max(8, int(0.05 * fp))
        h, mr = te.replay_np("clock2q+", np.asarray(tr), cap, device=dev)
        ref = stats.simulate("clock2q+", tr, cap)
        check = "MATCH" if abs(mr - ref.miss_ratio) < 1e-9 else "DIFF"
        print(f"engine cross-check @5%: engine_mr={mr:.6f} "
              f"ref_mr={ref.miss_ratio:.6f} {check}")
    return {"trace": tr, "rows": rows, "check": check}


if __name__ == "__main__":
    main()

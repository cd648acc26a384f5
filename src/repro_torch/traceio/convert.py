"""Trace conversion / materialization CLI (the port's copy of
``repro/traceio/convert.py``).

    # convert between formats (suffix-sniffed; override with --in/--out-format)
    python -m repro_torch.traceio.convert input.csv output.bin
    python -m repro_torch.traceio.convert trace.npz trace.npy

    # densify raw production obj_ids (sparse/hashed 64-bit) to [0, n_unique)
    # for the int32 dense-table replay engines (replacement is
    # label-invariant, so miss ratios are unchanged)
    python -m repro_torch.traceio.convert --relabel cloudphysics.bin dense.npy

    # materialize a registered scenario (repro_torch.core.traces.SCENARIOS)
    python -m repro_torch.traceio.convert --scenario ghost-thrash \
        --n 20000000 --seed 3 trace.bin

    # list scenarios / inspect a trace
    python -m repro_torch.traceio.convert --list-scenarios
    python -m repro_torch.traceio.convert --info trace.bin

Conversion loads the key column and rewrites it (an oracleGeneral output
recomputes next_access_vtime, which needs the whole key column anyway);
streaming replay of the result is TraceStore's job, not convert's.  The
CLI runs on numpy alone: it touches no device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.traceio.formats import load_trace, save_trace, sniff_format
from repro_torch.traceio.store import TraceStore


def _info(path: str, fmt: str | None) -> str:
    resolved = sniff_format(path, fmt)
    if resolved in ("oracle", "npy"):
        store = TraceStore(path, resolved)
        n = len(store)
        mx = store.max_key()
    else:
        keys = load_trace(path, resolved)
        n = keys.size
        mx = int(keys.max()) if n else -1
    return f"{path}: format={resolved} n={n} max_key={mx}"


def main(argv=None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    exit code."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.traceio.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input", nargs="?", help="input trace (omit with --scenario)")
    ap.add_argument("output", nargs="?", help="output trace path")
    ap.add_argument("--in-format", default=None,
                    help="oracle|csv|npz|npy (default: sniff suffix)")
    ap.add_argument("--out-format", default=None,
                    help="oracle|csv|npz|npy (default: sniff suffix)")
    ap.add_argument("--relabel", action="store_true",
                    help="densify keys to [0, n_unique) while converting "
                         "(required before the dense-table replay engines "
                         "can ingest sparse/hashed production obj_ids)")
    ap.add_argument("--scenario", default=None,
                    help="generate this registered scenario instead of reading")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="scenario length (with --scenario)")
    ap.add_argument("--seed", type=int, default=0,
                    help="scenario seed (with --scenario)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print the scenario registry and exit")
    ap.add_argument("--info", action="store_true",
                    help="print trace stats for `input` and exit")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        from repro_torch.core.traces import SCENARIOS
        for name in sorted(SCENARIOS):
            print(f"{name:20s} {SCENARIOS[name].description}")
        return 0

    if args.info:
        if not args.input:
            ap.error("--info needs an input path")
        print(_info(args.input, args.in_format))
        return 0

    if args.scenario:
        out = args.output or args.input
        if not out:
            ap.error("--scenario needs an output path")
        from repro_torch.core.traces import make_trace
        keys = make_trace(args.scenario, n=args.n, seed=args.seed)
    else:
        if not (args.input and args.output):
            ap.error(
                "need input and output paths (or --scenario/--list-scenarios)")
        out = args.output
        keys = np.asarray(load_trace(args.input, args.in_format))
    if args.relabel:
        from repro_torch.traceio.formats import relabel
        keys = relabel(keys)[0].astype(np.int64)
    save_trace(out, keys, args.out_format)
    mx = int(keys.max()) if keys.size else -1
    print(f"{out}: format={sniff_format(out, args.out_format)} "
          f"n={keys.size} max_key={mx}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

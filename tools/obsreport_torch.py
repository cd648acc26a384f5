#!/usr/bin/env python
"""Render an obs JSON snapshot (or the delta of two) as a readable report.

The port of ``tools/obsreport.py`` over ``repro_torch.obs``: the same
modes and flags, and for the same JSON file the same text, byte for
byte.  It reads snapshots of either package (the format is shared).

    PYTHONPATH=src python tools/obsreport_torch.py SNAP.json
    PYTHONPATH=src python tools/obsreport_torch.py OLD.json NEW.json  # delta
    ... --events 40        # show up to N trailing events (default 20)
    ... --incidents        # incident timeline only (faults, retries,
                           # degraded-mode flips, shard loss/rewarm,
                           # restores, rebalances/resizes)
    ... --prom             # emit Prometheus text instead of the report

Snapshots come from ``ObsSink.snapshot().to_json()`` anywhere in the
port (``ProdClock2QPlus.obs``, ``ShardedClock2QPlus.obs_snapshot()``,
``BlockPool.obs_snapshot()``, ``ServingEngine.obs_snapshot()``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

from repro_torch.faults import FAULT_NAMES  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    INCIDENT_KINDS, Snapshot, delta, to_prometheus,
)
from repro_torch.obs.metrics import parse_sample_key  # noqa: E402
from repro_torch.serving.admission import SHED_REASONS  # noqa: E402


def load(path: str) -> Snapshot:
    return Snapshot.from_json(pathlib.Path(path).read_text())


def _label_str(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def render(snap: Snapshot, n_events: int = 20) -> str:
    out = []
    title = "obs snapshot" + (" (delta)" if snap.meta.get("delta") else "")
    out.append(f"== {title} @ ts={snap.ts:.3f} ==")
    if snap.meta:
        out.append("meta: " + _label_str(snap.meta))

    if snap.counters:
        out.append("\n-- counters --")
        by_name = defaultdict(list)
        for key, v in snap.counters.items():
            name, labels = parse_sample_key(key)
            by_name[name].append((_label_str(labels), v))
        for name in sorted(by_name):
            rows = sorted(by_name[name])
            total = sum(v for _, v in rows)
            out.append(f"{name}  (total {total})")
            for lbl, v in rows:
                out.append(f"    {lbl or '-':<48} {v}")

    if snap.gauges:
        out.append("\n-- gauges --")
        for key in sorted(snap.gauges):
            out.append(f"    {key:<52} {snap.gauges[key]:g}")

    if snap.hists:
        out.append("\n-- histograms --")
        for key in sorted(snap.hists):
            h = snap.hists[key]
            count = h["count"]
            out.append(f"{key}: count={count} sum={h['sum']:.6g}")
            if count > 0:
                mean = h["sum"] / count
                qs = {q: _quantile(h, q) for q in (0.5, 0.9, 0.99)}
                out.append(
                    f"    mean={mean:.3e}  p50<={qs[0.5]:.3e}  "
                    f"p90<={qs[0.9]:.3e}  p99<={qs[0.99]:.3e}")
                out.append("    " + _sparkline(h))

    if snap.events:
        out.append(f"\n-- events (last {min(n_events, len(snap.events))} "
                   f"of {len(snap.events)} retained, "
                   f"{snap.dropped_events} wrapped away) --")
        for e in snap.events[-n_events:]:
            out.append(f"    [{e['src']}:{e['seq']}] {e['kind']:<14} "
                       f"shard={e['shard']} a={e['a']} b={e['b']} "
                       f"c={e['c']:g}")
    return "\n".join(out) + "\n"


def _describe_incident(e: dict) -> str:
    kind, shard, a, b = e["kind"], e["shard"], e["a"], e["b"]
    if kind == "fault_inject":
        return f"injected {FAULT_NAMES.get(a, a)} (op #{b})"
    if kind == "io_retry":
        return f"IO retry #{a} after {b}-tick backoff"
    if kind == "io_error":
        return f"IO op on key {a} abandoned after {b} attempts"
    if kind == "degraded":
        return ("ENTERED read-through (breaker open)" if a
                else "recovered to healthy (breaker closed)")
    if kind == "shard_lost":
        return f"shard {shard} LOST ({a} resident entries gone)"
    if kind == "shard_rewarm":
        return f"shard {shard} rewarmed: {a} residents readmitted, " \
               f"{b} ghost-seeded"
    if kind == "restore":
        return f"restored snapshot step {a} ({b} resident entries)"
    if kind == "journal_truncated":
        return f"journal torn tail truncated at LSN {a} ({b} bytes cut)"
    if kind == "promote":
        return f"shard {shard} PROMOTED from standby ({a} journal " \
               f"records replayed, lag {b} at loss)"
    if kind == "rebalance":
        return f"shard {shard} capacity retarget {a} -> {b}"
    if kind in ("resize", "resize_done"):
        return f"shard {shard} resize" + \
               (" complete" if kind == "resize_done" else f" -> {a}")
    if kind in ("shed", "reject"):
        # scheduler events carry the virtual tick in the shard column
        return f"req {a} {kind} at tick {shard} ({SHED_REASONS.get(b, b)})"
    return f"shard={shard} a={a} b={b}"


def render_incidents(snap: Snapshot, n_events: int = 200) -> str:
    """The incident timeline: only fault/recovery-relevant typed events
    (``obs.INCIDENT_KINDS``), one annotated line each, in ring order."""
    incidents = [e for e in snap.events if e["kind"] in INCIDENT_KINDS]
    out = [f"== incident timeline @ ts={snap.ts:.3f} "
           f"({len(incidents)} incident events of {len(snap.events)} "
           f"retained) =="]
    for e in incidents[-n_events:]:
        out.append(f"  [{e['src']}:{e['seq']:>6}] {e['kind']:<13} "
                   f"{_describe_incident(e)}")
    if not incidents:
        out.append("  (no incidents recorded)")
    # replication health alongside the timeline: the per-shard standby
    # lag gauges (repro_torch.faults.replica) are what the
    # promote-vs-rewarm decision reads, so an incident review needs them
    # in view
    lags = sorted(k for k in snap.gauges
                  if k.startswith("cache_replica_lag_lsn"))
    if lags:
        out.append("  -- replication lag (journal records behind) --")
        for k in lags:
            out.append(f"    {k} = {snap.gauges[k]:g}")
    return "\n".join(out) + "\n"


def _quantile(h: dict, q: float) -> float:
    total = h["count"]
    run = 0
    finite = [b for b in h["le"] if b != float("inf")]
    for le, c in zip(h["le"], h["counts"]):
        run += c
        if run >= q * total:
            return le if le != float("inf") else finite[-1]
    return finite[-1] if finite else float("nan")


def _sparkline(h: dict, width: int = 40) -> str:
    counts = h["counts"]
    # trim empty head/tail buckets for a readable strip
    nz = [i for i, c in enumerate(counts) if c]
    if not nz:
        return ""
    lo, hi = nz[0], nz[-1] + 1
    blocks = " .:-=+*#%@"
    peak = max(counts[lo:hi])
    strip = "".join(
        blocks[min(len(blocks) - 1,
                   int(round((len(blocks) - 1) * c / peak)))]
        for c in counts[lo:hi])
    return f"buckets[{lo}:{hi}] |{strip[:width]}|"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", help="obs snapshot JSON file")
    ap.add_argument("newer", nargs="?", default=None,
                    help="second snapshot: report the delta old -> new")
    ap.add_argument("--events", type=int, default=20,
                    help="max trailing events to show (default 20)")
    ap.add_argument("--prom", action="store_true",
                    help="emit Prometheus text exposition instead")
    ap.add_argument("--incidents", action="store_true",
                    help="render only the incident timeline (faults, "
                         "retries, degraded flips, shard loss/rewarm, "
                         "restores, rebalances)")
    args = ap.parse_args(argv)

    snap = load(args.snapshot)
    if args.newer:
        snap = delta(snap, load(args.newer))
        snap.meta["delta"] = "1"
    if args.prom:
        sys.stdout.write(to_prometheus(snap))
    elif args.incidents:
        sys.stdout.write(render_incidents(snap, max(args.events, 200)))
    else:
        sys.stdout.write(render(snap, args.events))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Snapshots, deltas, and export formats (JSON + Prometheus text).

A ``Snapshot`` is a point-in-time, plain-data view of one or many
registries/rings: flat ``sample_key -> value`` dicts per instrument
kind, plus the retained event records.  Plain data means snapshots
survive JSON round-trips bit-for-bit, merge across shards by key, and
subtract into deltas — the three operations every consumer needs
(per-shard aggregation, CI artifacts, scrape endpoints, obsreport).

Merge/delta algebra:
  * counters and histogram buckets are sums -> merge adds, delta
    subtracts; the 4-thread conformance test asserts the merged snapshot
    equals the sum of per-shard deltas exactly.
  * gauges are point-in-time -> merge unions (duplicate keys: last
    wins), delta keeps the newer value.
  * events are identified by (src, seq) -> merge concatenates, delta
    keeps events newer than the old snapshot's per-src high-water mark.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional

from repro_torch.obs import events as events_mod
from repro_torch.obs import metrics as metrics_mod


@dataclasses.dataclass
class Snapshot:
    """Point-in-time copy of a sink: counters, gauges, histograms and events."""
    ts: float
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    gauges: Dict[str, float] = dataclasses.field(default_factory=dict)
    hists: Dict[str, dict] = dataclasses.field(default_factory=dict)
    events: List[dict] = dataclasses.field(default_factory=list)
    dropped_events: int = 0
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self, indent: Optional[int] = None) -> str:
        """Serialise to a JSON string."""
        return json.dumps(dataclasses.asdict(self), indent=indent,
                          sort_keys=False)

    @classmethod
    def from_json(cls, text: str) -> "Snapshot":
        """Parse a snapshot written by ``to_json``."""
        return cls(**json.loads(text))


def snapshot(registries, rings=(), ts: Optional[float] = None,
             meta: Optional[Dict[str, str]] = None) -> Snapshot:
    """Point-in-time snapshot of one or many registries + event rings."""
    if isinstance(registries, metrics_mod.Registry):
        registries = (registries,)
    if isinstance(rings, events_mod.EventRing):
        rings = (rings,)
    snap = Snapshot(ts=time.time() if ts is None else ts,
                    meta=dict(meta or {}))
    for reg in registries:
        for kind, _name, key, value in reg.samples():
            if kind == "counter":
                snap.counters[key] = snap.counters.get(key, 0) + value
            elif kind == "gauge":
                snap.gauges[key] = value
            else:
                _hist_add(snap.hists, key, value)
    for ring in rings:
        snap.events.extend(ring.records())
        snap.dropped_events += ring.dropped
    return snap


def _hist_add(into: Dict[str, dict], key: str, h: dict,
              sign: int = 1) -> None:
    cur = into.get(key)
    if cur is None:
        into[key] = dict(le=list(h["le"]),
                         counts=[sign * c for c in h["counts"]],
                         sum=sign * h["sum"], count=sign * h["count"])
        return
    if cur["le"] != list(h["le"]):
        raise ValueError(f"histogram {key!r}: incompatible bucket bounds")
    cur["counts"] = [a + sign * b
                     for a, b in zip(cur["counts"], h["counts"])]
    cur["sum"] += sign * h["sum"]
    cur["count"] += sign * h["count"]


def merge(snaps: Iterable[Snapshot]) -> Snapshot:
    """Union of snapshots: counters/histograms add, gauges last-wins,
    events concatenate (kept in input order, each identified by
    (src, seq))."""
    snaps = list(snaps)
    out = Snapshot(ts=max((s.ts for s in snaps), default=0.0))
    for s in snaps:
        for k, v in s.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
        out.gauges.update(s.gauges)
        for k, h in s.hists.items():
            _hist_add(out.hists, k, h)
        out.events.extend(s.events)
        out.dropped_events += s.dropped_events
        out.meta.update(s.meta)
    return out


def delta(old: Snapshot, new: Snapshot) -> Snapshot:
    """What happened between two snapshots of the same source(s):
    counter/histogram differences, the newer gauge values, and the
    events emitted after ``old`` (per-src sequence high-water mark)."""
    out = Snapshot(ts=new.ts, meta=dict(new.meta))
    for k, v in new.counters.items():
        out.counters[k] = v - old.counters.get(k, 0)
    out.gauges = dict(new.gauges)
    for k, h in new.hists.items():
        out.hists[k] = dict(le=list(h["le"]), counts=list(h["counts"]),
                            sum=h["sum"], count=h["count"])
        if k in old.hists:
            _hist_add(out.hists, k, old.hists[k], sign=-1)
    mark: Dict[str, int] = {}
    for e in old.events:
        mark[e["src"]] = max(mark.get(e["src"], -1), e["seq"])
    out.events = [e for e in new.events
                  if e["seq"] > mark.get(e["src"], -1)]
    out.dropped_events = new.dropped_events - old.dropped_events
    return out


def to_prometheus(snap: Snapshot) -> str:
    """Prometheus text exposition format (0.0.4).  Histograms expand to
    the standard ``_bucket``/``_sum``/``_count`` series with cumulative
    ``le`` buckets."""
    by_family: Dict[str, List[str]] = {}

    def add(key: str, kind: str, line: str) -> None:
        name, _ = metrics_mod.parse_sample_key(key)
        fam = by_family.setdefault(name, [f"# TYPE {name} {kind}"])
        fam.append(line)

    for key in sorted(snap.counters):
        add(key, "counter", f"{key} {snap.counters[key]}")
    for key in sorted(snap.gauges):
        add(key, "gauge", f"{key} {_fmt(snap.gauges[key])}")
    for key in sorted(snap.hists):
        h = snap.hists[key]
        name, labels = metrics_mod.parse_sample_key(key)
        fam = by_family.setdefault(name, [f"# TYPE {name} histogram"])
        cum = 0
        for le, c in zip(h["le"], h["counts"]):
            cum += c
            lb = dict(labels)
            lb["le"] = "+Inf" if le == float("inf") else _fmt(le)
            fam.append(f"{metrics_mod.sample_key(name + '_bucket', lb)} "
                       f"{cum}")
        fam.append(f"{metrics_mod.sample_key(name + '_sum', labels)} "
                   f"{_fmt(h['sum'])}")
        fam.append(f"{metrics_mod.sample_key(name + '_count', labels)} "
                   f"{h['count']}")
    lines: List[str] = []
    for name in sorted(by_family):
        lines.extend(by_family[name])
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


# -- sinks ---------------------------------------------------------------------

class ObsSink:
    """One component's telemetry bundle: a registry + an event ring.

    This is the object the cache stack passes around (``obs=`` kwargs):
    constructing instruments goes through it at init time, the hot path
    touches only the bound instruments, and ``snapshot()`` renders the
    whole bundle.  ``src`` names the component in event records and
    default shard labels."""

    null = False

    def __init__(self, src: str = "", labels: Optional[Dict] = None,
                 events_capacity: int = 4096):
        self.src = src
        self.registry = metrics_mod.Registry(labels)
        self.ring = events_mod.EventRing(events_capacity, src=src)

    # registry passthroughs (the wiring surface)
    def counter(self, name, labelnames=(), help=""):
        """Register (or fetch) a counter family."""
        return self.registry.counter(name, labelnames, help)

    def gauge(self, name, labelnames=(), help=""):
        """Register (or fetch) a gauge family."""
        return self.registry.gauge(name, labelnames, help)

    def histogram(self, name, labelnames=(), help="", base=1e-6,
                  n_buckets=28):
        """Register (or fetch) a histogram family."""
        return self.registry.histogram(name, labelnames, help, base=base,
                                       n_buckets=n_buckets)

    def on_collect(self, fn):
        """Run ``fn`` before every snapshot (to refresh derived gauges)."""
        return self.registry.on_collect(fn)

    def emit(self, kind: int, shard: int = -1, a: int = 0, b: int = 0,
             c: float = 0.0) -> None:
        """Record one event in the sink's ring."""
        self.ring.emit(kind, shard, a, b, c)

    def snapshot(self, ts: Optional[float] = None) -> Snapshot:
        """Collect a point-in-time ``Snapshot``."""
        return snapshot(self.registry, self.ring, ts=ts,
                        meta={"src": self.src} if self.src else None)


class NullSink(ObsSink):
    """Telemetry disabled: the event ring is a no-op and snapshots are
    empty.  Instruments still exist and still count — they back the
    semantic ``hits``/``misses``/``flows`` surfaces the cache stack has
    always exposed (the same plain increments it did before the obs
    layer existed), so correctness-visible state is identical with the
    sink nulled.  The ``perf_obs_overhead`` benchmark gates the
    instrumented/NullSink wall-time ratio at <= 1.05x."""

    null = True

    def __init__(self, src: str = "", labels: Optional[Dict] = None,
                 events_capacity: int = 0):
        self.src = src
        self.registry = metrics_mod.Registry(labels)
        self.ring = events_mod.NullRing(src=src)

    def snapshot(self, ts: Optional[float] = None) -> Snapshot:
        """Collect a point-in-time ``Snapshot``."""
        return Snapshot(ts=time.time() if ts is None else ts,
                        meta={"src": self.src, "null": "1"})

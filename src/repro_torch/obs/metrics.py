"""Typed metric instruments + registry — the bottom of the obs layer.

Design constraints (hit-path-cheap telemetry):

  * An instrument is a tiny plain-Python object; the hot path mutates a
    single attribute (``counter.value += 1``) or one numpy array cell
    (``hist.counts[i] += 1``) — no locks, no dict lookups, no string
    formatting.  Callers bind instruments to local attributes at init
    and increment directly; ``inc``/``observe`` methods exist for cold
    paths and tests.
  * Lock-free WITHIN a shard: every concurrent component (each
    ``ProdClock2QPlus`` shard, each replay worker thread) owns its own
    ``Registry``; cross-shard aggregation happens only at snapshot time
    by merging flat sample dicts (``repro.obs.export``), never on the
    access path.
  * Mergeable: counters and histogram bucket arrays are sums, so
    per-shard snapshots (and snapshot deltas) add exactly — no dropped
    increments, asserted by tests/test_obs.py under 4-thread replay.

This module may import ONLY the stdlib and numpy: ``repro.obs`` sits
beside ``repro.core.engine`` at the bottom of the layering order and is
sealed (tools/check_layering.py) — every cache subsystem imports obs,
obs imports none of them.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

KINDS = ("counter", "gauge", "histogram")


class Counter:
    """Monotonic counter.  Hot paths do ``c.value += n`` directly."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n``."""
        self.value += n

    def sample(self):
        """Flat sample dict of this metric."""
        return self.value


class Gauge:
    """Point-in-time value (set-or-adjust)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        """Set the value."""
        self.value = v

    def inc(self, n: float = 1.0) -> None:
        """Add ``n``."""
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        """Subtract ``n``."""
        self.value -= n

    def sample(self):
        """Flat sample dict of this metric."""
        return self.value


class Histogram:
    """Log2-bucketed histogram (numpy-backed counts).

    Bucket ``i`` holds observations ``v`` with ``base * 2**(i-1) <= v <
    base * 2**i`` (bucket 0 holds ``v < base``); the top bucket is a
    catch-all.  ``observe`` is one ``bit_length`` + one array-cell
    increment — cheap enough for per-request latencies.  Bucket arrays
    from two histograms with the same shape add elementwise, which is
    what makes per-shard histograms mergeable.
    """

    kind = "histogram"
    __slots__ = ("base", "counts", "sum")

    def __init__(self, base: float = 1e-6, n_buckets: int = 28):
        self.base = float(base)
        self.counts = np.zeros(n_buckets, np.int64)
        self.sum = 0.0

    def observe(self, v: float) -> None:
        """Add one observation to its log2 bucket."""
        i = int(v / self.base).bit_length()
        c = self.counts
        c[i if i < c.shape[0] else c.shape[0] - 1] += 1
        self.sum += v

    @property
    def count(self) -> int:
        """Observations so far."""
        return int(self.counts.sum())

    def bounds(self) -> List[float]:
        """Upper (``le``) bound of each bucket; the last is +inf."""
        n = self.counts.shape[0]
        return [self.base * (1 << i) for i in range(n - 1)] + [float("inf")]

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); NaN when empty."""
        total = self.count
        if total == 0:
            return float("nan")
        target = q * total
        run = 0
        for i, c in enumerate(self.counts.tolist()):
            run += c
            if run >= target:
                return self.base * (1 << min(i, self.counts.shape[0] - 2))
        return self.base * (1 << (self.counts.shape[0] - 2))

    def sample(self):
        """Flat sample dict of this metric."""
        return dict(le=self.bounds(), counts=self.counts.tolist(),
                    sum=float(self.sum), count=self.count)


_KIND_CLS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def sample_key(name: str, labels: Dict[str, str]) -> str:
    """Canonical flat sample key, ``name{k1="v1",k2="v2"}`` with label
    names sorted — the merge/export/Prometheus identity of a series."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_sample_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of ``sample_key`` (labels values must not contain ``",``)."""
    if "{" not in key:
        return key, {}
    name, rest = key.split("{", 1)
    labels = {}
    for part in rest.rstrip("}").split('",'):
        k, v = part.split("=", 1)
        labels[k] = v.strip('"')
    return name, labels


class Family:
    """A named metric family: one instrument per label-value tuple."""

    __slots__ = ("name", "kind", "labelnames", "help", "kw", "children")

    def __init__(self, name: str, kind: str, labelnames: Tuple[str, ...] = (),
                 help: str = "", **kw):
        if kind not in KINDS:
            raise ValueError(f"unknown instrument kind {kind!r}")
        self.name = name
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.help = help
        self.kw = kw
        self.children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values):
        """Get-or-create the instrument for one label-value tuple."""
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        inst = self.children.get(key)
        if inst is None:
            inst = self.children[key] = _KIND_CLS[self.kind](**self.kw)
        return inst


class Registry:
    """Per-component (per-shard) instrument registry.

    ``base_labels`` (e.g. ``{"shard": "3"}``) are folded into every
    sample key at snapshot time, so N shard registries with the same
    family names merge into disjoint labeled series.
    """

    def __init__(self, base_labels: Dict[str, str] | None = None):
        self.base_labels = {k: str(v)
                            for k, v in (base_labels or {}).items()}
        self.families: Dict[str, Family] = {}
        self._collectors: List = []

    def _family(self, name: str, kind: str, labelnames=(), help: str = "",
                **kw) -> Family:
        fam = self.families.get(name)
        if fam is None:
            fam = self.families[name] = Family(name, kind, labelnames,
                                               help, **kw)
        elif fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"family {name!r} re-registered as {kind}{labelnames} "
                f"(was {fam.kind}{fam.labelnames})")
        return fam

    def counter(self, name: str, labelnames=(), help: str = "") -> Family:
        """Register (or fetch) a counter family."""
        return self._family(name, "counter", labelnames, help)

    def gauge(self, name: str, labelnames=(), help: str = "") -> Family:
        """Register (or fetch) a gauge family."""
        return self._family(name, "gauge", labelnames, help)

    def histogram(self, name: str, labelnames=(), help: str = "",
                  base: float = 1e-6, n_buckets: int = 28) -> Family:
        """Register (or fetch) a histogram family."""
        return self._family(name, "histogram", labelnames, help,
                            base=base, n_buckets=n_buckets)

    def on_collect(self, fn) -> None:
        """Register a pre-snapshot hook (set occupancy-style gauges
        lazily instead of maintaining them on the access path)."""
        self._collectors.append(fn)

    def samples(self) -> Iterator[Tuple[str, str, str, object]]:
        """Yield ``(kind, family_name, sample_key, value)`` for every
        instrument, with base labels folded in."""
        for fn in self._collectors:
            fn()
        for fam in self.families.values():
            for lv, inst in fam.children.items():
                labels = dict(self.base_labels)
                labels.update(zip(fam.labelnames, lv))
                yield fam.kind, fam.name, sample_key(fam.name,
                                                     labels), inst.sample()

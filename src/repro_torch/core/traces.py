"""Synthetic trace generation + metadata-trace derivation (paper §2.3, §5.1).

The port's own copy of ``repro/core/traces.py`` (numpy only): the same
generators, seeds and registry, so both packages replay identical
streams.

The CloudPhysics/Wikimedia/Meta/Tencent datasets are not available offline,
so the benchmarks run on seeded synthetic traces that reproduce the access-
pattern *classes* the paper's analysis relies on:

  * ``storage_data_trace`` — block (LBN) traces: Zipf-popular region +
    sequential runs + uniform cold traffic + working-set drift + periodic
    scans, optionally filtered through an upper-tier LRU (paper §2.2: the
    upper file system's own cache removes temporal locality before requests
    reach the lower layer).
  * ``derive_metadata`` — LBN // fanout (paper §2.3; fanout 200 = vSAN ESA).
  * ``object_trace`` — skewed key-value/object workloads with churn, for the
    non-block evaluation (Fig. 14).

All generators are pure functions of their seed, and every workload class
is registered by name in ``SCENARIOS`` (the scenario zoo): benchmarks,
the conformance suite, and the ``convert`` CLI of the reference resolve
workloads with ``make_trace(name, n=..., seed=...)`` instead of hardcoding
generator calls.  Register new classes with ``register_scenario``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

DEFAULT_FANOUT = 200


def _zipf_cdf(universe: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return np.cumsum(w) / np.sum(w)


def zipf_trace(n: int, universe: int, alpha: float = 1.0, seed: int = 0,
               permute: bool = True) -> np.ndarray:
    """Zipf(alpha) over ``universe`` ids; ranks scattered over the id space."""
    rng = np.random.default_rng(seed)
    cdf = _zipf_cdf(universe, alpha)
    ranks = np.searchsorted(cdf, rng.random(n))
    if permute:
        perm = rng.permutation(universe)
        return perm[ranks].astype(np.int64)
    return ranks.astype(np.int64)


def upper_tier_filter(trace: np.ndarray, cache_size: int) -> np.ndarray:
    """Replay through an LRU of ``cache_size`` and return only the misses —
    models the upper file system's data cache (paper §2.2)."""
    od: OrderedDict = OrderedDict()
    out = []
    for k in trace.tolist():
        if k in od:
            od.move_to_end(k)
            continue
        if len(od) >= cache_size:
            od.popitem(last=False)
        od[k] = None
        out.append(k)
    return np.asarray(out, dtype=np.int64)


def storage_data_trace(n: int, universe: int = 1 << 21, seed: int = 0,
                       zipf_alpha: float = 1.1, n_files: int = 4096,
                       frac_seq_in_file: float = 0.6, mean_run: int = 48,
                       frac_cold: float = 0.05, scan_every: int = 0,
                       scan_len: int = 0, drift_epochs: int = 0,
                       upper_cache_frac: float = 0.0,
                       frac_rmw: float = 0.15, rmw_gap: int = 12) -> np.ndarray:
    """Composite production-like LBN trace.

    The LBN space is carved into ``n_files`` extents with lognormal sizes;
    file popularity is Zipf(``zipf_alpha``).  Requests to a file are either
    sequential runs (geometric length) or uniform-random within the file.
    This preserves *spatial* locality (hot files -> hot extents), which is
    what makes the derived metadata trace realistic: hot leaves stay hot
    long-term, while sequential runs create short correlated-reference
    bursts on consecutive leaves (paper §2.2).
    """
    rng = np.random.default_rng(seed)
    # -- carve the LBN space into files --------------------------------------
    raw = rng.lognormal(mean=5.0, sigma=1.6, size=n_files)
    sizes = np.maximum(4, (raw / raw.sum() * universe)).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    starts = np.minimum(starts, universe - 1)
    sizes = np.minimum(sizes, universe - starts)
    cdf = _zipf_cdf(n_files, zipf_alpha)
    rank_to_file = rng.permutation(n_files)
    epoch_len = max(1, n // max(1, drift_epochs)) if drift_epochs else n + 1
    # -- emit ------------------------------------------------------------------
    pieces = []
    emitted = 0
    while emitted < n:
        drift = ((emitted // epoch_len) * 1009) if drift_epochs else 0
        r = rng.random()
        if r < frac_cold:  # uniform cold block anywhere on the volume
            pieces.append(np.asarray([rng.integers(0, universe)], dtype=np.int64))
            emitted += 1
            continue
        rank = int(np.searchsorted(cdf, rng.random()))
        f = int(rank_to_file[(rank + drift) % n_files])
        base, fsz = int(starts[f]), int(sizes[f])
        if rng.random() < frac_seq_in_file:  # sequential run within the file
            run = min(1 + int(rng.geometric(1.0 / mean_run)), fsz, n - emitted)
            off = int(rng.integers(0, max(1, fsz - run + 1)))
            pieces.append(base + np.arange(off, off + run, dtype=np.int64))
            emitted += run
        else:  # random block within the file
            pieces.append(np.asarray([base + rng.integers(0, fsz)], dtype=np.int64))
            emitted += 1
    out = np.concatenate(pieces)[:n]
    if scan_every and scan_len:
        pieces = []
        for j in range(0, n, scan_every):
            pieces.append(out[j:j + scan_every])
            start = int(rng.integers(0, max(1, universe - scan_len)))
            pieces.append(np.arange(start, start + scan_len, dtype=np.int64))
        out = np.concatenate(pieces)[:n + (n // scan_every) * scan_len]
    if upper_cache_frac > 0:
        out = upper_tier_filter(out, max(1, int(upper_cache_frac * universe)))
    if frac_rmw > 0:
        out = _inject_rmw(out, frac_rmw, rmw_gap, rng)
    return out


def _inject_rmw(trace: np.ndarray, frac: float, gap: int, rng) -> np.ndarray:
    """Read-modify-write injection: with prob ``frac`` a request is repeated
    once a few requests later (partial-block write / flush-readback).  These
    are data-level correlated references (paper §5.3 conjectures real data
    traces contain them)."""
    import heapq
    dup = rng.random(trace.size) < frac
    gaps = rng.integers(1, gap + 1, size=trace.size)
    out = []
    pending = []  # (due input index, key)
    for i, k in enumerate(trace.tolist()):
        while pending and pending[0][0] <= i:
            out.append(heapq.heappop(pending)[1])
        out.append(k)
        if dup[i]:
            heapq.heappush(pending, (i + int(gaps[i]), k))
    out.extend(k for _, k in sorted(pending))
    return np.asarray(out, dtype=np.int64)


def derive_metadata(trace: np.ndarray, fanout: int = DEFAULT_FANOUT) -> np.ndarray:
    """Paper §2.3: metadata block id = LBN // fanout."""
    return (np.asarray(trace, dtype=np.int64) // fanout)


def object_trace(n: int, universe: int = 1 << 17, alpha: float = 1.2,
                 churn_frac: float = 0.1, seed: int = 0) -> np.ndarray:
    """Skewed object/key-value workload with arrival churn (Fig. 14 class)."""
    rng = np.random.default_rng(seed)
    base = zipf_trace(n, universe, alpha=alpha, seed=seed + 1)
    churn_mask = rng.random(n) < churn_frac
    # churned requests address a moving window of 'new' objects
    new_ids = universe + (np.arange(n) // max(1, n // universe))
    base[churn_mask] = new_ids[churn_mask]
    return base


def correlated_burst_trace(n_ops: int, universe: int = 1 << 16,
                           alpha: float = 0.8, burst_max: int = 4,
                           burst_window: int = 8, seed: int = 0) -> np.ndarray:
    """Explicit correlated-reference generator: every logical op touches its
    block 1..burst_max times within a short window (multiple tuples read
    from one metadata leaf), independent of the block's long-term heat."""
    rng = np.random.default_rng(seed)
    blocks = zipf_trace(n_ops, universe, alpha=alpha, seed=seed + 7)
    out = []
    pending = []  # (emit_at, key)
    t = 0
    for b in blocks.tolist():
        reps = int(rng.integers(1, burst_max + 1))
        out.append(b)
        t += 1
        for _ in range(reps - 1):
            pending.append((t + int(rng.integers(1, burst_window)), b))
        pending.sort()
        while pending and pending[0][0] <= t:
            out.append(pending.pop(0)[1])
            t += 1
    out.extend(k for _, k in pending)
    return np.asarray(out, dtype=np.int64)


# =============================================================================
# additional workload classes (the scenario zoo beyond the paper's three)
# =============================================================================

def cyclic_loop_trace(n: int, universe: int = 1 << 15, loop_frac: float = 0.8,
                      noise_frac: float = 0.05, seed: int = 0) -> np.ndarray:
    """Repeated sequential loop over ``loop_frac`` of the id space with a
    sprinkle of uniform noise — the classic LRU-adversarial scan/loop
    pattern (every reuse distance equals the loop length)."""
    rng = np.random.default_rng(seed)
    loop_len = max(1, int(round(loop_frac * universe)))
    out = (np.arange(n, dtype=np.int64) % loop_len)
    noise = rng.random(n) < noise_frac
    out[noise] = rng.integers(0, universe, int(noise.sum()))
    return out


def multi_tenant_trace(n: int, universe: int = 1 << 18, n_tenants: int = 4,
                       alphas=(1.3, 1.1, 0.9, 0.7),
                       weights=(0.4, 0.3, 0.2, 0.1),
                       seed: int = 0) -> np.ndarray:
    """``n_tenants`` workloads with disjoint key ranges and different
    skews, interleaved by traffic weight — the consolidated-cluster mix a
    shared metadata cache actually serves."""
    rng = np.random.default_rng(seed)
    if not (len(alphas) == len(weights) == n_tenants):
        raise ValueError("need one alpha and one weight per tenant")
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    tenant = rng.choice(n_tenants, size=n, p=w)
    span = universe // n_tenants
    out = np.empty(n, dtype=np.int64)
    for t in range(n_tenants):
        idx = np.nonzero(tenant == t)[0]
        if idx.size == 0:
            continue
        sub = zipf_trace(idx.size, max(1, span), alpha=float(alphas[t]),
                         seed=seed + 101 * (t + 1))
        out[idx] = t * span + sub
    return out


def diurnal_trace(n: int, universe: int = 1 << 18, hot_frac: float = 0.05,
                  n_periods: float = 2.0, alpha: float = 1.2,
                  seed: int = 0) -> np.ndarray:
    """Day/night drift: a Zipf-hot window of ``hot_frac * universe`` keys
    whose center moves sinusoidally across the id space, so the working
    set is stable locally but turns over completely every half period."""
    rng = np.random.default_rng(seed)
    width = max(1, int(round(hot_frac * universe)))
    offsets = zipf_trace(n, width, alpha=alpha, seed=seed + 7)
    phase = 2.0 * np.pi * n_periods * np.arange(n) / max(1, n)
    center = ((0.5 + 0.5 * np.sin(phase)) * (universe - width)).astype(np.int64)
    cold = rng.random(n) < 0.02
    out = center + offsets
    out[cold] = rng.integers(0, universe, int(cold.sum()))
    return out


def flash_crowd_trace(n: int, universe: int = 1 << 18, crowd_size: int = 64,
                      crowd_start: float = 0.4, crowd_len: float = 0.2,
                      crowd_frac: float = 0.8, alpha: float = 1.1,
                      seed: int = 0) -> np.ndarray:
    """Steady Zipf background with a flash crowd: mid-trace, most traffic
    suddenly hammers ``crowd_size`` previously-cold keys, then stops —
    tests how fast admission reacts to (and recovers from) a hot-set
    inversion."""
    rng = np.random.default_rng(seed)
    out = zipf_trace(n, universe - crowd_size, alpha=alpha, seed=seed + 3)
    lo = int(crowd_start * n)
    hi = min(n, lo + int(crowd_len * n))
    in_crowd = np.zeros(n, dtype=bool)
    in_crowd[lo:hi] = rng.random(hi - lo) < crowd_frac
    # crowd keys live at the top of the id space: cold before the spike
    out[in_crowd] = (universe - crowd_size
                     + rng.integers(0, crowd_size, int(in_crowd.sum())))
    return out


def ghost_thrash_trace(n: int, set_size: int = 4096,
                       seed: int = 0) -> np.ndarray:
    """Adversarial ghost-thrash: a strict round-robin over ``set_size``
    keys.  Every reuse distance equals ``set_size``, so for any cache
    smaller than that every access misses, re-enters via the Ghost ring,
    and churns the Main Clock — the worst case for ghost-based admission
    (the N+1-loop analogue of the paper's scan resistance discussion)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(set_size).astype(np.int64)
    return perm[np.arange(n, dtype=np.int64) % set_size]


def metadata_trace(n: int, fanout: int = DEFAULT_FANOUT,
                   universe: int = 1 << 21, seed: int = 0,
                   **storage_kw) -> np.ndarray:
    """Composite storage trace pushed through the paper's §2.3 metadata
    derivation at an arbitrary fanout (one scenario per tree geometry)."""
    data = storage_data_trace(n, universe=universe, seed=seed, **storage_kw)
    return derive_metadata(data, fanout=fanout)


# =============================================================================
# arrival processes (serving-scheduler simulation harness)
# =============================================================================
# These generators emit *arrival ticks* (sorted, non-decreasing int64) for
# n requests on the scheduler's virtual clock, not cache keys — but they
# live in the same registry so the simulation harness and the SLO
# benchmark resolve them by name like any other workload class.

def poisson_arrivals(n: int, mean_gap: float = 2.0,
                     seed: int = 0) -> np.ndarray:
    """Poisson process: exponential inter-arrival times with mean
    ``mean_gap`` ticks, floored onto the integer clock."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_gap, n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def burst_arrivals(n: int, burst: int = 16, period: int = 32,
                   seed: int = 0) -> np.ndarray:
    """On/off bursts: ``burst`` requests land on the same tick every
    ``period`` ticks, with ±25% seeded jitter on the period — the open-
    loop batch-ingest shape that stresses queue bounds and displacement."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    while len(out) < n:
        out.extend([t] * min(burst, n - len(out)))
        t += period + int(rng.integers(-(period // 4), period // 4 + 1))
    return np.asarray(out[:n], dtype=np.int64)


def adversarial_arrivals(n: int, herd: int = 64, lull: int = 96,
                         seed: int = 0) -> np.ndarray:
    """Thundering herd: long lulls, then a same-tick herd sized to
    overflow the default admission queue, with a seeded trickle during
    the lull — the worst case for bounded admission (sheds and
    displacement every herd) while the lulls test drain-to-idle."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    while len(out) < n:
        out.extend([t] * min(herd, n - len(out)))
        trickle = sorted(rng.integers(t + 1, t + lull,
                                      max(1, herd // 16)).tolist())
        out.extend(trickle[:max(0, n - len(out))])
        t += lull
    return np.asarray(out[:n], dtype=np.int64)


@dataclass(frozen=True)
class TraceSpec:
    """Named, seeded workload used across benchmarks (a stand-in for one
    CloudPhysics trace)."""
    name: str
    n: int
    universe: int
    seed: int
    zipf_alpha: float = 1.1
    n_files: int = 4096
    frac_seq_in_file: float = 0.6
    mean_run: int = 48
    frac_cold: float = 0.05
    scan_every: int = 0
    scan_len: int = 0
    drift_epochs: int = 0
    upper_cache_frac: float = 0.0

    def data(self) -> np.ndarray:
        """The block (LBN) trace of this spec."""
        return storage_data_trace(
            self.n, self.universe, seed=self.seed, zipf_alpha=self.zipf_alpha,
            n_files=self.n_files, frac_seq_in_file=self.frac_seq_in_file,
            mean_run=self.mean_run, frac_cold=self.frac_cold,
            scan_every=self.scan_every, scan_len=self.scan_len,
            drift_epochs=self.drift_epochs,
            upper_cache_frac=self.upper_cache_frac)

    def metadata(self, fanout: int = DEFAULT_FANOUT) -> np.ndarray:
        """The metadata trace derived from ``data()`` at ``fanout``."""
        return derive_metadata(self.data(), fanout)


# =============================================================================
# scenario registry — the named workload zoo
# =============================================================================

@dataclass(frozen=True)
class Scenario:
    """A named, seeded workload class.  ``generate(n, seed)`` returns the
    request stream to feed a cache (length ~= n; some generators emit a
    few extra requests, e.g. injected RMW duplicates)."""
    name: str
    description: str
    generator: Callable[..., np.ndarray]
    defaults: tuple = ()  # ((param, value), ...) — hashable

    def generate(self, n: int, seed: int = 0, **overrides) -> np.ndarray:
        """The request stream for ``n`` requests from ``seed``."""
        params = dict(self.defaults)
        params.update(overrides)
        return np.asarray(self.generator(n, seed=seed, **params),
                          dtype=np.int64)


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(name: str, description: str,
                      generator: Callable[..., np.ndarray],
                      **defaults) -> Scenario:
    """Register a workload class under ``name`` (last registration wins,
    so tests can shadow).  ``generator(n, seed=..., **defaults)`` must be
    a pure function of its arguments."""
    sc = Scenario(name, description, generator, tuple(sorted(defaults.items())))
    SCENARIOS[name] = sc
    return sc


def scenario_names() -> list:
    """Sorted names of every registered scenario."""
    return sorted(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario by name."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{scenario_names()}") from None


def make_trace(name: str, n: int, seed: int = 0, **overrides) -> np.ndarray:
    """Resolve a scenario by name and generate its request stream."""
    return get_scenario(name).generate(n, seed=seed, **overrides)


# The benchmark suite: a spread of skews / scan intensities / localities /
# run lengths, mirroring the diversity of the 106 CloudPhysics traces at
# reduced scale.
SUITE = [
    TraceSpec("w01-skewed", n=400_000, universe=1 << 21, seed=101, zipf_alpha=1.3),
    TraceSpec("w02-balanced", n=400_000, universe=1 << 21, seed=202, zipf_alpha=1.0),
    TraceSpec("w03-seqheavy", n=400_000, universe=1 << 21, seed=303,
              zipf_alpha=0.9, frac_seq_in_file=0.85, mean_run=128),
    TraceSpec("w04-scans", n=400_000, universe=1 << 21, seed=404,
              zipf_alpha=1.1, scan_every=50_000, scan_len=20_000),
    TraceSpec("w05-filtered", n=400_000, universe=1 << 20, seed=505,
              zipf_alpha=1.2, upper_cache_frac=0.01),
    TraceSpec("w06-flat", n=400_000, universe=1 << 20, seed=606,
              zipf_alpha=0.7, frac_seq_in_file=0.4, mean_run=24),
    TraceSpec("w07-drift", n=400_000, universe=1 << 21, seed=707,
              zipf_alpha=1.1, drift_epochs=5),
    TraceSpec("w08-random", n=400_000, universe=1 << 20, seed=808,
              zipf_alpha=1.0, frac_seq_in_file=0.15, frac_cold=0.15),
]

_SUITE_DESCRIPTIONS = {
    "w01-skewed": "highly skewed (Zipf 1.3) production block trace",
    "w02-balanced": "balanced-skew (Zipf 1.0) production block trace",
    "w03-seqheavy": "sequential-run-heavy block trace (85% seq, run 128)",
    "w04-scans": "skewed block trace with periodic full-volume scans",
    "w05-filtered": "block trace behind an upper-tier LRU (locality stripped)",
    "w06-flat": "flat-skew small-run block trace",
    "w07-drift": "working set drifts across 5 epochs",
    "w08-random": "random-dominated block trace (15% cold, few runs)",
}


def _spec_generator(spec: TraceSpec):
    def gen(n: int, seed: int = 0, **overrides) -> np.ndarray:
        return dataclasses.replace(spec, n=n, seed=seed, **overrides).data()
    return gen


for _spec in SUITE:
    register_scenario(_spec.name, _SUITE_DESCRIPTIONS[_spec.name],
                      _spec_generator(_spec))

register_scenario(
    "zipf", "pure Zipf(1.2) popularity over a permuted id space",
    zipf_trace, universe=1 << 17, alpha=1.2)
register_scenario(
    "object-churn", "skewed key-value workload with arrival churn (Fig. 14)",
    object_trace)
register_scenario(
    "correlated-burst",
    "every logical op re-touches its block within a short window (§2.2)",
    correlated_burst_trace)
register_scenario(
    "cyclic-loop", "sequential loop larger than the cache (LRU-adversarial)",
    cyclic_loop_trace)
register_scenario(
    "multi-tenant", "4 tenants, disjoint ranges, different skews, 40/30/20/10",
    multi_tenant_trace)
register_scenario(
    "diurnal", "Zipf-hot window drifting sinusoidally across the id space",
    diurnal_trace)
register_scenario(
    "flash-crowd", "sudden mid-trace spike on previously-cold keys",
    flash_crowd_trace)
register_scenario(
    "write-heavy-rmw",
    "write-heavy block trace: 45% read-modify-write duplication",
    storage_data_trace, universe=1 << 19, frac_seq_in_file=0.3,
    frac_rmw=0.45, rmw_gap=6)
register_scenario(
    "meta-fine", "metadata trace at fanout 16 (fine-grained tree leaves)",
    metadata_trace, fanout=16, universe=1 << 19)
register_scenario(
    "meta-coarse", "metadata trace at fanout 1000 (coarse tree leaves)",
    metadata_trace, fanout=1000, universe=1 << 21)
register_scenario(
    "ghost-thrash",
    "adversarial round-robin: every reuse lands in the Ghost ring",
    ghost_thrash_trace)
register_scenario(
    "arrivals-poisson",
    "serving arrival ticks: Poisson process, mean gap 2 ticks",
    poisson_arrivals)
register_scenario(
    "arrivals-burst",
    "serving arrival ticks: same-tick bursts of 16 every ~32 ticks",
    burst_arrivals)
register_scenario(
    "arrivals-adversarial",
    "serving arrival ticks: thundering herds of 64 between long lulls",
    adversarial_arrivals)


def footprint(trace: np.ndarray) -> int:
    """Number of distinct keys in ``trace``."""
    return int(np.unique(np.asarray(trace)).size)


def suite_capacity(trace: np.ndarray, frac: float = 0.05, align: int = 8,
                   floor: int = 64) -> int:
    """The benchmark/parity capacity rule: ``frac`` of the trace footprint,
    floored and aligned (the same rule as the reference's, so both
    packages compare against the same baseline)."""
    cap = max(floor, int(frac * footprint(trace)))
    return cap - cap % align

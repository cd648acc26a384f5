"""Simulation drivers + analysis used by the paper-reproduction benchmarks.

The port's own copy of ``repro/core/stats.py``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence

import numpy as np

from repro_torch.core.policy import SimResult, make_policy

_INF = 1 << 62


def simulate(policy_name: str, trace, capacity: int, dirty_fn=None,
             **kw) -> SimResult:
    pol_kw = dict(kw)
    if policy_name == "belady":
        pol_kw["trace"] = trace
    pol = make_policy(policy_name, capacity, **pol_kw)
    return pol.run(trace, dirty_fn=dirty_fn)


def miss_ratios(policy_names: Sequence[str], trace, capacity: int,
                **kw) -> Dict[str, float]:
    return {p: simulate(p, trace, capacity, **kw).miss_ratio
            for p in policy_names}


def improvement_vs_clock(policy_names: Sequence[str], trace,
                         capacity: int, **kw) -> Dict[str, float]:
    """Paper Eq. 1: (MR_clock - MR_algo) / MR_clock."""
    mrs = miss_ratios(list(policy_names) + ["clock"], trace, capacity, **kw)
    base = mrs["clock"]
    return {p: (base - mrs[p]) / max(base, 1e-12) for p in policy_names}


def mrc(policy_name: str, trace, sizes: Iterable[int], **kw) -> Dict[int, float]:
    """Miss-ratio curve over absolute cache sizes."""
    return {int(c): simulate(policy_name, trace, int(c), **kw).miss_ratio
            for c in sizes}


def next_use_indices(trace) -> np.ndarray:
    """next_use[i] = index of the next occurrence of trace[i] after i (or INF)."""
    trace = list(trace)
    n = len(trace)
    nxt = np.full(n, _INF, dtype=np.int64)
    last: Dict = {}
    for i in range(n - 1, -1, -1):
        k = trace[i]
        if k in last:
            nxt[i] = last[k]
        last[k] = i
    return nxt


def flow_nrd(policy_name: str, trace, capacity: int, **kw):
    """Table-1 / Fig-10 reproduction: per queue-flow counts and the next-
    reuse distance (in requests; INF if never reused) of each moved block."""
    pol_kw = dict(kw)
    pol = make_policy(policy_name, capacity, record_events=True, **pol_kw)
    res = pol.run(trace)
    trace = list(trace)
    n = len(trace)
    # occurrences per key for binary search of "next access after t"
    occ: Dict = {}
    for i, k in enumerate(trace):
        occ.setdefault(k, []).append(i)
    flows: Dict[str, List[int]] = {}
    for kind, key, t in pol.events:
        lst = occ.get(key)
        if lst is None:
            continue
        j = bisect.bisect_right(lst, t)
        d = (lst[j] - t) if j < len(lst) else _INF
        flows.setdefault(kind, []).append(d)
    counts = {k: len(v) for k, v in flows.items()}
    return res, counts, flows

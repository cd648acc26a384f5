"""Batched miss-ratio-curve (MRC) sweep engine on PyTorch.

The port of ``repro/tuning/sweep.py``.  A tuning grid — capacities x
correlation-window sizes x small/ghost-fraction variants x policies —
runs as the lanes of one kernel launch per step family (``cache_sim``
for clock2q+ and clock2q, ``s3fifo_sim``, and ``simple_sim``'s FIFO,
Clock and LRU entry points): every lane's rings are padded to its
family's maxima, its logical sizes are per-lane scalars, and each lane
is exactly the simulation a one-lane replay at that configuration would
run.

Keys are relabelled to a dense ``[0, n_unique)`` id space on the host
(replacement is label-invariant), so the engine accepts raw 64-bit keys
and the per-lane location tables stay small.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.engine import (  # noqa: F401  (SweepConfig re-exported here)
    SweepConfig, get_engine, grid_hit_counts, grid_init, step_family,
)
from repro_torch.core.engine import lane_hits  # noqa: F401  (conformance hook)
# re-exported where the reference's sweep module has it
from repro_torch.traceio.formats import relabel


def make_grid(capacities: Sequence[int],
              window_fracs: Sequence[float] = (0.5,),
              small_fracs: Sequence[float] = (0.1,),
              ghost_fracs: Sequence[float] = (0.5,),
              skip_limit: int = 0,
              policy: str = "clock2q+", **kw) -> List[SweepConfig]:
    """Cartesian tuning grid, capacity-major (matches np.reshape order).
    Extra kwargs (e.g. ``bits``) are applied to every config."""
    return [SweepConfig(int(c), float(wf), float(sf), float(gf), skip_limit,
                        policy=policy, **kw)
            for c in capacities for wf in window_fracs
            for sf in small_fracs for gf in ghost_fracs]


def sweep_hits(trace: np.ndarray, configs: Sequence[SweepConfig],
               pad_pow2: bool = False, device=None) -> np.ndarray:
    """Exact per-config hit counts for ``trace`` over the whole grid,
    aligned with ``configs``.  Mixed-policy grids are partitioned by step
    family (``step_family``: clock2q+ and clock2q share one); each
    partition is one kernel launch on CUDA.

    The location tables are sized to the next power of two above the
    relabelled universe (ids beyond ``n_unique`` are never accessed, so
    results are unchanged).  ``pad_pow2`` additionally pads the trace to
    a power-of-two length with no-op sentinels, as the reference does."""
    if len(configs) == 0:
        raise ValueError("empty sweep grid")
    dev = resolve_device(device)
    tr, universe = relabel(trace)
    universe = 1 << max(1, universe - 1).bit_length()
    if pad_pow2:
        n = 1 << max(1, tr.size - 1).bit_length()
        tr = np.concatenate([tr, np.full(n - tr.size, -1, np.int32)])
    out = np.empty(len(configs), dtype=np.int64)
    by_family: dict = {}
    for i, c in enumerate(configs):
        by_family.setdefault(step_family(c.policy), []).append(i)
    for idx in by_family.values():
        states = grid_init([configs[i] for i in idx], universe, device=dev)
        out[idx] = grid_hit_counts(configs[idx[0]].policy, states,
                                   tr).cpu().numpy()
    return out


def sweep_grid(trace: np.ndarray, configs: Sequence[SweepConfig],
               pad_pow2: bool = False, device=None) -> np.ndarray:
    """Miss ratio per grid configuration (aligned with ``configs``)."""
    hits = sweep_hits(trace, configs, pad_pow2, device=device)
    return 1.0 - hits / max(1, len(trace))


def surface_shape(n_grid: int, capacities: Sequence[int],
                  window_fracs: Sequence[float]) -> List[int]:
    """Result shape of a ``make_grid`` sweep viewed as an MRC surface:
    (capacities, window_fracs[, small x ghost variants])."""
    shape = [len(capacities), len(window_fracs)]
    extra = n_grid // (shape[0] * shape[1])
    if extra > 1:
        shape.append(extra)
    return shape


def mrc_grid(trace: np.ndarray, capacities: Sequence[int],
             window_fracs: Sequence[float] = (0.5,), device=None,
             **kw) -> np.ndarray:
    """MRC surface of shape (len(capacities), len(window_fracs), ...),
    capacity-major like ``make_grid``."""
    grid = make_grid(capacities, window_fracs, **kw)
    mrs = sweep_grid(trace, grid, device=device)
    return mrs.reshape(surface_shape(len(grid), capacities, window_fracs))


def serial_sweep_hits(trace: np.ndarray, configs: Sequence[SweepConfig],
                      device=None) -> np.ndarray:
    """One one-lane replay per configuration: the parity reference for
    the batched sweep."""
    from repro_torch.core import torch_engine as te

    tr, universe = relabel(trace)
    out = np.empty(len(configs), dtype=np.int64)
    for i, c in enumerate(configs):
        eng = get_engine(c.policy)
        kw = {k: getattr(c, k) for k in eng.knobs}
        h, _ = te.replay_np(c.policy, tr, c.capacity, universe=universe,
                            device=device, **kw)
        out[i] = h
    return out

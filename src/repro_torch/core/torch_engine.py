"""Replay drivers on the PyTorch engine: the port of
``repro/core/jax_engine.py``'s ``init_state``, ``replay_np`` and
``replay_batch``.

The state machines live in ``repro_torch.core.engine``; on CUDA every
replay here runs its family's Hopper kernel (``cache_sim``,
``s3fifo_sim`` or ``simple_sim``).  Keys must be int ids in
``[0, universe)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (  # noqa: F401  (replay_chunked: driver API)
    get_engine, replay, replay_chunked,
)


def init_state(policy: str, capacity: int, universe: int, device=None,
               **kw) -> Dict[str, torch.Tensor]:
    """One-lane state for ``policy`` at ``capacity`` on ``device``."""
    return get_engine(policy).init(capacity, int(universe), device=device,
                                   **kw)


def replay_np(policy: str, trace: np.ndarray, capacity: int,
              universe: int | None = None, device=None,
              **kw) -> Tuple[int, float]:
    """Host-side convenience wrapper returning a hit count + miss ratio."""
    trace = np.asarray(trace)
    if universe is None:
        universe = int(trace.max()) + 1
    st = init_state(policy, capacity, int(universe), device=device, **kw)
    _, hits = replay(policy, st, trace)
    h = int(hits.sum())
    return h, 1.0 - h / max(1, len(trace))


def replay_batch(policy: str, states: Dict[str, torch.Tensor],
                 traces) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One trace per lane: ``traces`` (L, T) against the L lanes of
    ``states`` (advanced in place).  Returns ``(states, hits (L, T))``."""
    if not isinstance(traces, torch.Tensor):
        traces = np.asarray(traces)
    if traces.ndim != 2:
        raise ValueError(f"replay_batch takes one trace per lane, (L, T); "
                         f"got shape {tuple(traces.shape)}")
    return replay(policy, states, traces)

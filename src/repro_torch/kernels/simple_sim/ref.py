"""The plain PyTorch version of the ``simple_sim`` kernels.

A loop over the trace of the lane-batched FIFO, Clock or LRU step
(``repro_torch.core.engine.simple``).  It computes exactly the function
of ``csrc/simple_sim.cu``'s entry point of that family on any device: the
CPU tests run it, and ``chip_smoke.py`` holds the kernels against it on
the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.lanes import replay_steps


def simple_sim_plain(family: str, state: Dict[str, torch.Tensor],
                     trace: torch.Tensor, out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` ((T,) or (L, T); keys < 0 are no-op padding)
    through every lane of the ``family`` (``fifo``, ``clock`` or ``lru``)
    state, in place.  Returns hits (L, T) bool for ``out="hits"``, or
    per-lane hit counts (L,) int64."""
    # lazy: the kernels are the lowest layer (tools/check_layering_torch.py)
    from repro_torch.core.engine import simple
    step = dict(fifo=simple.fifo_step, clock=simple.clock_step,
                lru=simple.lru_step)[family]
    return replay_steps(step, state, trace, out)

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

from repro_torch.core.engine.simple import clock_step, fifo_step, lru_step
from repro_torch.kernels.lanes import replay_steps

STEPS = dict(fifo=fifo_step, clock=clock_step, lru=lru_step)


def simple_sim_plain(family: str, state: Dict[str, torch.Tensor],
                     trace: torch.Tensor, out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` ((T,) or (L, T); keys < 0 are no-op padding)
    through every lane of the ``family`` (``fifo``, ``clock`` or ``lru``)
    state, in place.  Returns hits (L, T) bool for ``out="hits"``, or
    per-lane hit counts (L,) int64."""
    return replay_steps(STEPS[family], state, trace, out)

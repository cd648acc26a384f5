"""The plain PyTorch version of the ``s3fifo_sim`` kernel.

A loop over the trace of the lane-batched S3-FIFO step
(``repro_torch.core.engine.s3fifo.step``).  It computes exactly the
function of ``csrc/s3fifo_sim.cu`` on any device: the CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.lanes import replay_steps


def s3fifo_sim_plain(state: Dict[str, torch.Tensor], trace: torch.Tensor,
                     out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` ((T,) or (L, T); keys < 0 are no-op padding)
    through every lane of ``state``, in place.  Returns hits (L, T) bool
    for ``out="hits"``, or per-lane hit counts (L,) int64."""
    # lazy: the kernels are the lowest layer (tools/check_layering_torch.py)
    from repro_torch.core.engine.s3fifo import step
    return replay_steps(step, state, trace, out)

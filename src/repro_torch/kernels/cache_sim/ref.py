"""The plain PyTorch version of the ``cache_sim`` kernel.

A loop over the trace of the lane-batched Clock2Q+ step
(``repro_torch.core.engine.clock2qplus.step``).  It computes exactly the
function of ``csrc/cache_sim.cu`` on any device: the CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.lanes import replay_steps


def cache_sim_plain(state: Dict[str, torch.Tensor], trace: torch.Tensor,
                    out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of ``state``, in place.

    ``trace`` is (T,) (one row shared by all lanes) or (L, T) (one row
    per lane); keys < 0 are no-op padding.  Returns the per-request hits
    (L, T) bool for ``out="hits"``, or the per-lane hit counts (L,)
    int64 for ``out="counts"``."""
    # lazy: the kernels are the lowest layer (tools/check_layering_torch.py)
    from repro_torch.core.engine.clock2qplus import step
    return replay_steps(step, state, trace, out)

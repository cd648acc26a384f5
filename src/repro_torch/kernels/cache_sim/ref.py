"""The plain PyTorch version of the ``cache_sim`` kernel.

A loop over the trace of the lane-batched Clock2Q+ step
(``repro_torch.core.engine.clock2qplus.step``).  It computes exactly the
function of ``csrc/cache_sim.cu`` on any device: the CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.engine.clock2qplus import step


def cache_sim_plain(state: Dict[str, torch.Tensor], trace: torch.Tensor,
                    out: str = "hits") -> torch.Tensor:
    """Replay ``trace`` through every lane of ``state``, in place.

    ``trace`` is (T,) (one row shared by all lanes) or (L, T) (one row
    per lane); keys < 0 are no-op padding.  Returns the per-request hits
    (L, T) bool for ``out="hits"``, or the per-lane hit counts (L,)
    int64 for ``out="counts"``."""
    L = state["spos"].shape[0]
    T = trace.shape[-1]
    hits = torch.zeros((L, T), dtype=torch.bool, device=trace.device)
    for t in range(T):
        key = trace[t].expand(L) if trace.dim() == 1 else trace[:, t]
        _, hits[:, t] = step(state, key)
    if out == "counts":
        return hits.sum(dim=1, dtype=torch.int64)
    return hits

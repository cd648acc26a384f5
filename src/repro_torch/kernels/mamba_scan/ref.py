"""Plain PyTorch version of the selective-scan kernel.

The function of ``repro.kernels.mamba_scan.ref.mamba_scan_ref``, the
sequential recurrence, in fp32: with A = -exp(A_log), each step
h <- exp(dt A) h + (dt u) B and y = sum_N h C.  y is cast to u's type
once at the end (``repro.models.mamba.mamba1_full`` casts each chunk's
fp32 y the same way).  Unlike the reference it also returns the final
state, which the model's decode needs.
"""

from __future__ import annotations

import torch


def mamba_scan_plain(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                     Cc: torch.Tensor, A_log: torch.Tensor):
    """u/dt: (B, S, din); Bc/Cc: (B, S, N); A_log: (din, N) ->
    (y (B, S, din) in u's type, h_last (B, din, N) fp32)."""
    A = -torch.exp(A_log.float())                              # (din, N)
    uf, dtf, bf, cf = (t.float() for t in (u, dt, Bc, Cc))
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[-1]),
                    dtype=torch.float32, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        dA = torch.exp(dtf[:, t, :, None] * A)                 # (B, din, N)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1).to(u.dtype), h

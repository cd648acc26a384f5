"""Plain PyTorch version of the selective-scan kernels.

The function of ``repro.kernels.mamba_scan.ref.mamba_scan_ref``, the
sequential recurrence, in fp32: with A = -exp(A_log), each step
h <- exp(dt A) h + (dt u) B and y = sum_N h C.  y is cast to u's type
once at the end (``repro.models.mamba.mamba1_full`` casts each chunk's
fp32 y the same way).  Unlike the reference it also returns the final
state, which the model's decode needs, and, asked for, the state before
every ``STATE_CHUNK`` steps, which the backward starts from.

``mamba_scan_bwd_plain`` is the gradient of that function: the reverse
recurrence, the oracle of ``csrc/mamba_scan_bwd.cu`` and the CPU path of
``ops.MambaScan``.
"""

from __future__ import annotations

import torch

# Steps between the saved states: csrc/scan.cuh's kStateEvery (a quarter
# of the forward kernel's staged chunk of 64 steps).
STATE_CHUNK = 16


def mamba_scan_plain(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                     Cc: torch.Tensor, A_log: torch.Tensor,
                     chunk_states: bool = False):
    """u/dt: (B, S, din); Bc/Cc: (B, S, N); A_log: (din, N) ->
    (y (B, S, din) in u's type, h_last (B, din, N) fp32), and with
    ``chunk_states`` also states (B, ceil(S / STATE_CHUNK), din, N) fp32:
    h before each chunk of ``STATE_CHUNK`` steps, the first zeros."""
    A = -torch.exp(A_log.float())                              # (din, N)
    uf, dtf, bf, cf = (t.float() for t in (u, dt, Bc, Cc))
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[-1]),
                    dtype=torch.float32, device=u.device)
    ys, states = [], []
    for t in range(u.shape[1]):
        if t % STATE_CHUNK == 0:
            states.append(h)
        dA = torch.exp(dtf[:, t, :, None] * A)                 # (B, din, N)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1))
    y = torch.stack(ys, dim=1).to(u.dtype)
    if chunk_states:
        return y, h, torch.stack(states, dim=1)
    return y, h


def mamba_scan_bwd_plain(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                         Cc: torch.Tensor, A_log: torch.Tensor,
                         states: torch.Tensor, dy: torch.Tensor,
                         dh_last: torch.Tensor | None = None):
    """The gradients (du, ddt, dB, dC, dA_log) of ``mamba_scan_plain``
    given ``states`` (its ``chunk_states``), y's gradient ``dy`` (B, S,
    din) and h_last's ``dh_last`` (B, din, N) or None, computed in fp32
    and returned in the inputs' types (dA_log fp32).  With a_t =
    exp(dt_t A) and g_t the gradient reaching h_t,

        g_t = dy_t C_t + a_{t+1} g_{t+1}   (g_{S-1} gets dh_last too)
        dC_t = sum_d dy_t h_t          dB_t = sum_d g_t dt_t u_t
        du_t = sum_n g_t dt_t B_t
        ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1})
        dA_log = A sum_{b,t} g_t dt_t a_t h_{t-1},

    walking the chunks from the last, each chunk's h recomputed from its
    saved state."""
    A = -torch.exp(A_log.float())
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, Bc, Cc, dy))
    Bsz, S, din = u.shape
    carry = (torch.zeros((Bsz, din, A.shape[-1]), dtype=torch.float32,
                         device=u.device)
             if dh_last is None else dh_last.float())   # a_{t+1} g_{t+1}
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    dB, dC = torch.empty_like(bf), torch.empty_like(cf)
    dA = torch.zeros_like(A)
    for t0 in reversed(range(0, S, STATE_CHUNK)):
        hs = [states[:, t0 // STATE_CHUNK].float()]
        for t in range(t0, min(S, t0 + STATE_CHUNK)):
            a = torch.exp(dtf[:, t, :, None] * A)
            hs.append(a * hs[-1] + (dtf[:, t] * uf[:, t])[..., None]
                      * bf[:, t, None, :])
        for t in reversed(range(t0, min(S, t0 + STATE_CHUNK))):
            h, h_prev = hs[t - t0 + 1], hs[t - t0]
            a = torch.exp(dtf[:, t, :, None] * A)
            g = dyf[:, t, :, None] * cf[:, t, None, :] + carry
            dC[:, t] = torch.sum(dyf[:, t, :, None] * h, dim=1)
            dB[:, t] = torch.sum(g * (dtf[:, t] * uf[:, t])[..., None], dim=1)
            gb = torch.sum(g * bf[:, t, None, :], dim=-1)
            du[:, t] = dtf[:, t] * gb
            gah = g * a * h_prev
            ddt[:, t] = uf[:, t] * gb + torch.sum(gah * A, dim=-1)
            dA += torch.sum(gah * dtf[:, t, :, None], dim=0)
            carry = a * g
    return (du.to(u.dtype), ddt.to(dt.dtype), dB.to(Bc.dtype),
            dC.to(Cc.dtype), A * dA)

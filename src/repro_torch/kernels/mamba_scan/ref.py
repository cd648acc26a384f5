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

``mamba_scan_bf16_plain`` is the other function, the one
``repro.models.mamba.mamba1_full`` computes under its
``mamba_bf16_scan`` flag: over chunks of ``chunk`` steps, dA and dt u B
rounded to bf16 and combined by ``jax.lax.associative_scan``'s
recursion in bf16 (``associative_scan_bf16``), the carry applied and y
summed as the reference rounds them.  ``scan_walk_bf16`` computes the
same prefixes in the order ``csrc/mamba_scan_bf16.cu`` walks them.  With
``bf16_chunk``, ``mamba_scan_bwd_plain`` is that function's
straight-through gradient.
"""

from __future__ import annotations

import torch

# Steps between the saved states: csrc/scan.cuh's kStateEvery (a quarter
# of the forward kernel's staged chunk of 64 steps).
STATE_CHUNK = 16
BF16 = torch.bfloat16


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
                         dh_last: torch.Tensor | None = None,
                         bf16_chunk: int = 0):
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
    saved state.

    With ``bf16_chunk`` C > 0, the gradient of ``mamba_scan_bf16_plain``
    at that chunk, straight through its roundings: the same recurrence on
    a_t and dt u B rounded to bf16, C rounded to bf16, and h_{t-1}
    rounded to bf16 where t starts a chunk (the forward's carry)."""
    A = -torch.exp(A_log.float())
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, Bc, Cc, dy))
    rnd = (lambda t: t.to(BF16).float()) if bf16_chunk else (lambda t: t)
    cf = rnd(cf)

    def h_in(t, h):     # h_{t-1} as step t reads it
        return rnd(h) if bf16_chunk and t % bf16_chunk == 0 else h
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
            a = rnd(torch.exp(dtf[:, t, :, None] * A))
            hs.append(a * h_in(t, hs[-1]) + rnd(
                (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]))
        for t in reversed(range(t0, min(S, t0 + STATE_CHUNK))):
            h, h_prev = hs[t - t0 + 1], h_in(t, hs[t - t0])
            a = rnd(torch.exp(dtf[:, t, :, None] * A))
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


def _along(t: torch.Tensor, dim: int, sl: slice) -> torch.Tensor:
    return t[(slice(None),) * dim + (sl,)]


def _comb(e1, e2):
    """The reference's combine, ``(a1 a2, b1 a2 + b2)``: in bf16 each
    product and the sum round."""
    (a1, b1), (a2, b2) = e1, e2
    return a1 * a2, b1 * a2 + b2


def associative_scan_bf16(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive prefixes of the pairs (a, b) along ``dim`` under
    ``_comb``, by ``jax.lax.associative_scan``'s recursion: combine
    neighbouring pairs (slices of stride 2), scan those, combine the
    results with the even elements, interleave.  On bf16 tensors every
    operation rounds where the reference's does."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    ev = lambda t, start, stop=None: _along(t, dim, slice(start, stop, 2))
    odd = associative_scan_bf16(*_comb((ev(a, 0, -1), ev(b, 0, -1)),
                                       (ev(a, 1), ev(b, 1))), dim)
    if n % 2 == 0:
        odd_in = tuple(_along(t, dim, slice(0, -1)) for t in odd)
    else:
        odd_in = odd
    even = _comb(odd_in, (ev(a, 2), ev(b, 2)))
    out = []
    for x, e, o in zip((a, b), even, odd):
        r = torch.empty_like(x)
        _along(r, dim, slice(0, 1)).copy_(_along(x, dim, slice(0, 1)))
        _along(r, dim, slice(2, None, 2)).copy_(e)
        _along(r, dim, slice(1, None, 2)).copy_(o)
        out.append(r)
    return tuple(out)


def scan_walk_bf16(a: torch.Tensor, b: torch.Tensor):
    """The prefixes of ``associative_scan_bf16`` along dim 1, in the
    order the kernel walks them: a binary counter over the steps.  Each
    step is pushed as a block of size 1; while the two top blocks have
    the same size, they are replaced by ``_comb(lower, upper)``; the
    prefix is the left fold of the blocks, the largest first.  Equal bit
    for bit to the recursion (tests/test_torch_ssm_bf16.py)."""
    stack, pa, pb = [], [], []
    for t in range(a.shape[1]):
        size, blk = 1, (a[:, t], b[:, t])
        while stack and stack[-1][0] == size:
            _, low = stack.pop()
            size, blk = 2 * size, _comb(low, blk)
        stack.append((size, blk))
        acc = stack[0][1]
        for _, e in stack[1:]:
            acc = _comb(acc, e)
        pa.append(acc[0])
        pb.append(acc[1])
    return torch.stack(pa, dim=1), torch.stack(pb, dim=1)


def mamba_scan_bf16_plain(u: torch.Tensor, dt: torch.Tensor,
                          Bc: torch.Tensor, Cc: torch.Tensor,
                          A_log: torch.Tensor, chunk: int,
                          chunk_states: bool = False):
    """The reference's scan under ``mamba_bf16_scan``
    (``repro.models.mamba.mamba1_full``), chunks of ``chunk`` steps from
    h = 0; the shapes and outputs of ``mamba_scan_plain``.  In a chunk:
    dA = bf16(exp(dt A)) and dBu = bf16(dt u B) (products in fp32), their
    prefixes by ``associative_scan_bf16``, hs = b_cum + a_cum bf16(h)
    (each operation rounded to bf16), y = sum_N hs bf16(C) summed in fp32
    (bf16 products are exact there) and cast once to u's type; the carry
    h is fp32(hs) at the chunk's last step.  (The reference's einsum is
    bf16, then cast to u's type: for bf16 u that is this rounding, and for
    fp32 u XLA drops the bf16 round trip and keeps the fp32 sum, as this
    does.)  A ragged last chunk
    is padded as the reference pads it, with identity steps (dt = 0:
    dA = 1, dBu = 0, exact in bf16), which change only its carry's order
    of combination.  h_last is that carry; ``chunk_states`` gives hs
    before every ``STATE_CHUNK`` steps (h at a chunk's start)."""
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, not {chunk}")
    A = -torch.exp(A_log.float())
    Bsz, S, din = u.shape
    N = A.shape[-1]
    h = torch.zeros((Bsz, din, N), dtype=torch.float32, device=u.device)
    cb = Cc.to(BF16).float()
    ys, states = [], []
    for c0 in range(0, S, chunk):
        n = min(chunk, S - c0)
        dtc = dt[:, c0:c0 + n].float()
        dA = torch.exp(dtc[..., None] * A).to(BF16)        # (B, n, din, N)
        dBu = ((dtc * u[:, c0:c0 + n].float())[..., None]
               * Bc[:, c0:c0 + n].float()[:, :, None, :]).to(BF16)
        if n < chunk:
            pad = (Bsz, chunk - n, din, N)
            dA = torch.cat([dA, dA.new_ones(pad)], dim=1)
            dBu = torch.cat([dBu, dBu.new_zeros(pad)], dim=1)
        a_cum, b_cum = associative_scan_bf16(dA, dBu, 1)
        hs = b_cum + a_cum * h.to(BF16)[:, None]
        ys.append((hs[:, :n].float() * cb[:, c0:c0 + n, None, :]).sum(-1)
                  .to(u.dtype))
        if chunk_states:
            for t in range(-(-c0 // STATE_CHUNK) * STATE_CHUNK, c0 + n,
                           STATE_CHUNK):
                states.append(h if t == c0 else hs[:, t - c0 - 1].float())
        h = hs[:, -1].float()
    y = torch.cat(ys, dim=1)
    if chunk_states:
        return y, h, torch.stack(states, dim=1)
    return y, h

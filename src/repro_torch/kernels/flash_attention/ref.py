"""Plain PyTorch version of the flash-attention kernel: exact softmax.

The function of ``repro.kernels.flash_attention.ops.flash_attention``
on its public layout, with grouped-query attention by head index (query
head ``h`` reads KV head ``h // (H // Hkv)``; nothing is repeated in
memory) and an fp32 softmax whose probabilities stay fp32 for the
product with V.  Causal masking is top-left aligned (``kpos <= qpos``),
with masked scores set to -1e30 as in the reference.

``flash_attention_lse_plain`` is the row log-sum-exp the forward kernel
hands its backward, and ``flash_attention_bwd_plain`` the backward
kernel's function, written out step by step, optionally with the bf16
kernel's roundings; the tests and ``chip_smoke.py`` hold the kernels to
them (a rounded comparison with ``flash_attention_bwd_rounding_slack``
added to its limit), and a test holds the latter to torch's own gradient
of ``flash_attention_plain``.
"""

from __future__ import annotations

import torch


def _masked(Sq: int, Skv: int, device) -> torch.Tensor:
    """(Sq, Skv): True where a causal score is masked (kpos > qpos)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    return torch.arange(Skv, device=device)[None, :] > qpos


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked fp32 scores (B, Hkv, G, Sq, Skv) of query head
    ``h * G + g`` against KV head ``h``."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (hd ** 0.5)
    if causal:
        s = s.masked_fill(_masked(Sq, Skv, q.device), -1e30)
    return s


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> torch.Tensor:
    """Each row's natural-log log-sum-exp of its scaled, masked scores:
    (B, H, Sq) fp32, query head h at index h."""
    B, Sq, H, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              round_to: torch.dtype | None = None):
    """(dq, dk, dv) in q's dtype from the forward's output ``o``, its
    ``lse`` (B, H, Sq) and the output's gradient ``do``, all in fp32:
    P recomputed from lse, dV = P^T dO, dP = dO V^T, D = rowsum(dO o O),
    dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q, with dK and
    dV summed over each KV head's query group.  ``round_to`` (e.g.
    torch.bfloat16) rounds P before P^T dO and dS before dS K and dS^T Q,
    where the tensor-core kernel rounds its operands; None rounds
    nothing."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / hd ** 0.5
    s = _scores(q, k, causal)                             # (B, Hkv, G, Sq, Skv)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq)[..., None])
    if causal:
        p = p.masked_fill(_masked(Sq, Skv, q.device), 0.0)
    dog = do.float().reshape(B, Sq, Hkv, G, hd)
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    rnd = ((lambda t: t) if round_to is None else
           (lambda t: t.to(round_to).float()))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    dsum = (do.float() * o.float()).sum(-1)               # (B, Sq, H)
    dsum = dsum.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    ds = rnd(p * (dp - dsum[..., None]))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _step(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each |x| (0 where x is 0)."""
    _, e = torch.frexp(x.abs())                  # |x| in [2^(e-1), 2^e)
    eps = torch.full_like(x, torch.finfo(dtype).eps)
    return torch.where(x == 0, 0 * eps, torch.ldexp(eps, e - 1))


def flash_attention_bwd_rounding_slack(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, o: torch.Tensor,
                                       lse: torch.Tensor, do: torch.Tensor,
                                       causal: bool = True,
                                       round_to: torch.dtype = torch.bfloat16,
                                       max_elements: int = 1 << 27):
    """(sdq, sdk, sdv), fp32 in the gradients' shapes: how far one step of
    ``round_to`` on the largest term of each element's sum moves it:
    scale max_j step(dS_ij) |K_jc| for dQ, scale max_i step(dS_ij) |Q_ic|
    and max_i step(P_ij) |dO_ic| (over the query group) for dK and dV.

    ``flash_attention_bwd_plain(round_to=...)`` and a kernel that rounds
    P and dS where it does round the same fp32 values, formed in another
    order; where one lies within an fp32 rounding of a tie the two round
    one step apart, and that term of the sum moves by this much.  A check
    adds it to its limit (``chip_smoke.bwd_case_check``).  Query rows
    are taken in chunks, so no intermediate exceeds ``max_elements``."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / hd ** 0.5
    s = _scores(q, k, causal)                             # (B, Hkv, G, Sq, Skv)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, Sq)[..., None])
    if causal:
        p = p.masked_fill(_masked(Sq, Skv, q.device), 0.0)
    dog = do.float().reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    qg = q.float().reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    dp = torch.einsum("bhgqd,bkhd->bhgqk", dog, v.float())
    dsum = (dog * o.float().reshape(B, Sq, Hkv, G, hd).permute(
        0, 2, 3, 1, 4)).sum(-1)                           # (B, Hkv, G, Sq)
    ups, uds = _step(p, round_to), _step(p * (dp - dsum[..., None]), round_to)
    del s, p, dp
    ka = k.float().abs().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Skv, hd)
    sdq = torch.empty_like(qg)
    sdk = torch.zeros((B, Hkv, G, Skv, hd), device=q.device)
    sdv = torch.zeros_like(sdk)
    rows = max(1, max_elements // (B * H * Skv * hd))
    for i in range(0, Sq, rows):
        u_s, u_p = uds[..., i:i + rows, :, None], ups[..., i:i + rows, :, None]
        sdq[..., i:i + rows, :] = (u_s * ka[..., None, :, :]).amax(-2)
        sdk = torch.maximum(sdk, (u_s * qg[..., i:i + rows, None, :].abs())
                            .amax(-3))
        sdv = torch.maximum(sdv, (u_p * dog[..., i:i + rows, None, :].abs())
                            .amax(-3))
    return (sdq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd) * scale,
            sdk.amax(2).permute(0, 2, 1, 3) * scale,
            sdv.amax(2).permute(0, 2, 1, 3))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)

"""Plain PyTorch version of the flash-attention kernel: exact softmax.

The function of ``repro.kernels.flash_attention.ops.flash_attention``
on its public layout, with grouped-query attention by head index (query
head ``h`` reads KV head ``h // (H // Hkv)``; nothing is repeated in
memory) and an fp32 softmax whose probabilities stay fp32 for the
product with V.  Causal masking is top-left aligned (``kpos <= qpos``),
with masked scores set to -1e30 as in the reference.
"""

from __future__ import annotations

import torch


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / (hd ** 0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)

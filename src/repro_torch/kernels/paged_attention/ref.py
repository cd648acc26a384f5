"""Plain PyTorch version of the paged-attention decode kernel.

The function of ``repro.kernels.paged_attention.ref.paged_attention_ref``
(which mirrors the decode attention of ``forward_decode_paged``): gather
each sequence's blocks through its block table, mask positions at or
past its length with -1e30, exact fp32 softmax.  Grouped-query attention
goes by head index: query head ``h`` reads KV head ``h // (H // Hkv)``.
"""

from __future__ import annotations

import torch


def paged_attention_plain(q: torch.Tensor, kpool: torch.Tensor,
                          vpool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d); kpool/vpool: (N, bs, Hkv, d); block_tables: (B, nb);
    lengths: (B,) -> (B, H, d)."""
    B, H, d = q.shape
    _, bs, Hkv, _ = kpool.shape
    bt = block_tables.long()
    k = kpool[bt].reshape(B, -1, Hkv, d).float()      # (B, nb*bs, Hkv, d)
    v = vpool[bt].reshape(B, -1, Hkv, d).float()
    qg = q.float().reshape(B, Hkv, H // Hkv, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k) / (d ** 0.5)
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None] < lengths.to(q.device).long()[:, None]   # (B, S')
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return o.reshape(B, H, d).to(q.dtype)

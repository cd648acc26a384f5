"""Zamba2-style hybrid stack: Mamba2 layers + ONE shared attention+MLP
block invoked every ``shared_attn_every`` layers (weights reused across
invocations).

The port of ``repro.models.hybrid``.  In the full forward the shared
block's causal attention is the ``flash_attention`` kernel, as in the
dense ``forward_prefill``; in decode the shared block is the dense
``transformer.block_decode`` (its attention ``layers.decode_attention``,
the ``paged_attention`` kernel over the contiguous KV cache seen as one
page a sequence; the reference's plain ``attention`` with ``kv_len``).

Decode state: per-layer Mamba2 (conv, ssm) states + a KV cache per
shared-block invocation (G = n_layers // shared_attn_every caches).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class HybridCache(NamedTuple):
    """Decode state of the hybrid stack."""

    conv: torch.Tensor   # (L, B, K-1, d_inner)
    ssm: torch.Tensor    # (L, B, nh, N, P) fp32
    k: torch.Tensor      # (G, B, S_max, H_kv, hd)
    v: torch.Tensor
    length: int          # positions filled


def n_shared_invocations(cfg: ModelConfig) -> int:
    """G: how many times the shared block runs in one forward pass."""
    return max(1, cfg.n_layers // max(1, cfg.shared_attn_every))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params from ``generator``, on the card unless ``device``
    names another (the generator must live there).  The reference's tree
    and shapes; Mamba2 blocks stacked on a leading layer axis."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    pd = L.pdtype_of(cfg)
    return {
        "embed": {"tok": L.embed_init(generator, (cfg.vocab, cfg.d_model),
                                      pd),
                  "final_norm": L.norm_params(cfg, device=dev),
                  "lm_head": L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                          pd)},
        "mamba": M.mamba2_params(cfg, generator, (cfg.n_layers,)),
        "shared": {"ln1": L.norm_params(cfg, device=dev),
                   "attn": L.attn_params(cfg, generator),
                   "ln2": L.norm_params(cfg, device=dev),
                   "mlp": L.mlp_params(cfg, generator)},
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> HybridCache:
    """A zeroed cache, on the card unless ``device`` names another."""
    dev = resolve_device(device)
    din, N, P, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                    cfg.ssm_conv)
    nh = din // P
    G = n_shared_invocations(cfg)
    dt = L.dtype_of(cfg)
    kv = (G, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return HybridCache(
        conv=torch.zeros((cfg.n_layers, batch, K - 1, din), dtype=dt,
                         device=dev),
        ssm=torch.zeros((cfg.n_layers, batch, nh, N, P), dtype=torch.float32,
                        device=dev),
        k=torch.zeros(kv, dtype=dt, device=dev),
        v=torch.zeros(kv, dtype=dt, device=dev), length=0)


def _attn_out(cfg: ModelConfig, p: Dict, x, o):
    x = x + L.settle(o.reshape(*o.shape[:2], -1) @ p["attn"]["wo"])
    h = L.make_norm(cfg)(x, p["ln2"])
    return x + L.mlp_apply(cfg, p["mlp"], h)


def shared_qkv(cfg: ModelConfig, p: Dict, x, rope):
    """The shared block's attention inputs over a whole sequence: q, k, v
    (B, S, H, hd) after the norm, the projections and the rotation by
    ``rope`` (the forward's ``layers.rope_tables``)."""
    q, k, v = L.qkv_proj(cfg, p["attn"], L.make_norm(cfg)(x, p["ln1"]))
    return L.rotate(q, rope), L.rotate(k, rope), v


def _shared_block_full(cfg: ModelConfig, p: Dict, x, rope):
    """The shared block over a whole sequence; ``rope``: the forward's
    ``layers.rope_tables``.  Returns (x, (k, v))."""
    q, k, v = shared_qkv(cfg, p, x, rope)
    o = L.flash_attention(q, k, v, causal=True)
    return _attn_out(cfg, p, x, o), (k, v)


def forward_full(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 collect_cache: bool = False, max_len: Optional[int] = None,
                 full_logits: bool = True, remat: bool = True):
    """tokens (B, S) -> (logits, HybridCache or None).  Logits cover
    every position unless ``full_logits`` is False (then the last one).
    ``collect_cache``: also return the decode state, its KV caches padded
    to ``max_len`` (default S) positions.  The training call
    (``collect_cache=False``, grad on) recomputes each Mamba2 body in the
    backward pass when ``remat``, as the reference does; the shared
    block's attention gets its gradient from the flash backward kernel."""
    x = T.embed_tokens(cfg, params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_frac)
    k_every = max(1, cfg.shared_attn_every)
    max_len = max_len or S
    convs, ssms, ks, vs = [], [], [], []
    layers = L.unstack(params["mamba"], cfg.n_layers)
    for g in range(n_shared_invocations(cfg)):
        for i in range(g * k_every, (g + 1) * k_every):
            p = layers[i]
            if collect_cache:
                x, (cs, ss) = M.mamba2_full(cfg, p, x, return_state=True)
                convs.append(cs)
                ssms.append(ss)
            else:
                x = L.checkpointed(lambda x, p: M.mamba2_full(cfg, p, x),
                                   x, p, remat=remat)
        x, (k, v) = _shared_block_full(cfg, params["shared"], x, rope)
        if collect_cache:
            pad = (0, 0, 0, 0, 0, max_len - S)
            ks.append(torch.nn.functional.pad(k, pad))
            vs.append(torch.nn.functional.pad(v, pad))

    logits = T.lm_logits(cfg, params["embed"],
                         x if full_logits else x[:, -1:])
    cache = None
    if collect_cache:
        cache = HybridCache(conv=torch.stack(convs), ssm=torch.stack(ssms),
                            k=torch.stack(ks), v=torch.stack(vs), length=S)
    return logits, cache


def forward_decode(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: HybridCache):
    """tokens (B, 1) -> (logits (B, 1, V), HybridCache).  The new conv
    and SSM states are new tensors; the KV caches are the same tensors,
    written in place at position ``cache.length``."""
    x = T.embed_tokens(cfg, params["embed"], tokens)
    pos = cache.length
    rope = T.decode_rope(cfg, x.shape[0], pos, x.device)
    k_every = max(1, cfg.shared_attn_every)
    convs, ssms = [], []
    for g in range(n_shared_invocations(cfg)):
        for i in range(g * k_every, (g + 1) * k_every):
            p = L.layer(params["mamba"], i)
            x, cs, ss = M.mamba2_decode(cfg, p, x, cache.conv[i],
                                        cache.ssm[i])
            convs.append(cs)
            ssms.append(ss)
        x = T.block_decode(cfg, params["shared"], x, pos, cache.k[g],
                           cache.v[g], rope)
    logits = T.lm_logits(cfg, params["embed"], x)
    return logits, HybridCache(conv=torch.stack(convs),
                               ssm=torch.stack(ssms), k=cache.k, v=cache.v,
                               length=pos + 1)

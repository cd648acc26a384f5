"""Decoder-only transformer, dense family, for serving.

The port of ``repro.models.transformer`` for the dense family, with the
same param tree: ``{"embed": {...}, "blocks": {...}}`` where every block
leaf is stacked on a leading layer axis and keeps the reference's
``(in, out)`` orientation, so ``model.params_from_numpy`` is a plain
copy of the reference's params.  Two entry points serve the engine:

  * ``forward_prefill`` — full-sequence causal forward returning the KV
    cache; attention runs the ``flash_attention`` kernel.
  * ``forward_decode_paged`` — one token per sequence against the paged
    KV pool; attention runs the ``paged_attention`` kernel.

The moe and vlm families, ``forward_train``, ``forward_decode`` and the
buffered decode are ROADMAP.md queue 1 work; a non-dense config raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class KVCache(NamedTuple):
    """The prefill's KV cache: k/v (L, B, S, H_kv, hd) and its length."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port's transformer runs the dense family only, not "
            f"{cfg.family!r} ({cfg.name}); the moe and vlm families are "
            f"ROADMAP.md queue 1, item 9")


# -- params ------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params from ``generator`` (seeded by the caller), on the
    card unless ``device`` names another; the generator must live on the
    same device.  The tree and shapes are the reference's; the values
    are the port's own (a torch generator does not give ``jax.random``'s
    numbers; tests carry the reference's params with
    ``model.params_from_numpy``)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    pd, n = L.pdtype_of(cfg), cfg.n_layers
    embed = {"tok": L.embed_init(generator, (cfg.vocab, cfg.d_model), pd),
             "final_norm": L.norm_params(cfg, device=dev)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                        pd)
    blocks = {"ln1": L.norm_params(cfg, (n,), device=dev),
              "attn": L.attn_params(cfg, generator, (n,)),
              "ln2": L.norm_params(cfg, (n,), device=dev),
              "mlp": L.mlp_params(cfg, generator, (n,))}
    return {"embed": embed, "blocks": blocks}


# -- embedding / head ------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, p: Dict, tokens: torch.Tensor):
    """Token embeddings in the activation dtype."""
    return p["tok"][tokens].to(L.dtype_of(cfg))


def lm_logits(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the LM head (the tied embedding where configured)."""
    x = L.make_norm(cfg)(x, p["final_norm"])
    head = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ head.to(x.dtype)


# -- forward passes ----------------------------------------------------------------------

def _mlp_residual(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    return x + L.mlp_apply(cfg, p["mlp"], L.make_norm(cfg)(x, p["ln2"]))


def forward_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    full_logits: bool = False):
    """tokens (B, S) -> (logits, KVCache).  Logits cover the last
    position only unless ``full_logits`` (the serving engine's
    length-bucketed prefill reads the last real token, not the last
    position).  Attention is the ``flash_attention`` kernel, causal."""
    _dense_only(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_frac)
    norm = L.make_norm(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        q, k, v = L.qkv_proj(cfg, p["attn"], norm(x, p["ln1"]))
        q, k = L.rotate(q, rope), L.rotate(k, rope)
        o = flash_ops.flash_attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
        x = _mlp_residual(cfg, p, x)
        ks.append(k)
        vs.append(v)
    logits = lm_logits(cfg, params["embed"], x if full_logits else x[:, -1:])
    return logits, KVCache(torch.stack(ks), torch.stack(vs), S)


def forward_decode_paged(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                         kpool: torch.Tensor, vpool: torch.Tensor,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         slot_ids: torch.Tensor, slot_offs: torch.Tensor):
    """Paged decode, one token per sequence.

    tokens (B, 1); kpool/vpool (L, N, bs, H_kv, hd); block_tables
    (B, nb) int32; lengths (B,) int32, the current context length (the
    new token's position); slot_ids/slot_offs (B,) where this step's k/v
    go in the pool.  Each layer scatters this step's k/v into
    ``kpool[l]``/``vpool[l]`` in place, on the current stream, before
    the ``paged_attention`` kernel reads the pool over ``lengths + 1``
    positions.  Returns (logits (B, 1, V), kpool, vpool); the pools are
    the same tensors, updated in place (the reference returns new
    arrays).
    """
    _dense_only(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    B = tokens.shape[0]
    norm = L.make_norm(cfg)
    rope = L.rope_tables(lengths[:, None], cfg.hd, cfg.rope_theta,
                         cfg.rope_frac)                # at (B, 1) positions
    ctx = (lengths + 1).to(torch.int32)
    sid, soff = slot_ids.long(), slot_offs.long()
    paged_ops.check_values(block_tables, ctx, kpool.shape[1], kpool.shape[2])
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        q, k, v = L.qkv_proj(cfg, p["attn"], norm(x, p["ln1"]))
        q, k = L.rotate(q, rope), L.rotate(k, rope)
        kpool[i].index_put_((sid, soff), k[:, 0])
        vpool[i].index_put_((sid, soff), v[:, 0])
        o = paged_ops.paged_attention(q[:, 0], kpool[i], vpool[i],
                                      block_tables, ctx, validate=False)
        x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
        x = _mlp_residual(cfg, p, x)
    return lm_logits(cfg, params["embed"], x), kpool, vpool

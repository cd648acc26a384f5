"""Decoder-only transformer (dense / vlm / moe families), for serving.

The port of ``repro.models.transformer``, with the same param tree:
``{"embed": {...}, "blocks": {...}}`` where every block leaf is stacked
on a leading layer axis and keeps the reference's ``(in, out)``
orientation, so ``model.params_from_numpy`` is a plain copy of the
reference's params.  A block's channel mixing (``_mix``) is the MLP, or
for the moe family the routed experts of ``models/moe.py``; the vlm
family prepends projected patch embeddings to the tokens
(``embed_inputs``).  Two entry points serve the engine:

  * ``forward_prefill`` — full-sequence causal forward returning the KV
    cache; attention runs the ``flash_attention`` kernel.
  * ``forward_decode_paged`` — one token per sequence against the paged
    KV pool; attention runs the ``paged_attention`` kernel.

``forward_train``, ``forward_decode`` and the buffered decode are
ROADMAP.md queue 1 work (items 10 and 12).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig

FAMILIES = ("dense", "vlm", "moe")


class KVCache(NamedTuple):
    """The prefill's KV cache: k/v (L, B, S, H_kv, hd) and its length."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the transformer runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} ({cfg.name})")


# -- params ------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params from ``generator`` (seeded by the caller), on the
    card unless ``device`` names another; the generator must live on the
    same device.  The tree and shapes are the reference's; the values
    are the port's own (a torch generator does not give ``jax.random``'s
    numbers; tests carry the reference's params with
    ``model.params_from_numpy``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    pd, n = L.pdtype_of(cfg), cfg.n_layers
    embed = {"tok": L.embed_init(generator, (cfg.vocab, cfg.d_model), pd),
             "final_norm": L.norm_params(cfg, device=dev)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.vocab),
                                        pd)
    if cfg.frontend == "patch_stub":
        embed["mm_proj"] = L.dense_init(generator, (cfg.d_model, cfg.d_model),
                                        pd)
    blocks = {"ln1": L.norm_params(cfg, (n,), device=dev),
              "attn": L.attn_params(cfg, generator, (n,)),
              "ln2": L.norm_params(cfg, (n,), device=dev)}
    if cfg.family == "moe":
        blocks["moe"] = moe_lib.moe_params(cfg, generator, (n,))
    else:
        blocks["mlp"] = L.mlp_params(cfg, generator, (n,))
    return {"embed": embed, "blocks": blocks}


# -- embedding / head ------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, p: Dict, tokens: torch.Tensor):
    """Token embeddings in the activation dtype."""
    return p["tok"][tokens].to(L.dtype_of(cfg))


def embed_inputs(cfg: ModelConfig, p: Dict, tokens: torch.Tensor,
                 patch_embeds=None) -> torch.Tensor:
    """Token embeddings, with the stub frontend's patch embeddings
    (B, P, D), through the learned projector ``mm_proj``, prepended."""
    x = embed_tokens(cfg, p, tokens)
    if patch_embeds is None:
        return x
    if cfg.frontend != "patch_stub":
        raise ValueError(f"{cfg.name} has no patch frontend")
    pe = patch_embeds.to(L.dtype_of(cfg)) @ p["mm_proj"]
    return torch.cat([pe, x], dim=1)


def lm_logits(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the LM head (the tied embedding where configured)."""
    x = L.make_norm(cfg)(x, p["final_norm"])
    head = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ head.to(x.dtype)


# -- forward passes ----------------------------------------------------------------------

def _mix(cfg: ModelConfig, p: Dict, x: torch.Tensor, decode: bool = False):
    """The channel-mixing half (MLP or MoE).  Returns (out, aux_loss):
    the MoE's fp32 scalar, or 0.0 for the MLP."""
    if cfg.family == "moe":
        return moe_lib.moe_apply(cfg, p["moe"], x, decode=decode)
    return L.mlp_apply(cfg, p["mlp"], x), 0.0


def _mix_residual(cfg: ModelConfig, p: Dict, x: torch.Tensor, decode: bool):
    m, _ = _mix(cfg, p, L.make_norm(cfg)(x, p["ln2"]), decode)
    return x + m


def forward_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    full_logits: bool = False, patch_embeds=None):
    """tokens (B, S) -> (logits, KVCache).  With ``patch_embeds`` (B, P,
    D; the vlm family) the sequence is the P projected patches followed
    by the S tokens, and the cache and full logits cover all P + S
    positions.  Logits cover the last position only unless
    ``full_logits`` (the serving engine's length-bucketed prefill reads
    the last real token, not the last position).  Attention is the
    ``flash_attention`` kernel, causal."""
    _check_family(cfg)
    x = embed_inputs(cfg, params["embed"], tokens, patch_embeds)
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
        x = _mix_residual(cfg, p, x, decode=False)
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

    Rows that name one slot (the serving engine pads a moe batch with
    copies of its last row) write the first such row's k/v there.  A
    moe row's output depends on the others through the experts'
    capacity, so a padded copy that lost its experts would otherwise
    overwrite the real row's k/v with its own; the reference's scatter
    lets the last row win (ROADMAP.md queue 3).  Other families' copies
    compute equal values, and write them as they are.
    """
    _check_family(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    B = tokens.shape[0]
    norm = L.make_norm(cfg)
    rope = L.rope_tables(lengths[:, None], cfg.hd, cfg.rope_theta,
                         cfg.rope_frac)                # at (B, 1) positions
    ctx = (lengths + 1).to(torch.int32)
    sid, soff = slot_ids.long(), slot_offs.long()
    paged_ops.check_values(block_tables, ctx, kpool.shape[1], kpool.shape[2])
    writer = None
    if cfg.family == "moe":  # the first row naming each row's slot
        flat = sid * kpool.shape[2] + soff
        writer = torch.argmax((flat[:, None] == flat[None, :]).int(), dim=1)
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        q, k, v = L.qkv_proj(cfg, p["attn"], norm(x, p["ln1"]))
        q, k = L.rotate(q, rope), L.rotate(k, rope)
        k, v = k[:, 0], v[:, 0]
        if writer is not None:
            k, v = k[writer], v[writer]
        kpool[i].index_put_((sid, soff), k)
        vpool[i].index_put_((sid, soff), v)
        o = paged_ops.paged_attention(q[:, 0], kpool[i], vpool[i],
                                      block_tables, ctx, validate=False)
        x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
        x = _mix_residual(cfg, p, x, decode=True)
    return lm_logits(cfg, params["embed"], x), kpool, vpool

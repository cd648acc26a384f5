"""Decoder-only transformer (dense / vlm / moe families), for serving.

The port of ``repro.models.transformer``, with the same param tree:
``{"embed": {...}, "blocks": {...}}`` where every block leaf is stacked
on a leading layer axis and keeps the reference's ``(in, out)``
orientation, so ``model.params_from_numpy`` is a plain copy of the
reference's params.  A block's channel mixing (``_mix``) is the MLP, or
for the moe family the routed experts of ``models/moe.py``; the vlm
family prepends projected patch embeddings to the tokens
(``embed_inputs``).  The entry points:

  * ``forward_train`` — the full-sequence causal forward of training,
    returning the logits of every position and the summed MoE aux loss;
    each block runs under ``layers.checkpointed`` (its activations
    recomputed in the backward pass, as the reference's
    ``jax.checkpoint``), its attention the ``flash_attention`` kernel,
    whose gradient is the backward kernel.
  * ``forward_prefill`` — full-sequence causal forward returning the
    contiguous KV cache (``KVCache``, ``max_len`` positions); attention
    runs the ``flash_attention`` kernel.
  * ``forward_decode`` — one token per sequence against that cache,
    written in place at the cache's length; attention runs the
    ``paged_attention`` kernel on the cache seen as one page a sequence
    (``layers.decode_attention``).
  * ``forward_decode_buffered`` / ``commit_buffer`` — the same token
    against a head-major base plus a small ring (``BufferedKVCache``),
    merged by online softmax in plain torch, as in the reference.
  * ``forward_decode_paged`` — one token per sequence against the paged
    KV pool of the serving engine; attention runs ``paged_attention``.

Where the reference's ``jax.lax.dynamic_update_slice`` clamps a write
past the end of a cache onto its last slots, the port raises
``ValueError`` (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt

FAMILIES = ("dense", "vlm", "moe")


class KVCache(NamedTuple):
    """The contiguous KV cache: k/v (L, B, S_max, H_kv, hd) and the
    number of valid positions."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


class BufferedKVCache(NamedTuple):
    """A head-major base that decode steps only read, and a small ring
    that takes each step's k/v, committed to the base every R steps
    (``commit_buffer``)."""

    k: torch.Tensor      # (L, B, H_kv, S_max, hd): the base
    v: torch.Tensor
    bk: torch.Tensor     # (L, B, R, H_kv, hd): the ring
    bv: torch.Tensor
    base_len: int        # valid positions in the base
    buf_len: int         # valid positions in the ring


def _check_room(what: str, end: int, size: int) -> None:
    # the reference's dynamic_update_slice would clamp the write onto the
    # last slots; the port refuses it
    if end > size:
        raise ValueError(f"{what} would write up to position {end} of a "
                         f"cache of {size}")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the transformer runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} ({cfg.name})")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device=None) -> KVCache:
    """A zeroed cache of ``max_len`` positions, on the card unless
    ``device`` names another; k and v are separate tensors (decode
    writes them in place)."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev, dt = resolve_device(device), L.dtype_of(cfg)
    return KVCache(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev), 0)


def _new_cache(cfg: ModelConfig, batch: int, max_len: int,
               like: torch.Tensor) -> KVCache:
    """``init_kv_cache`` on ``like``'s device; where ``like`` is a
    DTensor, a DTensor cache on its mesh, placed by the sharding rules'
    ``cache_specs`` and made shard by shard."""
    if not dt.is_dtensor(like):
        return init_kv_cache(cfg, batch, max_len, device=like.device)
    from torch.distributed.tensor import zeros
    from repro_torch.sharding import rules
    mesh = like.device_mesh
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    spec = rules.cache_specs(cfg, mesh, KVCache(
        torch.empty(shape, device="meta"), torch.empty(shape, device="meta"),
        0)).k
    z = lambda: zeros(shape, dtype=L.dtype_of(cfg), device_mesh=mesh,
                      placements=rules.placements(mesh, spec))
    return KVCache(z(), z(), 0)


def init_buffered_cache(cfg: ModelConfig, batch: int, max_len: int,
                        buf_len: int = 256, device=None) -> BufferedKVCache:
    """A zeroed ``BufferedKVCache``: a base of ``max_len`` positions and
    a ring of ``buf_len``."""
    _check_family(cfg)
    dev, dt = resolve_device(device), L.dtype_of(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    bshape = (cfg.n_layers, batch, buf_len, cfg.n_kv_heads, cfg.hd)
    z = lambda s: torch.zeros(s, dtype=dt, device=dev)
    return BufferedKVCache(z(shape), z(shape), z(bshape), z(bshape), 0, 0)


def to_buffered(cache: KVCache, buf_len: int) -> BufferedKVCache:
    """A prefill's ``KVCache`` as a ``BufferedKVCache``: its k/v copied
    into the head-major base, ``base_len`` its length, an empty ring of
    ``buf_len`` positions."""
    L_, B, _, Hkv, hd = cache.k.shape
    ring = (L_, B, buf_len, Hkv, hd)
    z = lambda: cache.k.new_zeros(ring)
    return BufferedKVCache(cache.k.transpose(2, 3).contiguous(),
                           cache.v.transpose(2, 3).contiguous(), z(), z(),
                           int(cache.length), 0)


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
    """Token embeddings in the activation dtype (``layers.embed``)."""
    return L.embed(p["tok"], tokens).to(L.dtype_of(cfg))


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
    if dt.is_dtensor(x):  # the projector's columns gathered, as x's
        pe = dt.to_placements(pe, x.placements)
    return torch.cat([pe, x], dim=1)


def lm_logits(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the LM head (the tied embedding where configured)."""
    x = dt.reduce_grad(L.make_norm(cfg)(x, p["final_norm"]))
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


def _block(cfg: ModelConfig, p: Dict, x: torch.Tensor, rope):
    """One block over the whole sequence, causal: (x, aux, k, v), the
    MoE's aux loss (0.0 for the MLP) and the layer's rotated k and v for
    a cache."""
    B, S, _ = x.shape
    norm = L.make_norm(cfg)
    q, k, v = L.qkv_proj(cfg, p["attn"], norm(x, p["ln1"]))
    q, k = L.rotate(q, rope), L.rotate(k, rope)
    o = L.flash_attention(q, k, v, causal=True)
    x = x + L.settle(o.reshape(B, S, -1) @ p["attn"]["wo"])
    m, aux = _mix(cfg, p, norm(x, p["ln2"]))
    return x + m, aux, k, v


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict,
                  remat: bool = True):
    """batch: ``tokens`` (B, S) and, for the vlm family, ``patch_embeds``
    (B, P, D) -> (logits (B, P + S, V), aux loss, an fp32 scalar).  The
    embedding and blocks of ``forward_prefill`` with no cache writes;
    with ``remat`` each block's activations are recomputed in the
    backward pass."""
    _check_family(cfg)
    x = embed_inputs(cfg, params["embed"], batch["tokens"],
                     batch.get("patch_embeds"))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_frac)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in L.unstack(params["blocks"], cfg.n_layers):
        x, a = L.checkpointed(lambda x, p: _block(cfg, p, x, rope)[:2],
                              x, p, remat=remat)
        aux = aux + a
    return lm_logits(cfg, params["embed"], x), aux


def forward_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    max_len: Optional[int] = None, full_logits: bool = False,
                    patch_embeds=None):
    """tokens (B, S) -> (logits, KVCache).  With ``patch_embeds`` (B, P,
    D; the vlm family) the sequence is the P projected patches followed
    by the S tokens, and the cache and full logits cover all P + S
    positions.  The cache holds ``max_len`` positions (at least the
    sequence's; zeros past it), as the reference pads it.  Logits cover
    the last position only unless ``full_logits`` (the serving engine's
    length-bucketed prefill reads the last real token, not the last
    position).  Attention is the ``flash_attention`` kernel, causal."""
    _check_family(cfg)
    x = embed_inputs(cfg, params["embed"], tokens, patch_embeds)
    B, S, _ = x.shape
    cache = _new_cache(cfg, B, max(max_len or S, S), x)
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.rope_frac)
    for i in range(cfg.n_layers):
        x, _, k, v = _block(cfg, L.layer(params["blocks"], i), x, rope)
        L.write_seq(cache.k[i], 0, k, 1)
        L.write_seq(cache.v[i], 0, v, 1)
    logits = lm_logits(cfg, params["embed"], x if full_logits else x[:, -1:])
    return logits, cache._replace(length=S)


def decode_rope(cfg: ModelConfig, B: int, pos: int, device):
    """``layers.rope_tables`` of one decode step: every row at ``pos``."""
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=device)
    return L.rope_tables(posb, cfg.hd, cfg.rope_theta, cfg.rope_frac)


def block_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: int,
                 kc: torch.Tensor, vc: torch.Tensor, rope) -> torch.Tensor:
    """One-token block at position ``pos``: kc/vc (B, S_max, H_kv, hd),
    one layer of the cache, take this token's k/v at ``pos`` in place,
    then ``layers.decode_attention`` attends over pos + 1 positions;
    ``rope``: the step's ``layers.rope_tables``."""
    B = x.shape[0]
    q, k, v = L.qkv_proj(cfg, p["attn"], L.make_norm(cfg)(x, p["ln1"]))
    q, k = L.rotate(q, rope), L.rotate(k, rope)
    L.write_seq(kc, pos, k, 1)
    L.write_seq(vc, pos, v, 1)
    o = L.decode_attention(q, kc, vc, pos + 1)
    x = x + L.settle(o.reshape(B, 1, -1) @ p["attn"]["wo"])
    return _mix_residual(cfg, p, x, decode=True)


def forward_decode(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: KVCache):
    """tokens (B, 1) -> (logits (B, 1, V), KVCache with length + 1).  The
    cache's k/v are the same tensors, written in place at position
    ``cache.length`` (the reference returns new arrays)."""
    _check_family(cfg)
    pos = int(cache.length)
    _check_room("forward_decode", pos + 1, cache.k.shape[2])
    x = embed_tokens(cfg, params["embed"], tokens)
    rope = decode_rope(cfg, x.shape[0], pos, x.device)
    for i in range(cfg.n_layers):
        x = block_decode(cfg, L.layer(params["blocks"], i), x, pos,
                         cache.k[i], cache.v[i], rope)
    return lm_logits(cfg, params["embed"], x), KVCache(cache.k, cache.v,
                                                       pos + 1)


def forward_decode_buffered(cfg: ModelConfig, params: Dict,
                            tokens: torch.Tensor, cache: BufferedKVCache):
    """One decode token against base + ring: this step's k/v go into the
    ring at ``buf_len`` in place, and attention is the online-softmax
    merge of a partial over the base's ``base_len`` positions and one
    over the ring's ``buf_len + 1``.  Returns (logits (B, 1, V), the
    cache with ``buf_len + 1``)."""
    _check_family(cfg)
    _check_room("forward_decode_buffered's ring write", cache.buf_len + 1,
                cache.bk.shape[2])
    x = embed_tokens(cfg, params["embed"], tokens)
    B = x.shape[0]
    rope = decode_rope(cfg, B, cache.base_len + cache.buf_len, x.device)
    norm = L.make_norm(cfg)
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        q, k, v = L.qkv_proj(cfg, p["attn"], norm(x, p["ln1"]))
        q, k = L.rotate(q, rope), L.rotate(k, rope)
        cache.bk[i, :, cache.buf_len] = k[:, 0]
        cache.bv[i, :, cache.buf_len] = v[:, 0]
        base = L.attention_partial_hs(q, cache.k[i], cache.v[i],
                                      kv_len=cache.base_len)
        ring = L.attention_partial(q, cache.bk[i], cache.bv[i],
                                   kv_len=cache.buf_len + 1)
        o = L.merge_partials([base, ring]).to(x.dtype)
        x = x + L.settle(o.reshape(B, 1, -1) @ p["attn"]["wo"])
        x = _mix_residual(cfg, p, x, decode=True)
    return (lm_logits(cfg, params["embed"], x),
            cache._replace(buf_len=cache.buf_len + 1))


def commit_buffer(cfg: ModelConfig, cache: BufferedKVCache
                  ) -> BufferedKVCache:
    """Flush the whole ring (R positions) into the base at ``base_len``,
    transposed to the base's head-major layout, in place; run every R
    steps.  Returns the cache with ``base_len + R`` and an empty ring."""
    R = cache.bk.shape[2]
    lo = cache.base_len
    _check_room("commit_buffer", lo + R, cache.k.shape[3])
    L.write_seq(cache.k, lo, cache.bk.transpose(2, 3), 3)
    L.write_seq(cache.v, lo, cache.bv.transpose(2, 3), 3)
    return cache._replace(base_len=lo + R, buf_len=0)


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
        x = x + L.settle(o.reshape(B, 1, -1) @ p["attn"]["wo"])
        x = _mix_residual(cfg, p, x, decode=True)
    return lm_logits(cfg, params["embed"], x), kpool, vpool

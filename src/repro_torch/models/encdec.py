"""Whisper-style encoder-decoder backbone (the conv audio frontend is a
stub: the caller hands over precomputed frame embeddings).  Sinusoidal
positions on both sides, pre-LN, GELU MLPs, multi-head attention.

The port of ``repro.models.encdec``, with the same param tree
(``{"embed", "enc", "dec"}``, layers stacked on a leading axis) and
positions.  Which kernel runs where:

  * encoder self-attention: ``flash_attention``, full;
  * decoder self-attention in prefill: ``flash_attention``, causal;
  * cross-attention in prefill: ``flash_attention``, full, the decoder's
    positions against the encoder's;
  * both attentions in decode: ``layers.decode_attention`` (the
    ``paged_attention`` kernel on the cache seen as one page a
    sequence): self-attention over pos + 1 positions of the decoder
    cache, cross-attention over every encoder position.

Decode writes this token's k/v into the cache in place; past the cache's
end it raises ``ValueError`` where the reference clamps (ROADMAP.md
queue 3).  ``forward_train`` runs the encoder, the causal decoder and
its cross-attention over whole sequences (every attention the
``flash_attention`` kernel), each decoder layer recomputed in the
backward pass as the reference's ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt_lib


class EncDecCache(NamedTuple):
    """Decode state of the encoder-decoder."""

    k: torch.Tensor      # (L_dec, B, S_max, H, hd) decoder self-attention
    v: torch.Tensor
    xk: torch.Tensor     # (L_dec, B, S_enc, H, hd) cross-attention (static)
    xv: torch.Tensor
    length: int          # decoder positions filled


def enc_len_for(cfg: ModelConfig, dec_len: int) -> int:
    """Encoder frames that go with ``dec_len`` decoder positions."""
    return max(16, dec_len // 4)


def sinusoid(S: int, D: int) -> np.ndarray:
    """(S, D) float64 sinusoidal positions: sines, then cosines."""
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * i / D)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


@L.device_cache(maxsize=16)
def _sinusoid_on(S: int, D: int, dtype: torch.dtype, device: torch.device):
    # one host-to-device copy per (shape, dtype, device)
    return torch.as_tensor(sinusoid(S, D), device=device).to(dtype)[None]


def _layer_params(cfg: ModelConfig, gen: torch.Generator, n: int,
                  cross: bool) -> Dict:
    dev = gen.device

    def attn_block():
        return {"ln": L.norm_params(cfg, (n,), device=dev),
                "attn": L.attn_params(cfg, gen, (n,))}

    p = {"self": attn_block(),
         "ln_mlp": L.norm_params(cfg, (n,), device=dev),
         "mlp": L.mlp_params(cfg, gen, (n,))}
    if cross:
        p["cross"] = attn_block()
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params from ``generator``, on the card unless ``device``
    names another (the generator must live there).  The reference's tree
    and shapes."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    return {
        "embed": {"tok": L.embed_init(generator, (cfg.vocab, cfg.d_model),
                                      L.pdtype_of(cfg)),
                  "final_norm": L.norm_params(cfg, device=dev),
                  "enc_final_norm": L.norm_params(cfg, device=dev)},
        "enc": _layer_params(cfg, generator, cfg.n_enc_layers, cross=False),
        "dec": _layer_params(cfg, generator, cfg.n_layers, cross=True),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> EncDecCache:
    """A zeroed cache: ``max_len`` decoder positions and
    ``enc_len_for(max_len)`` encoder frames, each tensor its own."""
    dev, dt = resolve_device(device), L.dtype_of(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xshape = (cfg.n_layers, batch, enc_len_for(cfg, max_len),
              cfg.n_kv_heads, cfg.hd)
    z = lambda s: torch.zeros(s, dtype=dt, device=dev)
    return EncDecCache(z(shape), z(shape), z(xshape), z(xshape), 0)


def _self_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, causal: bool,
               kc=None, vc=None, pos: Optional[int] = None):
    """Pre-LN self-attention with its residual.  Over the whole sequence
    (the flash kernel) unless ``kc``/``vc`` (B, S_max, H, hd) are given:
    then x is one token at ``pos``, written into them in place.  Returns
    (x, (k, v))."""
    h = L.make_norm(cfg)(x, p["ln"])
    q, k, v = L.qkv_proj(cfg, p["attn"], h)
    if kc is not None:
        L.write_seq(kc, pos, k, 1)
        L.write_seq(vc, pos, v, 1)
        o = L.decode_attention(q, kc, vc, pos + 1)
    else:
        o = L.flash_attention(q, k, v, causal=causal)
    return x + L.settle(o.reshape(*o.shape[:2], -1) @ p["attn"]["wo"]), (k, v)


def _cross_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, xk, xv,
                decode: bool = False):
    """Pre-LN cross-attention over the encoder's k/v (B, S_enc, H, hd),
    with its residual: the flash kernel (full) over the sequence, or one
    token a sequence (``decode``) through ``layers.decode_attention``."""
    h = dt_lib.reduce_grad(L.make_norm(cfg)(x, p["ln"]))
    B, S, _ = h.shape
    q = (h @ p["attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    if decode:
        o = L.decode_attention(q, xk, xv, xk.shape[1])
    else:
        o = L.flash_attention(q, xk, xv, causal=False)
    return x + L.settle(o.reshape(B, S, -1) @ p["attn"]["wo"])


def _cross_kv(cfg: ModelConfig, p: Dict, enc_out: torch.Tensor):
    B, Se, _ = enc_out.shape
    enc_out = dt_lib.reduce_grad(enc_out)
    k = (enc_out @ p["attn"]["wk"]).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["attn"]["wv"]).reshape(B, Se, cfg.n_kv_heads, cfg.hd)
    return k, v


def _mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x + L.mlp_apply(cfg, p["mlp"], L.make_norm(cfg)(x, p["ln_mlp"]))


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor):
    """The final norm and the tied head."""
    x = dt_lib.reduce_grad(L.make_norm(cfg)(x, params["embed"]["final_norm"]))
    return x @ params["embed"]["tok"].T.to(x.dtype)


def encode(cfg: ModelConfig, params: Dict,
           audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds (B, S_enc, D), the stub frontend's output -> the
    encoder's output (B, S_enc, D)."""
    x = audio_embeds.to(L.dtype_of(cfg))
    x = x + _sinusoid_on(x.shape[1], cfg.d_model, x.dtype, x.device)
    for p in L.unstack(params["enc"], cfg.n_enc_layers):
        x, _ = _self_attn(cfg, p["self"], x, causal=False)
        x = _mlp(cfg, p, x)
    return L.make_norm(cfg)(x, params["embed"]["enc_final_norm"])


def forward_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    audio_embeds: torch.Tensor,
                    max_len: Optional[int] = None):
    """tokens (B, S), audio_embeds (B, S_enc, D) -> (logits (B, 1, V) at
    the last position, EncDecCache with ``max_len`` decoder positions,
    at least S; zeros past S)."""
    enc_out = encode(cfg, params, audio_embeds)
    B, S = tokens.shape
    dt = L.dtype_of(cfg)
    x = L.embed(params["embed"]["tok"], tokens).to(dt)
    x = x + _sinusoid_on(S, cfg.d_model, dt, x.device)
    shape = (cfg.n_layers, B, max(max_len or S, S), cfg.n_kv_heads, cfg.hd)
    ks = L.zeros_split_as(shape, dt, x, 1)
    vs = L.zeros_split_as(shape, dt, x, 1)
    xks, xvs = [], []
    for i in range(cfg.n_layers):
        p = L.layer(params["dec"], i)
        x, (k, v) = _self_attn(cfg, p["self"], x, causal=True)
        xk, xv = _cross_kv(cfg, p["cross"], enc_out)
        x = _mlp(cfg, p, _cross_attn(cfg, p["cross"], x, xk, xv))
        L.write_seq(ks[i], 0, k, 1)
        L.write_seq(vs[i], 0, v, 1)
        xks.append(xk)
        xvs.append(xv)
    return _logits(cfg, params, x[:, -1:]), EncDecCache(
        ks, vs, torch.stack(xks), torch.stack(xvs), S)


def _dec_layer_train(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    x, _ = _self_attn(cfg, p["self"], x, causal=True)
    xk, xv = _cross_kv(cfg, p["cross"], enc_out)
    return _mlp(cfg, p, _cross_attn(cfg, p["cross"], x, xk, xv))


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict,
                  remat: bool = True):
    """batch: ``audio_embeds`` (B, S_enc, D), ``tokens`` (B, S) ->
    (logits (B, S, V) through the tied head, aux loss 0.0)."""
    enc_out = encode(cfg, params, batch["audio_embeds"])
    tokens = batch["tokens"]
    dt = L.dtype_of(cfg)
    x = L.embed(params["embed"]["tok"], tokens).to(dt)
    x = x + _sinusoid_on(tokens.shape[1], cfg.d_model, dt, x.device)
    for p in L.unstack(params["dec"], cfg.n_layers):
        x = L.checkpointed(
            lambda x, p, e: _dec_layer_train(cfg, p, x, e), x, p, enc_out,
            remat=remat)
    return _logits(cfg, params, x), 0.0


def forward_decode(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   cache: EncDecCache):
    """tokens (B, 1) -> (logits (B, 1, V), the cache with length + 1; its
    k/v the same tensors, written in place at ``cache.length``).  The
    position's sinusoid is computed in fp32 from the position, as the
    reference does."""
    pos = int(cache.length)
    if pos >= cache.k.shape[2]:
        raise ValueError(f"encdec forward_decode would write position "
                         f"{pos} of a cache of {cache.k.shape[2]}")
    x = L.embed(params["embed"]["tok"], tokens).to(L.dtype_of(cfg))
    D = cfg.d_model
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)
    ang = float(pos) / torch.pow(10_000.0, 2 * i / D)
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)]).to(x.dtype)
    for j in range(cfg.n_layers):
        p = L.layer(params["dec"], j)
        x, _ = _self_attn(cfg, p["self"], x, causal=False, kc=cache.k[j],
                          vc=cache.v[j], pos=pos)
        x = _cross_attn(cfg, p["cross"], x, cache.xk[j], cache.xv[j],
                        decode=True)
        x = _mlp(cfg, p, x)
    return _logits(cfg, params, x), cache._replace(length=pos + 1)

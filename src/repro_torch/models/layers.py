"""Shared neural-net building blocks (plain PyTorch, param dicts).

The port of ``repro.models.layers``, function for function and with the
same parameter layout: every weight keeps the ``(in, out)`` orientation
of the reference, so a reference param tree copies across leaf for
leaf.  Left out: ``_maybe_shard_scores``, ``attention_partial*`` and
``merge_partials``, which serve the buffered decode path (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype of ``cfg``."""
    return _DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    """The parameter dtype of ``cfg``."""
    return _DTYPES[cfg.param_dtype]


# -- initialisers -------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Normal weights with std ``scale / sqrt(fan_in)`` on the generator's
    device; ``fan_in`` is ``shape[-2]`` (a leading axis stacks layers)."""
    fan_in = shape[-2] if len(shape) >= 2 else max(1, shape[0])
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    return out.normal_(0.0, scale / float(np.sqrt(fan_in)), generator=gen)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """Normal embeddings with std 0.02 on the generator's device."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    return out.normal_(0.0, 0.02, generator=gen)


# -- norms -----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in fp32, cast back to ``x.dtype``."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: Optional[torch.Tensor],
              b: Optional[torch.Tensor], eps: float = 1e-5):
    """LayerNorm in fp32 with optional affine terms."""
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    if w is not None:
        h = h * w.float()
    if b is not None:
        h = h + b.float()
    return h.to(x.dtype)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no affine parameters)."""
    return layernorm(x, None, None, eps)


def make_norm(cfg: ModelConfig):
    """The norm of ``cfg`` as ``fn(x, params)``."""
    if cfg.norm == "rmsnorm":
        return lambda x, p: rmsnorm(x, p["w"])
    if cfg.norm == "layernorm":
        return lambda x, p: layernorm(x, p["w"], p["b"])
    if cfg.norm == "nonparam_ln":
        return lambda x, p: nonparam_ln(x)
    raise ValueError(cfg.norm)


def norm_params(cfg: ModelConfig, lead: Tuple[int, ...] = (),
                device=None) -> Dict[str, torch.Tensor]:
    """The norm's parameters (with leading axes ``lead``, e.g. layers)."""
    pd, D = pdtype_of(cfg), cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones(lead + (D,), dtype=pd, device=device)}
    if cfg.norm == "layernorm":
        return {"w": torch.ones(lead + (D,), dtype=pd, device=device),
                "b": torch.zeros(lead + (D,), dtype=pd, device=device)}
    return {"_": torch.zeros(lead + (1,), dtype=pd, device=device)}


# -- rotary embeddings ----------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float) -> np.ndarray:
    """Inverse frequencies of the rotated dims (float64)."""
    return 1.0 / (theta ** (np.arange(0, hd_rot, 2, dtype=np.float64) / hd_rot))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(hd_rot: int, theta: float, device: torch.device):
    # one host-to-device copy per (shape, device): a copy from pageable
    # memory on every call would stall the host on each layer
    return torch.as_tensor(rope_freqs(hd_rot, theta), dtype=torch.float32,
                           device=device)


def rope_tables(positions: torch.Tensor, hd: int, theta: float,
                frac: float = 1.0):
    """(cos, sin) of the rotary angles at ``positions`` (B, S), each
    (B, S, 1, hd_rot / 2) in fp32, or None where nothing rotates.  A
    forward pass computes them once and rotates every layer's q and k
    with them (``rotate``)."""
    hd_rot = int(hd * frac)
    hd_rot -= hd_rot % 2
    if hd_rot == 0:
        return None
    freqs = _rope_freqs_on(hd_rot, float(theta), positions.device)
    ang = positions.float()[..., None] * freqs           # (B, S, hd_rot/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate the first dims of x (B, S, H, hd) by ``rope_tables``' angles
    (neox half-split style, in fp32); the rest pass through."""
    if tables is None:
        return x
    cos, sin = tables
    hd_rot = 2 * cos.shape[-1]
    xr = x[..., :hd_rot].float()
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., hd_rot:]], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               frac: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Rotates the first
    ``frac * hd`` dims (neox half-split style), in fp32; the rest pass
    through (partial rotary, as in ChatGLM's 2d-RoPE backbone)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, frac))


# -- attention ----------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Repeat each KV head ``n_rep`` times along axis 2 (GQA)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,Hkv,hd).  fp32 softmax, probabilities
    cast to ``q.dtype`` before the product with V, as the reference.

    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: optional valid kv length (scalar or (B,)) for masking a
    padded cache.  The model calls the kernels instead
    (``kernels.flash_attention``, ``kernels.paged_attention``); this is
    the reference's plain einsum path.
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    scale = 1.0 / np.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None  # broadcastable against (B, H, Sq, Skv)
    if causal and Sq > 1:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos <= qpos)[None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device)
        kpos = torch.arange(Skv, device=q.device)
        if kv_len.dim() == 0:
            valid = (kpos < kv_len)[None, None, None, :]
        else:  # per-sequence lengths (B,)
            valid = (kpos[None] < kv_len[:, None])[:, None, None, :]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# -- MLPs --------------------------------------------------------------------------------

def mlp_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU or GELU MLP; weights (D, d_ff) and (d_ff, D)."""
    if cfg.act == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu
        h = x @ p["w_up"]
        h = F.gelu(h.float()).to(x.dtype)
    return h @ p["w_down"]


def mlp_params(cfg: ModelConfig, gen: torch.Generator,
               lead: Tuple[int, ...] = (),
               d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """MLP weights (with leading axes ``lead``)."""
    d_ff = d_ff or cfg.d_ff
    D, pd = cfg.d_model, pdtype_of(cfg)
    p = {"w_up": dense_init(gen, lead + (D, d_ff), pd),
         "w_down": dense_init(gen, lead + (d_ff, D), pd)}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, lead + (D, d_ff), pd)
    return p


# -- attention block params -------------------------------------------------------------------

def attn_params(cfg: ModelConfig, gen: torch.Generator,
                lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Q/K/V/O projections (with leading axes ``lead``), plus biases
    where ``cfg.qkv_bias``."""
    D, hd, pd = cfg.d_model, cfg.hd, pdtype_of(cfg)
    dev = gen.device
    p = {"wq": dense_init(gen, lead + (D, cfg.n_heads * hd), pd),
         "wk": dense_init(gen, lead + (D, cfg.n_kv_heads * hd), pd),
         "wv": dense_init(gen, lead + (D, cfg.n_kv_heads * hd), pd),
         "wo": dense_init(gen, lead + (cfg.n_heads * hd, D), pd)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (cfg.n_heads * hd,), dtype=pd, device=dev)
        p["bk"] = torch.zeros(lead + (cfg.n_kv_heads * hd,), dtype=pd,
                              device=dev)
        p["bv"] = torch.zeros(lead + (cfg.n_kv_heads * hd,), dtype=pd,
                              device=dev)
    return p


def qkv_proj(cfg: ModelConfig, p: Dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B,S,H,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v

"""Shared neural-net building blocks (plain PyTorch, param dicts).

The port of ``repro.models.layers``, function for function and with the
same parameter layout: every weight keeps the ``(in, out)`` orientation
of the reference, so a reference param tree copies across leaf for
leaf.  ``decode_attention`` is the one place a contiguous KV cache is
attended: it runs the ``paged_attention`` kernel on the cache seen as a
pool of one page a sequence.  The buffered decode's partials
(``attention_partial``, ``attention_partial_hs``, ``merge_partials``)
are plain torch, as the reference computes them outside any Pallas
kernel.  Left out: ``_maybe_shard_scores``, the identity without a
device mesh (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The activation dtype of ``cfg``."""
    return _DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    """The parameter dtype of ``cfg``."""
    return _DTYPES[cfg.param_dtype]


# -- param trees ---------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(blocks: Dict, i: int) -> Dict:
    """The params of layer ``i``: views into the stacked block leaves."""
    return tree_map(lambda t: t[i], blocks)


def unstack(blocks: Dict, n: int):
    """The params of each of the ``n`` layers, as ``layer`` gives them,
    cut by one ``torch.unbind`` a leaf: under autograd each leaf's
    gradient is one stack of the layers' gradients (``layer``'s indexing
    would add a full-size zero tensor a layer)."""
    out = [{} for _ in range(n)]

    def cut(dst, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                for d in dst:
                    d[k] = {}
                cut([d[k] for d in dst], v)
            else:
                for d, t in zip(dst, torch.unbind(v, 0)):
                    d[k] = t
    cut(out, blocks)
    return out


def checkpointed(fn, *args, remat: bool = True):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when ``remat`` and grad is
    on: the reference's ``jax.checkpoint`` of a scan body.  Remat changes
    memory, not values."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def tree_from_numpy(tree: Dict, dtype: torch.dtype, device: torch.device,
                    keep_fp32=()) -> Dict:
    """A tree of numpy leaves (the reference's params) as tensors on
    ``device``: values kept exactly, cast to ``dtype``, except the leaves
    named in ``keep_fp32``, which stay fp32 as the reference keeps
    them."""
    def conv(key, x):
        if isinstance(x, dict):
            return {k: conv(k, v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(device, torch.float32 if key in keep_fp32 else dtype)
    return conv(None, tree)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` as ``F.embedding``: the same values, and a
    gradient that is deterministic on the CPU and the card (the backward
    of ``table[tokens]`` on CPU tensors accumulates in a thread-dependent
    order)."""
    return F.embedding(tokens, table)


# -- initialisers -------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal weights with std ``scale / sqrt(fan_in)`` on the generator's
    device; ``fan_in`` is ``shape[-2]`` (a leading axis stacks layers)
    unless the caller gives it."""
    if fan_in is None:
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


def _kv_valid(kv_len, Skv: int, device) -> torch.Tensor:
    """The positions below ``kv_len`` (a scalar, or (B,) per sequence) as
    a mask broadcastable against (B, H, Sq, Skv) scores."""
    kv_len = torch.as_tensor(kv_len, device=device)
    kpos = torch.arange(Skv, device=device)
    if kv_len.dim() == 0:
        return (kpos < kv_len)[None, None, None, :]
    return (kpos[None] < kv_len[:, None])[:, None, None, :]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd), k/v: (B,Skv,Hkv,hd).  fp32 softmax, probabilities
    cast to ``q.dtype`` before the product with V, as the reference.

    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: optional valid kv length (scalar or (B,)) for masking a
    padded cache.  The model calls the kernels instead
    (``kernels.flash_attention``, ``decode_attention``); this is the
    reference's plain einsum path.
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
        valid = _kv_valid(kv_len, Skv, q.device)
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


@functools.lru_cache(maxsize=None)
def _one_page_tables(B: int, device: torch.device) -> torch.Tensor:
    # sequence b's one page is slot b; made once per (B, device)
    return torch.arange(B, dtype=torch.int32, device=device)[:, None]


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     length: int) -> torch.Tensor:
    """One decode token per sequence over one layer of a contiguous KV
    cache: q (B, 1, H, hd); kc/vc (B, S_max, Hkv, hd), contiguous;
    ``length`` (a Python int) valid positions -> (B, 1, H, hd).

    ``attention(q, kc, vc, causal=False, kv_len=length)`` computed by the
    ``paged_attention`` kernel on the cache seen, without a copy, as a
    pool of B pages of S_max positions, sequence b's table naming page
    b.  The range check is on the host, so the wrapper's device read of
    the tables and lengths is skipped.  On CPU tensors the wrapper runs
    its plain version."""
    B, S_max, Hkv, hd = kc.shape
    if not 1 <= length <= S_max:
        raise ValueError(f"decode over {length} positions of a cache of "
                         f"{S_max}")
    lengths = torch.full((B,), length, dtype=torch.int32, device=q.device)
    o = paged_ops.paged_attention(
        q[:, 0], kc.view(B, S_max, Hkv, hd), vc.view(B, S_max, Hkv, hd),
        _one_page_tables(B, q.device), lengths, validate=False)
    return o[:, None]


def _softmax_partial(s: torch.Tensor, kv_len):
    """Masked scores (B, H, Sq, Skv) -> (m, p, l): the row max, the
    unnormalised weights and their sum, in fp32."""
    if kv_len is not None:
        valid = _kv_valid(kv_len, s.shape[-1], s.device)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p, p.sum(dim=-1)


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len=None):
    """Unnormalised attention partial for online-softmax merging: q
    (B,Sq,H,hd), k/v (B,Skv,Hkv,hd) -> (o_un (B,Sq,H,hd), m (B,H,Sq),
    l (B,H,Sq)), all fp32; the weights enter P V in ``q.dtype``."""
    B, Sq, H, hd = q.shape
    k = repeat_kv(k, H // k.shape[2])
    v = repeat_kv(v, H // v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(hd)
    m, p, l = _softmax_partial(s, kv_len)
    o_un = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    return o_un.float(), m, l


def attention_partial_hs(q: torch.Tensor, k_hs: torch.Tensor,
                         v_hs: torch.Tensor, kv_len=None):
    """``attention_partial`` over head-major K/V (B,Hkv,Skv,hd), the
    query heads grouped (no repeated K/V)."""
    B, Sq, H, hd = q.shape
    Hkv, Skv = k_hs.shape[1], k_hs.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                     k_hs.float()) / np.sqrt(hd)
    m, p, l = _softmax_partial(s.reshape(B, H, Sq, Skv), kv_len)
    pg = p.reshape(B, Hkv, G, Sq, Skv).to(q.dtype)
    o_un = torch.einsum("bhgqk,bhkd->bqhgd", pg, v_hs)
    return o_un.reshape(B, Sq, H, hd).float(), m, l


def merge_partials(parts) -> torch.Tensor:
    """Merge [(o_un, m, l), ...] online-softmax partials -> (B,Sq,H,hd)
    fp32."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    num = den = 0.0
    for o_un, mi, li in parts:
        a = torch.exp(mi - m)                              # (B, H, Sq)
        num = num + o_un * a.transpose(1, 2)[..., None]
        den = den + (li * a).transpose(1, 2)[..., None]
    return num / torch.clamp(den, min=1e-30)


# -- MLPs --------------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU or GELU MLP; weights (D, d_ff) and (d_ff, D)."""
    if cfg.act == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu
        h = x @ p["w_up"]
        h = gelu(h.float()).to(x.dtype)
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

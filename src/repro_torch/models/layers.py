"""Shared neural-net building blocks (plain PyTorch, param dicts).

The port of ``repro.models.layers``, function for function and with the
same parameter layout: every weight keeps the ``(in, out)`` orientation
of the reference, so a reference param tree copies across leaf for
leaf.  ``decode_attention`` is the one place a contiguous KV cache is
attended: it runs the ``paged_attention`` kernel on the cache seen as a
pool of one page a sequence.  The buffered decode's partials
(``attention_partial``, ``attention_partial_hs``, ``merge_partials``)
are plain torch, as the reference computes them outside any Pallas
kernel.  ``_maybe_shard_scores`` is the reference's decode sharding
hint, applied where the port materialises scores (``attention`` and the
partials): the identity on plain tensors.  ``flash_attention`` calls
the kernel, on each rank's shards where q is a DTensor (the sharded
step).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import opt_flags
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.dtensor import settle

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
    order).  On a DTensor table, ``_sharded_embed``."""
    if not dt.is_dtensor(table):
        return F.embedding(tokens, table)
    return _sharded_embed(table, tokens)


def _sharded_embed(table, tokens):
    """The lookup of a DTensor table split over the vocab (the rules'
    ``tok``) by DTensor tokens split over the batch: each rank looks up
    its tokens in its own rows, zeros for a token outside them, and the
    (B, S, D) result is all-reduced over the vocab's mesh dims, giving
    the replicated lookup (Megatron's vocab-parallel embedding; the
    table's gradient is each rank's rows, summed over the batch's mesh
    dims)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    tpl, kpl, tgrad, opl, vocab = [], [], [], [], []
    for i in range(mesh.ndim):
        kp = tokens.placements[i] if dt.is_dtensor(tokens) else Replicate()
        if kp == Shard(0):                        # the batch
            tpl.append(Replicate()), kpl.append(kp)
            tgrad.append(Partial()), opl.append(kp)
        elif table.placements[i] == Shard(0):     # the vocab
            tpl.append(Shard(0)), kpl.append(Replicate())
            tgrad.append(Shard(0)), opl.append(Partial()), vocab.append(i)
        else:
            for lst in (tpl, kpl, tgrad, opl):
                lst.append(Replicate())
    tl = dt.local_in(table, tpl, tgrad)
    kl = dt.local_in(tokens, kpl) if dt.is_dtensor(tokens) else tokens
    idx = 0
    for i in vocab:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    lo = idx * tl.shape[0]
    mine = (kl >= lo) & (kl < lo + tl.shape[0])
    e = F.embedding(torch.where(mine, kl - lo, 0), tl) * mine[..., None]
    return settle(dt.local_out(e.to(tl.dtype), table, opl))


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


# -- per-device tables ---------------------------------------------------------

_DEVICE_CACHES = []


def device_cache(maxsize=None):
    """``functools.lru_cache`` for a function that makes a small table
    once per device (rope frequencies, one-page tables, the sinusoid),
    registered so that ``clear_device_caches`` can drop it."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        _DEVICE_CACHES.append(cached)
        return cached
    return wrap


def clear_device_caches() -> None:
    """Drop every table ``device_cache`` keeps.  A shape-only trace
    (``FakeTensorMode``: the dry-run) calls it before and after it runs,
    so that it neither meets a real cached tensor nor leaves a fake one
    behind."""
    for cached in _DEVICE_CACHES:
        cached.cache_clear()


# -- rotary embeddings ----------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float) -> np.ndarray:
    """Inverse frequencies of the rotated dims (float64)."""
    return 1.0 / (theta ** (np.arange(0, hd_rot, 2, dtype=np.float64) / hd_rot))


@device_cache()
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


def _maybe_shard_scores(scores: torch.Tensor) -> torch.Tensor:
    """The reference's decode hint: with ``decode_shard_scores`` and one
    query position, DTensor scores (B, H, 1, Skv) are redistributed to
    the reference's ``P(None, None, None, decode_seq_axis)``: split
    along the KV axis over that mesh dim, replicated over the others, so
    the softmax runs on each rank's KV shard with small all-reduces
    instead of gathering the cache.  The identity on plain tensors and
    on meshes without that dim."""
    if not opt_flags.FLAGS.decode_shard_scores or scores.shape[2] != 1 \
            or not dt.is_dtensor(scores):
        return scores
    mesh = scores.device_mesh
    axis = opt_flags.FLAGS.decode_seq_axis
    if axis not in (mesh.mesh_dim_names or ()):
        return scores
    from repro_torch.sharding.rules import placements
    return scores.redistribute(mesh, placements(mesh, (None, None, None,
                                                       axis)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The ``flash_attention`` kernel's wrapper, called on local shards
    where q is a DTensor (the sharded step): attention is local over
    the batch and the heads.  Each mesh dim that splits q's heads or
    batch splits k/v the same way where they are split there; where the
    rules replicate k/v (their heads do not divide the mesh dim: GQA)
    each rank takes the kv heads its q heads read, and its gradient for
    k/v is a ``Partial`` sum over that dim.  A mesh dim that splits
    neither runs the same attention on every rank."""
    if not dt.is_dtensor(q):
        return flash_ops.flash_attention(q, k, v, causal=causal)
    from torch.distributed.tensor import Partial, Replicate, Shard
    q = settle(q)
    H, Hkv = q.shape[2], k.shape[2]
    qpl, kpl, kgrad = [], [], []
    head_dim = None  # the mesh dim that splits q's heads, kv replicated
    for i, p in enumerate(q.placements):
        kp = k.placements[i]
        if p == Shard(0):
            qpl.append(p), kpl.append(p), kgrad.append(p)
        elif p == Shard(2):
            qpl.append(p)
            if kp == Shard(2):
                kpl.append(kp), kgrad.append(kp)
            else:
                if head_dim is not None:
                    raise NotImplementedError(
                        "q heads split over two mesh dims with kv "
                        "replicated")
                head_dim = i
                kpl.append(Replicate()), kgrad.append(Partial())
        else:
            qpl.append(Replicate()), kpl.append(Replicate())
            kgrad.append(Replicate())
    ql = dt.local_in(q, qpl)
    kl = dt.local_in(settle(k), kpl, kgrad)
    vl = dt.local_in(settle(v), kpl, kgrad)
    if head_dim is not None:
        r = q.device_mesh.get_local_rank(head_dim)
        h_loc, G = ql.shape[2], H // Hkv
        first = r * h_loc
        if h_loc % G == 0:
            kl = kl[:, :, first // G:(first + h_loc) // G]
            vl = vl[:, :, first // G:(first + h_loc) // G]
        elif G % h_loc == 0:
            kl = kl[:, :, first // G:first // G + 1]
            vl = vl[:, :, first // G:first // G + 1]
        else:  # each local q head its own copy of its kv head
            idx = torch.arange(first, first + h_loc, device=ql.device) // G
            kl, vl = kl[:, :, idx], vl[:, :, idx]
    o = flash_ops.flash_attention(ql, kl, vl, causal=causal)
    return dt.local_out(o, q, qpl)


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
    scores = _maybe_shard_scores(scores)
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


def zeros_split_as(shape, dtype, like: torch.Tensor,
                   batch_dim: int) -> torch.Tensor:
    """``torch.zeros(shape)`` on ``like``'s device; where ``like`` is a
    DTensor, a DTensor on its mesh whose dim ``batch_dim`` is split as
    ``like``'s batch (its dim 0), replicated elsewhere, made shard by
    shard."""
    if not dt.is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import Replicate, Shard, zeros
    pl = [Shard(batch_dim) if p == Shard(0) else Replicate()
          for p in like.placements]
    return zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                 placements=pl)


def write_seq(c: torch.Tensor, lo: int, x: torch.Tensor,
              seq_dim: int) -> None:
    """``c[..., lo:lo + n, ...] = x`` along ``seq_dim``, in place (n is
    x's size there).  On a DTensor cache split along ``seq_dim`` (the
    rules split a KV cache's sequence over "model") each rank writes the
    part of x that falls in its own slice of the sequence, with no
    collective: x is replicated along the sequence and split like c
    everywhere else."""
    n = x.shape[seq_dim]
    if not dt.is_dtensor(c):
        c.narrow(seq_dim, lo, n).copy_(x)
        return
    from torch.distributed.tensor import Replicate, Shard
    seq_shard = [i for i, p in enumerate(c.placements)
                 if p == Shard(seq_dim)]
    xl = dt.local_in(x.to(c.dtype), [Replicate() if i in seq_shard else p
                                     for i, p in enumerate(c.placements)])
    cl = c.to_local()
    S_loc = cl.shape[seq_dim]
    idx = 0  # this rank's slice of the sequence, mesh dims major first
    for i in seq_shard:
        idx = idx * c.device_mesh.size(i) + c.device_mesh.get_local_rank(i)
    off = idx * S_loc
    a, b = max(lo, off), min(lo + n, off + S_loc)
    if a < b:
        cl.narrow(seq_dim, a - off, b - a).copy_(
            xl.narrow(seq_dim, a - lo, b - a))


@device_cache()
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
    its plain version.  On a DTensor cache, ``_sharded_decode``."""
    B, S_max, Hkv, hd = kc.shape
    if not 1 <= length <= S_max:
        raise ValueError(f"decode over {length} positions of a cache of "
                         f"{S_max}")
    if dt.is_dtensor(kc):
        return _sharded_decode(q, kc, vc, length)
    return _paged_decode(q, kc, vc, length, lse=False)


def _paged_decode(q, kc, vc, length: int, lse: bool):
    """The ``paged_attention`` kernel (``paged_attention_lse`` where
    ``lse``) over the cache's first ``length`` positions, the cache a
    pool of one page a sequence; o (B, 1, H, hd)."""
    B, S_max, Hkv, hd = kc.shape
    lengths = torch.full((B,), length, dtype=torch.int32, device=q.device)
    args = (q[:, 0], kc.view(B, S_max, Hkv, hd), vc.view(B, S_max, Hkv, hd),
            _one_page_tables(B, q.device), lengths)
    if lse:
        o, l = paged_ops.paged_attention_lse(*args, validate=False)
        return o[:, None], l
    return paged_ops.paged_attention(*args, validate=False)[:, None]


def _sharded_decode(q, kc, vc, length: int):
    """``decode_attention`` on a DTensor cache: the ``paged_attention``
    kernel on each rank's local shards.  A mesh dim that splits the
    cache's batch splits q's too.  One that splits its sequence (the
    rules split a decode cache's over "model") gives each rank the
    positions of its slice and q whole: the kernel attends those of them
    below ``length`` and returns each head's lse beside its output, and
    the ranks' outputs merge by the lse's all-reduced max and two
    all-reduced sums (of the weighted outputs, in fp32, and of the
    weights); a rank with no position below ``length`` launches nothing
    and adds zero.  The merge rounds each rank's output to q's dtype
    first, as the kernel writes it.  Any other mesh dim runs the same
    attention on every rank.  The result is split as the batch,
    replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = kc.device_mesh
    qpl, kpl, seq = [], [], []
    for i, p in enumerate(kc.placements):
        if p == Shard(0):
            qpl.append(p), kpl.append(p)
        elif p == Shard(1):
            qpl.append(Replicate()), kpl.append(p), seq.append(i)
        else:
            qpl.append(Replicate()), kpl.append(Replicate())
    ql = dt.local_in(settle(q), qpl)
    kl, vl = dt.local_in(kc, kpl), dt.local_in(vc, kpl)
    if not seq:
        return dt.local_out(_paged_decode(ql, kl, vl, length, lse=False),
                            kc, qpl)
    S_loc, idx = kl.shape[1], 0
    for i in seq:  # this rank's slice of the sequence, mesh dims major first
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    n = min(max(length - idx * S_loc, 0), S_loc)
    if n:
        o, lse = _paged_decode(ql, kl, vl, n, lse=True)
    else:
        o = torch.zeros_like(ql)
        lse = torch.full(ql.shape[:1] + ql.shape[2:3], float("-inf"),
                         device=ql.device)

    m = _reduce_over(lse, kc, seq, qpl, "max")
    w = torch.exp(lse - m)                                   # (B, H)
    num = _reduce_over(o.float() * w[:, None, :, None], kc, seq, qpl, "sum")
    den = _reduce_over(w, kc, seq, qpl, "sum")
    o = (num / den[:, None, :, None]).to(q.dtype)
    return dt.local_out(o, kc, qpl)


def _reduce_over(x, like, dims, placements, op: str):
    """Local ``x``, placed as ``placements`` on ``like``'s mesh, reduced
    (``op``: "sum" or "max") over the mesh ``dims``: one all-reduce; the
    result local again."""
    from torch.distributed.tensor import Partial
    pl = [Partial(op) if i in dims else p for i, p in enumerate(placements)]
    return dt.local_in(dt.local_out(x, like, pl), placements)


def _softmax_partial(s: torch.Tensor, kv_len):
    """Masked scores (B, H, Sq, Skv) -> (m, p, l): the row max, the
    unnormalised weights and their sum, in fp32."""
    if kv_len is not None:
        valid = _kv_valid(kv_len, s.shape[-1], s.device)
        s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p, p.sum(dim=-1)


def _sharded_partial(q, k, v, kv_len: int, head_major: bool):
    """``attention_partial`` (``_hs`` when ``head_major``) of DTensors,
    each rank on its own shards: a mesh dim that splits k/v's batch
    splits q's too; one that splits their sequence (the rules split a
    decode cache's) gives each rank the positions of its slice, q
    whole, and the ranks' partials are merged by the global row max
    and two sums (all-reduces of the (B, H, Sq) max and of the
    rescaled o_un and l): the decode's scores stay split along the KV
    axis, which ``_maybe_shard_scores`` asks of the reference's.  Any
    other mesh dim computes the same partial on every rank.  The
    result is replicated but along the batch."""
    from torch.distributed.tensor import Replicate, Shard
    seq_dim = 2 if head_major else 1
    mesh = k.device_mesh
    qpl, kpl, seq = [], [], []
    for i, p in enumerate(k.placements):
        if p == Shard(0):
            qpl.append(p), kpl.append(p)
        elif p == Shard(seq_dim):
            qpl.append(Replicate()), kpl.append(p), seq.append(i)
        else:
            qpl.append(Replicate()), kpl.append(Replicate())
    ql = dt.local_in(settle(q), qpl)
    kl, vl = dt.local_in(settle(k), kpl), dt.local_in(settle(v), kpl)
    S_loc, idx = kl.shape[seq_dim], 0
    for i in seq:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    kv_loc = min(max(kv_len - idx * S_loc, 0), S_loc)
    fn = attention_partial_hs if head_major else attention_partial
    o_un, m, l = fn(ql, kl, vl, kv_len=kv_loc)
    out_pl = [p if p == Shard(0) else Replicate() for p in qpl]

    if seq:
        M = _reduce_over(m, k, seq, out_pl, "max")
        a = torch.exp(m - M)
        o_un = _reduce_over(o_un * a.transpose(1, 2)[..., None], k, seq,
                            out_pl, "sum")
        l, m = _reduce_over(l * a, k, seq, out_pl, "sum"), M
    return tuple(dt.local_out(x, k, out_pl) for x in (o_un, m, l))


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len=None):
    """Unnormalised attention partial for online-softmax merging: q
    (B,Sq,H,hd), k/v (B,Skv,Hkv,hd) -> (o_un (B,Sq,H,hd), m (B,H,Sq),
    l (B,H,Sq)), all fp32; the weights enter P V in ``q.dtype``.  On
    DTensor k/v, ``_sharded_partial``."""
    if dt.is_dtensor(k):
        return _sharded_partial(q, k, v, int(kv_len), False)
    B, Sq, H, hd = q.shape
    k = repeat_kv(k, H // k.shape[2])
    v = repeat_kv(v, H // v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(hd)
    m, p, l = _softmax_partial(_maybe_shard_scores(s), kv_len)
    o_un = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    return o_un.float(), m, l


def attention_partial_hs(q: torch.Tensor, k_hs: torch.Tensor,
                         v_hs: torch.Tensor, kv_len=None):
    """``attention_partial`` over head-major K/V (B,Hkv,Skv,hd), the
    query heads grouped (no repeated K/V)."""
    if dt.is_dtensor(k_hs):
        return _sharded_partial(q, k_hs, v_hs, int(kv_len), True)
    B, Sq, H, hd = q.shape
    Hkv, Skv = k_hs.shape[1], k_hs.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                     k_hs.float()) / np.sqrt(hd)
    m, p, l = _softmax_partial(_maybe_shard_scores(
        s.reshape(B, H, Sq, Skv)), kv_len)
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
    x = dt.reduce_grad(x)
    if cfg.act == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:  # gelu
        h = x @ p["w_up"]
        h = gelu(h.float()).to(x.dtype)
    return settle(h @ p["w_down"])


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
    x = dt.reduce_grad(x)
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

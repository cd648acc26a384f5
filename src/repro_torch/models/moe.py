"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The port of ``repro.models.moe``.  Tokens are scattered into a
per-expert buffer of shape (E, C, D), the experts run as batched
products over it, and the outputs are gathered back and combined with
the renormalised gates.  Every step keeps the reference's semantics:

  * the router is fp32 and its logits are computed from ``x`` cast to
    fp32; top-k is descending, and the gate values are renormalised
    over the K chosen experts;
  * an assignment's slot in its expert's buffer is the number of earlier
    (token, k) pairs, in the flat (t, k) order, routed to the same
    expert; assignments at or past the capacity C are dropped: they add
    nothing to the buffer and gather zeros back;
  * the combine runs in the activation dtype, and the shared experts'
    MLP is added where the config has one.

``moe_apply`` is the composition of ``route``, ``dispatch``,
``expert_ffn`` and ``combine``, which a profiler times apart.
``_constrain`` is the reference's sharding hint at its four sites (the
repeated tokens, the dispatch buffer, the experts' output buffer, the
gathered outputs): with ``moe_local_dispatch`` it pins DTensor
placements, the identity on plain tensors.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import opt_flags
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt


class Routing(NamedTuple):
    """Where each (token, k) assignment goes: ``probs`` (T, E) fp32,
    ``eidx`` and ``gates`` (T, K) (expert indices, descending by
    probability, and their renormalised fp32 weights), ``pos`` (T * K,)
    the slot in the expert's buffer, ``keep`` (T * K,) whether the slot
    is below the capacity ``C``."""

    probs: torch.Tensor
    eidx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int


def _constrain(x: torch.Tensor, logical) -> torch.Tensor:
    """The reference's MoE hint: with ``moe_local_dispatch``, DTensor
    ``x`` redistributed to the logical spec ``logical`` (dispatch
    buffers expert-split over "model", token tensors batch-split), where
    "data_batch" is the mesh's batch axes, ("pod", "data") or
    ("data",).  The identity on plain tensors."""
    if not opt_flags.FLAGS.moe_local_dispatch or not dt.is_dtensor(x):
        return x
    from repro_torch.sharding.rules import batch_axes, placements
    mesh = x.device_mesh
    bax = batch_axes(mesh)
    spec = tuple(bax if a == "data_batch" else a for a in logical)
    spec = tuple(a if a is None or isinstance(a, tuple)
                 or a in mesh.mesh_dim_names else None for a in spec)
    return x.redistribute(mesh, placements(mesh, spec))


def moe_params(cfg: ModelConfig, gen: torch.Generator,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Router (fp32) and expert weights (with leading axes ``lead``), plus
    the shared experts' MLP where ``cfg.n_shared_experts``.  An expert
    leaf (E, D, F) has the reference's fan-in, its first axis."""
    D, Fd, E, pd = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, L.pdtype_of(cfg)
    p = {"router": L.dense_init(gen, lead + (D, E), torch.float32),
         "w_gate": L.dense_init(gen, lead + (E, D, Fd), pd, fan_in=E),
         "w_up": L.dense_init(gen, lead + (E, D, Fd), pd, fan_in=E),
         "w_down": L.dense_init(gen, lead + (E, Fd, D), pd, fan_in=E)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_params(cfg, gen, lead,
                                   d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def _capacity(cfg: ModelConfig, n_tokens: int, decode: bool) -> int:
    """Capacity per expert.  Decode uses a higher factor (drops at decode
    hurt generation quality) and is exactly dropless when the batch is
    small enough that C would reach T*K anyway."""
    cf = 4.0 if decode else cfg.capacity_factor
    c = int(n_tokens * cfg.experts_per_tok * cf / cfg.n_experts)
    c = max(4, -(-c // 4) * 4)  # round up to a multiple of 4
    return min(c, n_tokens * cfg.experts_per_tok)


def route(cfg: ModelConfig, p: Dict, xf: torch.Tensor,
          decode: bool = False) -> Routing:
    """The router and each assignment's slot, for tokens xf (T, D)."""
    T, E, K = xf.shape[0], cfg.n_experts, cfg.experts_per_tok
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True)
    flat_e = eidx.reshape(-1)
    # expert-major one-hot (E, T*K): its exclusive cumsum runs along rows,
    # which the card scans in parallel (a scan down the T*K axis of a
    # (T*K, E) one-hot runs E sequential scans)
    experts = torch.arange(E, device=xf.device, dtype=flat_e.dtype)
    onehot = (flat_e[None, :] == experts[:, None]).int()
    ranks = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = ranks.gather(0, flat_e[None, :])[0].long()
    C = _capacity(cfg, T, decode)
    return Routing(probs, eidx, gates, pos, pos < C, C)


def dispatch(cfg: ModelConfig, r: Routing, xf: torch.Tensor) -> torch.Tensor:
    """The (E, C, D) buffer: each kept assignment's token at its slot,
    zeros elsewhere.  Kept slots are distinct, so each is written once;
    dropped assignments go to a spare row that is cut off.  DTensors
    take an accumulating ``index_put`` instead, with no spare row; it
    gives the same values, but it sorts its indices on CUDA, and on
    plain tensors it made ``moe_main``'s dispatch 1.45-2.5x slower and
    its prefill 8-11 % slower on an H100 (PERF.md)."""
    E, C, K, D = cfg.n_experts, r.C, cfg.experts_per_tok, xf.shape[1]
    flat = r.eidx.reshape(-1) * C + r.pos
    flat = torch.where(r.keep, flat, torch.full_like(flat, E * C))
    src = _constrain(xf.repeat_interleave(K, dim=0), ("data_batch", None))
    if dt.is_dtensor(xf):
        # no spare row: DTensor cannot differentiate the slice that
        # cuts it off; dropped assignments add zeros to slot 0 instead.
        # Unpinned (no moe_local_dispatch), the tokens are gathered whole
        # on every rank, as the reference's note says GSPMD does
        flat = torch.where(r.keep, flat, 0)
        src = torch.where(r.keep[:, None], src, 0)
        if not opt_flags.FLAGS.moe_local_dispatch:
            flat, src = dt.replicate(flat), dt.replicate(src)
        buf = xf.new_zeros((E * C, D)).index_put((flat,), src,
                                                 accumulate=True)
        buf = buf.view(E, C, D)
        if not opt_flags.FLAGS.moe_local_dispatch:
            return dt.replicate(buf)  # its gradient gathered whole too
        return _constrain(buf, ("model", None, None))
    buf = xf.new_zeros((E * C + 1, D))
    buf[flat] = src
    return _constrain(buf[:E * C].view(E, C, D), ("model", None, None))


def expert_ffn(cfg: ModelConfig, p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's MLP on its buffer rows, as batched products."""
    if cfg.act == "swiglu":
        g = torch.bmm(buf, p["w_gate"])
        u = torch.bmm(buf, p["w_up"])
        h = F.silu(g.float()).to(buf.dtype) * u
    else:
        h = L.gelu(torch.bmm(buf, p["w_up"]).float()).to(buf.dtype)
    return _constrain(torch.bmm(h, p["w_down"]), ("model", None, None))


def combine(cfg: ModelConfig, p: Dict, r: Routing, out_buf: torch.Tensor,
            xf: torch.Tensor) -> torch.Tensor:
    """Each token's kept experts' outputs, weighted by the gates in the
    activation dtype and summed over K, plus the shared experts.
    Unpinned (no ``moe_local_dispatch``), a DTensor ``out_buf`` is
    gathered whole on every rank first, as the dispatch's buffer is, so
    the gathered rows keep the tokens' batch split: indexed while split
    over experts, DTensor split the rows over "model" too, which the
    caller's reshape to (B, S, D) refuses and whose gradient a view's
    backward turns into a strided shard that a shape-only trace cannot
    gather."""
    T, K, D = xf.shape[0], cfg.experts_per_tok, xf.shape[1]
    if dt.is_dtensor(out_buf) and not opt_flags.FLAGS.moe_local_dispatch:
        out_buf = dt.replicate(out_buf)
    gathered = _constrain(
        out_buf[r.eidx.reshape(-1), torch.where(r.keep, r.pos, 0)],
        ("data_batch", None))
    gathered = torch.where(r.keep[:, None], gathered, 0)
    gates = r.gates.reshape(-1).to(xf.dtype)
    y = (gathered * gates[:, None]).reshape(T, K, D).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(cfg, p["shared"], xf)
    return y


def aux_loss(cfg: ModelConfig, r: Routing) -> torch.Tensor:
    """Switch load-balance loss (fp32 scalar): E * sum over experts of the
    fraction of tokens whose first choice it is times its mean router
    probability, scaled by ``router_aux_coef``."""
    E = cfg.n_experts
    frac = F.one_hot(r.eidx[:, 0], E).float().mean(dim=0)
    pmean = r.probs.mean(dim=0)
    return E * torch.sum(frac * pmean) * cfg.router_aux_coef


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (B, S, D), aux_loss (fp32 scalar)."""
    B, S, D = x.shape
    xf = dt.reduce_grad(x).reshape(B * S, D)
    r = route(cfg, p, xf, decode)
    y = combine(cfg, p, r, expert_ffn(cfg, p, dispatch(cfg, r, xf)), xf)
    return y.reshape(B, S, D), aux_loss(cfg, r)

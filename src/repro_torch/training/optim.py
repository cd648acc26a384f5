"""AdamW over a tree of tensors, global-norm gradient clipping, and int8
stochastic-rounding gradient compression.

The port of ``repro.training.optim``: the same config, state and fp32
update, moments kept in ``moment_dtype``.  ``adamw_update`` returns new
tensors (the inputs are left as they are), computed under
``torch.no_grad()``; on DTensor params (the sharded step) each leaf is
updated on its moments' placements (ZeRO-1) and its new value gathered
back to the param's own; the step count is a 0-d int32 tensor on the params'
device, so the schedule and bias corrections never read the device
from the host.  ``compress_int8`` takes an explicit ``torch.Generator``
in place of a jax key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import dtensor as dt

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"   # bf16 moments for 1T-class models


class OptState(NamedTuple):
    """First and second moments (the params' tree) and the step count."""

    mu: Any
    nu: Any
    step: torch.Tensor


def _leaves(tree) -> list:
    out = []
    L.tree_map(out.append, tree)
    return out


def init_opt_state(params: Any, oc: AdamWConfig) -> OptState:
    """Zero moments in ``moment_dtype`` and step 0, on the params' device."""
    mdt = _DTYPES[oc.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = _leaves(params)[0].device
    return OptState(mu=L.tree_map(zeros, params),
                    nu=L.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _schedule(oc: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``oc.lr`` over ``warmup_steps`` (fp32)."""
    warm = torch.clamp((step + 1).float() / max(1, oc.warmup_steps), max=1.0)
    return oc.lr * warm


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32.  On DTensor
    leaves each leaf's sum of squares is all-reduced over the mesh dims
    that split it, so the norm is one replicated scalar, the same on
    every rank."""
    return torch.sqrt(sum(dt.settle(torch.sum(torch.square(x.float())))
                          for x in _leaves(tree)))


def clip_by_global_norm(grads: Any, clip: float) -> Tuple[Any, torch.Tensor]:
    """Every leaf scaled by min(1, clip / (norm + 1e-9)) in fp32, back in
    its own dtype; and the norm."""
    gn = global_norm(grads)
    scale = torch.clamp(clip / (gn + 1e-9), max=1.0)
    return L.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState,
                 oc: AdamWConfig) -> Tuple[Any, OptState, Dict]:
    """One AdamW step on clipped gradients -> (new params, new state,
    {"grad_norm", "lr"}); fp32 math, params back in their dtype, moments
    in ``moment_dtype``."""
    grads, gn = clip_by_global_norm(grads, oc.clip_norm)
    step = state.step + 1
    lr = _schedule(oc, state.step)
    b1, b2 = oc.b1, oc.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    mdt = _DTYPES[oc.moment_dtype]

    def upd(p, g, m, v):
        p0 = p
        if dt.is_dtensor(p):  # on the moments' (ZeRO-1) placements
            p, g = dt.to_placements(p, m.placements), \
                dt.to_placements(g, m.placements)
        gf = g.float()
        m32 = m.float() * b1 + gf * (1 - b1)
        v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + oc.eps) \
            + oc.weight_decay * p.float()
        new_p = dt.to_placements((p.float() - lr * delta).to(p.dtype),
                                 getattr(p0, "placements", None))
        return new_p, m32.to(mdt), v32.to(mdt)

    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        _leaves(params), _leaves(grads), _leaves(state.mu),
        _leaves(state.nu))]

    def rebuild(j):  # the j-th output of every leaf, in the params' tree
        it = iter(o[j] for o in outs)
        return L.tree_map(lambda _: next(it), params)

    new_p, new_m, new_v = rebuild(0), rebuild(1), rebuild(2)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gn, "lr": lr}


# -- gradient compression ------------------------------------------------------

def compress_int8(g: torch.Tensor, generator: torch.Generator):
    """Per-tensor symmetric int8 quantisation with stochastic rounding:
    (q int8, scale fp32 scalar); the noise comes from ``generator``."""
    scale = torch.clamp(torch.max(torch.abs(g.float())), min=1e-12) / 127.0
    x = g.float() / scale
    noise = torch.rand(g.shape, generator=generator, device=g.device) - 0.5
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)

"""The train step and the serving steps of the port.

The port of ``repro.training.step``.  ``make_train_step`` builds
``step(state, batch) -> (state, metrics)``: the loss and its gradients
by ``torch.autograd`` (the params detached and marked to require grad
for the step only, so the state's tensors never carry a graph), with
``microbatches > 1`` the batch cut into equal microbatches along its
first axis and their gradients summed into fp32 buffers and scaled by
``1 / microbatches`` (with one microbatch the gradients keep the
params' dtype, as the reference's do), then global-norm clipping and
AdamW (``optim.adamw_update``).  ``make_prefill_step`` and
``make_decode_step`` wrap the model's serving calls under
``torch.no_grad()``.

``train_state_from_numpy`` / ``train_state_to_numpy`` carry a whole
train state (params, moments, step) across from and to the reference's
numpy leaves.  ``abstract_train_state`` goes with the dry-run (ROADMAP.md
queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    ModelAPI, params_from_numpy, params_to_numpy,
)
from repro_torch.training import optim


@dataclasses.dataclass(frozen=True)
class RunConfig:
    microbatches: int = 1
    adamw: optim.AdamWConfig = dataclasses.field(
        default_factory=optim.AdamWConfig)


class TrainState(NamedTuple):
    params: Any
    opt: optim.OptState


def init_train_state(api: ModelAPI, generator: torch.Generator,
                     oc: optim.AdamWConfig, device=None) -> TrainState:
    """Random params from ``generator`` (on ``device``, the card unless
    named) and a fresh optimizer state."""
    params = api.init(generator, device)
    return TrainState(params=params, opt=optim.init_opt_state(params, oc))


def train_state_from_numpy(cfg: ModelConfig, tree, oc: optim.AdamWConfig,
                           device=None) -> TrainState:
    """The reference's ``TrainState`` (``params`` and ``opt`` with
    ``mu``, ``nu``, ``step``; its namedtuples, numpy leaves) as the
    port's, on ``device`` (the card unless named): params as
    ``models.model.params_from_numpy`` casts them, moments in
    ``moment_dtype``, the step an int32 scalar, all values exact."""
    dev = resolve_device(device)
    opt = tree.opt
    mdt = optim._DTYPES[oc.moment_dtype]
    return TrainState(
        params=params_from_numpy(cfg, tree.params, dev),
        opt=optim.OptState(
            mu=L.tree_from_numpy(opt.mu, mdt, dev),
            nu=L.tree_from_numpy(opt.nu, mdt, dev),
            step=torch.tensor(int(np.asarray(opt.step)),
                              dtype=torch.int32, device=dev)))


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's train state with numpy leaves: params and moments as
    float32 (exact), the step as an int32 scalar."""
    f32 = lambda t: t.detach().float().cpu().numpy()
    return TrainState(
        params=params_to_numpy(state.params),
        opt=optim.OptState(mu=L.tree_map(f32, state.opt.mu),
                           nu=L.tree_map(f32, state.opt.nu),
                           step=np.int32(int(state.opt.step))))


def value_and_grad(api: ModelAPI, params: Dict, batch: Dict):
    """(loss, metrics, gradients in the params' tree and dtypes) of
    ``api.loss``, under grad whatever the caller's mode; a leaf the loss
    does not use gets zeros, as ``jax.grad`` gives."""
    leaves = []

    def live(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    with torch.enable_grad():
        loss, metrics = api.loss(L.tree_map(live, params), batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for g, t in zip(gs, leaves))
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, L.tree_map(lambda _: next(it), params)


def make_train_step(api: ModelAPI, rc: RunConfig):
    """``step(state, batch) -> (new state, {"loss", "grad_norm", "lr"})``;
    ``batch`` a dict of tensors on the params' device, each cut into
    ``rc.microbatches`` equal parts along its first axis."""
    oc = rc.adamw

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        mb = rc.microbatches
        if mb > 1:
            size = {v.shape[0] for v in batch.values()}
            if len(size) != 1 or next(iter(size)) % mb:
                raise ValueError(f"batch sizes {size} do not cut into {mb} "
                                 f"microbatches")
            per = next(iter(size)) // mb
            acc = L.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = None
            for j in range(mb):
                sub = {k: v[j * per:(j + 1) * per] for k, v in batch.items()}
                lj, _, gj = value_and_grad(api, state.params, sub)
                loss = lj if loss is None else loss + lj
                _add_into(acc, gj)
                del gj
            inv = 1.0 / mb
            loss = loss * inv
            grads = L.tree_map(lambda a: a.mul_(inv), acc)
        else:
            loss, _, grads = value_and_grad(api, state.params, batch)
        new_params, new_opt, om = optim.adamw_update(
            state.params, grads, state.opt, oc)
        return TrainState(new_params, new_opt), {"loss": loss, **om}

    return step


def _add_into(acc: Dict, grads: Dict) -> None:
    """acc += grads, leaf by leaf, in acc's fp32."""
    for k, a in acc.items():
        if isinstance(a, dict):
            _add_into(a, grads[k])
        else:
            a.add_(grads[k])


def make_prefill_step(api: ModelAPI, max_len: Optional[int] = None):
    """``step(params, batch) -> (logits, cache)``: ``api.prefill`` of the
    batch's tokens (and its ``patch_embeds`` or ``audio_embeds``), with
    no graph."""
    @torch.no_grad()
    def step(params, batch):
        extra = {k: batch[k] for k in ("patch_embeds", "audio_embeds")
                 if k in batch}
        return api.prefill(params, batch["tokens"], max_len=max_len, **extra)
    return step


def make_decode_step(api: ModelAPI):
    """``step(params, tokens, cache) -> (logits, cache)`` with no graph."""
    @torch.no_grad()
    def step(params, tokens, cache):
        return api.decode(params, tokens, cache)
    return step

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

The same step takes a state and batch of DTensors, placed by the
sharding rules (``sharding.rules.distribute``; the reference's
``jit`` with ``in_shardings``).  The model then runs on DTensors, its
kernels on each rank's shards (``models.layers.flash_attention``,
``models.mamba.selective_scan``), under DTensor's implicit replication
of the plain tensors it makes (positions, masks); each gradient comes
back ``Partial`` over the batch's mesh dims and is reduced to its
param's placements before it is summed or clipped; the global norm is
one replicated scalar; AdamW updates each leaf on its moments'
(ZeRO-1) placements and gathers the new param back to its own.  The
metrics come back as plain tensors, the same on every rank.

``train_state_from_numpy`` / ``train_state_to_numpy`` carry a whole
train state (params, moments, step) across from and to the reference's
numpy leaves.  ``abstract_train_state`` is the shape-only state of the
dry-run: fake tensors with the state's shapes and dtypes, nothing
allocated.
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
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding import rules
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


def abstract_train_state(api: ModelAPI, oc: optim.AdamWConfig,
                         fake_mode=None) -> TrainState:
    """The train state's shapes and dtypes as fake CPU tensors, traced
    under ``fake_mode`` (a ``FakeTensorMode``; a new one unless given):
    ``init_train_state`` run with no memory behind its tensors, for any
    config (kimi-k2-1t-a32b included).  The reference's
    ``jax.eval_shape`` of its init."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mode or FakeTensorMode():
        return init_train_state(api, torch.Generator(), oc, device="cpu")


def state_specs(cfg: ModelConfig, mesh, params, log=None) -> TrainState:
    """The logical specs of a train state on ``mesh`` (a tree like the
    state's): the params by ``sharding.rules.param_specs``, both moments
    by ``opt_state_specs`` (ZeRO-1), the step replicated."""
    pspecs = rules.param_specs(cfg, mesh, params, log)
    ospecs = rules.opt_state_specs(cfg, mesh, params, pspecs, log)
    return TrainState(params=pspecs,
                      opt=optim.OptState(mu=ospecs, nu=ospecs, step=()))


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
    does not use gets zeros, as ``jax.grad`` gives.  On DTensor params
    each gradient is reduced to its param's placements."""
    leaves = []

    def live(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    with torch.enable_grad(), dt.implicit():
        loss, metrics = api.loss(L.tree_map(live, params), batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(t) if g is None else dt.like(g, t)
                  for g, t in zip(gs, leaves))
        grads = L.tree_map(lambda _: next(it), params)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def microbatches(batch: Dict, mb: int):
    """``batch`` cut into ``mb`` equal microbatches along the first axis.
    A DTensor leaf is cut on every rank's own shard: microbatch j holds
    the j-th slice of each data shard, so no rank gathers the batch.
    Against the reference's contiguous slices of the global batch this
    reorders which rows share a microbatch, not which rows are summed:
    the loss is the mean of the microbatches' means, equal to the
    reference's wherever every microbatch labels as many positions (all
    rows of a train batch do), up to the order of the fp32 sums."""
    size = {v.shape[0] for v in batch.values()}
    local = {k: v.to_local() if dt.is_dtensor(v) else v
             for k, v in batch.items()}
    lsize = {v.shape[0] for v in local.values()}
    if len(size) != 1 or next(iter(size)) % mb or any(n % mb for n in lsize):
        raise ValueError(f"batch sizes {size} (shards {lsize}) do not cut "
                         f"into {mb} microbatches")
    out = []
    for j in range(mb):
        sub = {}
        for k, v in local.items():
            per = v.shape[0] // mb
            piece = v[j * per:(j + 1) * per]
            sub[k] = dt.local_out(piece, batch[k], batch[k].placements) \
                if dt.is_dtensor(batch[k]) else piece
        out.append(sub)
    return out


def make_train_step(api: ModelAPI, rc: RunConfig):
    """``step(state, batch) -> (new state, {"loss", "grad_norm", "lr"})``;
    ``batch`` a dict of tensors on the params' device, each cut into
    ``rc.microbatches`` equal parts along its first axis; or a state and
    batch of DTensors placed by ``sharding.rules``."""
    oc = rc.adamw

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        mb = rc.microbatches
        if mb > 1:
            acc = L.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            loss = None
            for sub in microbatches(batch, mb):
                lj, _, gj = value_and_grad(api, state.params, sub)
                loss = lj if loss is None else loss + lj
                _add_into(acc, gj)
                del gj
            inv = 1.0 / mb
            loss = loss * inv
            grads = L.tree_map(lambda a: a.mul_(inv), acc)
        else:
            loss, _, grads = value_and_grad(api, state.params, batch)
        with dt.implicit():
            new_params, new_opt, om = optim.adamw_update(
                state.params, grads, state.opt, oc)
        metrics = {"loss": loss, **om}
        return TrainState(new_params, new_opt), {
            k: dt.plain(v) for k, v in metrics.items()}

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

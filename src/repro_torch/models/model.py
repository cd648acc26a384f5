"""Model API of the port.

``build(cfg)`` returns a ``ModelAPI`` with the functions its callers
use:
  init(generator, device=None) -> params
  loss(params, batch) -> (scalar loss, metrics dict)
  prefill(params, tokens, ...) -> (logits, cache)
  decode(params, tokens, cache) -> (logits, cache)
  init_cache(batch, max_len, device=None) -> zeroed cache
  decode_paged(params, tokens, kpool, vpool, block_tables, lengths,
               slot_ids, slot_offs) -> (logits, kpool, vpool)

Every family of the reference is ported.  The transformer families
(dense, vlm with its patch frontend, moe with routed experts) prefill
with ``prefill(params, tokens, full_logits=False, max_len=None,
patch_embeds=None)`` (the vlm's patch embeddings B x P x D), decode
over the contiguous KV cache with ``decode``, and serve through the
paged KV pool with ``decode_paged``.  The SSM family (falcon-mamba,
Mamba1 blocks on the ``mamba_scan`` kernel), the hybrid family (zamba2,
Mamba2 blocks plus one shared attention block) and the encoder-decoder
(whisper, ``prefill(params, tokens, audio_embeds, max_len=None)``,
logits at the last position) decode from their own state with
``decode``; like the reference's serving engine, the paged decode
refuses them.

``loss`` is the reference's: fp32 cross-entropy over every position
whose label is not -1 (``cross_entropy``), plus the MoE aux loss, on
the training forward of the family (each block recomputed in the
backward pass); ``batch`` holds ``tokens`` and ``labels`` (B, S) and,
for the vlm, ``patch_embeds`` or, for the encdec, ``audio_embeds``
(``launch.specs.make_batch``).  Its metrics: ``ce`` and ``aux`` for
dense, vlm, moe and ssm, ``ce`` for hybrid and encdec.  Every family
trains on the card: attention's gradient is the ``flash_attention_bwd``
kernel, the selective scan's the ``mamba_scan_bwd`` kernel (both behind
their wrappers' autograd Functions).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import hybrid
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dt


def _target_logit(lf: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """``lf[b, s, safe[b, s]]``.  On DTensor logits split over the vocab
    (the sharded step's ``lm_head``), each rank picks the label's logit
    where it falls in its vocab shard and zero elsewhere (a select
    against a vocab index split as the logits are, no gather of the
    logits), and the pending sum over the vocab's mesh dims is one
    all-reduce of a (B, S) fp32 tensor: Megatron's vocab-parallel
    cross-entropy."""
    if not dt.is_dtensor(lf):
        return lf.gather(-1, safe[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, distribute_tensor
    V = lf.shape[-1]
    pl = [p if p.is_shard() and p.dim % lf.ndim == lf.ndim - 1
          else Replicate() for p in lf.placements]
    pl = [type(p)(0) if p.is_shard() else p for p in pl]
    vocab = distribute_tensor(torch.arange(V, device=lf.device_mesh.device_type),
                              lf.device_mesh, pl, src_data_rank=None)
    hit = vocab == safe[..., None]
    return dt.settle(torch.where(hit, lf, torch.zeros_like(lf)).sum(dim=-1))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """fp32 cross-entropy with ignore_index = -1: logits (B, S, V), labels
    (B, S) -> the mean over the labelled positions.  The row max is
    detached, as the reference's ``stop_gradient``.

    On DTensor logits split over the vocab (the sharded step) it stays
    split: the row max and the exp-sum are all-reduces of (B, S) fp32
    tensors over the vocab's mesh dims, and the label's logit is
    ``_target_logit``'s; no rank gathers the logits."""
    lf = logits.float()
    m = dt.settle(lf.amax(dim=-1, keepdim=True)).detach()
    logz = m[..., 0] + torch.log(dt.settle(torch.exp(lf - m).sum(dim=-1)))
    safe = labels.clamp(min=0).long()
    ll = _target_logit(lf, safe) - logz
    mask = (labels >= 0).float()
    return dt.settle(-(ll * mask).sum() / mask.sum().clamp(min=1.0))


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """A family's entry points, closed over its config."""

    cfg: ModelConfig
    init: Callable[..., Dict]
    loss: Callable[[Dict, Dict], Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_paged: Callable[..., Any]


def _raise(msg: str) -> Callable[..., Any]:
    def fn(*args, **kw):
        raise NotImplementedError(msg)
    return fn


# The leaves each family keeps fp32 whatever the parameter dtype, as the
# reference does.
_FP32_LEAVES = {"dense": (), "vlm": (), "moe": ("router",),
                "ssm": M.FP32_LEAVES["mamba1"],
                "hybrid": M.FP32_LEAVES["mamba2"], "encdec": ()}


def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None) -> Dict:
    """The reference's params of any family (numpy leaves, blocks
    stacked on a leading layer axis) as the port's, on the card unless
    ``device`` names another: values kept exactly, cast to the parameter
    dtype, except the leaves the reference keeps fp32."""
    keep = _FP32_LEAVES.get(cfg.family)
    if keep is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    return L.tree_from_numpy(tree, L.pdtype_of(cfg), resolve_device(device),
                             keep)


def params_to_numpy(params: Dict) -> Dict:
    """The port's params of any family as numpy (float32 leaves), the
    reference's tree."""
    return L.tree_map(lambda t: t.detach().float().cpu().numpy(), params)


# ----------------------------------------------------------------------------
# pure-SSM stack (falcon-mamba)
# ----------------------------------------------------------------------------

def _ssm_init(cfg: ModelConfig, generator: torch.Generator,
              device=None) -> Dict:
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    pd = L.pdtype_of(cfg)
    return {"embed": {"tok": L.embed_init(generator, (cfg.vocab, cfg.d_model),
                                          pd),
                      "final_norm": L.norm_params(cfg, device=dev),
                      "lm_head": L.dense_init(generator,
                                              (cfg.d_model, cfg.vocab), pd)},
            "blocks": M.mamba1_params(cfg, generator, (cfg.n_layers,))}


def _ssm_forward_train(cfg: ModelConfig, params: Dict, batch: Dict,
                       remat: bool = True):
    """batch ``tokens`` (B, S) -> (logits (B, S, V), aux 0.0), each Mamba1
    block recomputed in the backward pass when ``remat``."""
    x = T.embed_tokens(cfg, params["embed"], batch["tokens"])
    for p in L.unstack(params["blocks"], cfg.n_layers):
        x = L.checkpointed(lambda x, p: M.mamba1_full(cfg, p, x), x, p,
                           remat=remat)
    return (T.lm_logits(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _loss_fn(forward, with_aux: bool):
    """The family's ``loss``: CE of ``forward``'s logits, plus its aux
    loss where ``with_aux``."""
    def loss(params: Dict, batch: Dict):
        logits, aux = forward(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        if with_aux:
            return ce + aux, {"ce": ce, "aux": aux}
        return ce, {"ce": ce}
    return loss


def _ssm_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 full_logits: bool = False, max_len=None):
    """tokens (B, S) -> (logits, SSMCache); logits at the last position
    unless ``full_logits``.  ``max_len`` is accepted for the common API
    and unused: the state does not grow."""
    x = T.embed_tokens(cfg, params["embed"], tokens)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        x, (cs, ss) = M.mamba1_full(cfg, p, x, return_state=True)
        convs.append(cs)
        ssms.append(ss)
    logits = T.lm_logits(cfg, params["embed"], x if full_logits else x[:, -1:])
    return logits, M.SSMCache(conv=torch.stack(convs), ssm=torch.stack(ssms))


def _ssm_decode(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: M.SSMCache):
    """tokens (B, 1) -> (logits (B, 1, V), a new SSMCache)."""
    x = T.embed_tokens(cfg, params["embed"], tokens)
    convs, ssms = [], []
    for i in range(cfg.n_layers):
        p = L.layer(params["blocks"], i)
        x, cs, ss = M.mamba1_decode(cfg, p, x, cache.conv[i], cache.ssm[i])
        convs.append(cs)
        ssms.append(ss)
    return T.lm_logits(cfg, params["embed"], x), M.SSMCache(
        conv=torch.stack(convs), ssm=torch.stack(ssms))


def _ssm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                    device=None) -> M.SSMCache:
    dev = resolve_device(device)
    return M.SSMCache(
        conv=torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                          cfg.d_inner), dtype=L.dtype_of(cfg), device=dev),
        ssm=torch.zeros((cfg.n_layers, batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=dev))


def _hybrid_prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    full_logits: bool = False, max_len=None):
    """tokens (B, S) -> (logits, HybridCache with KV for ``max_len``
    positions, default S); logits at the last position unless
    ``full_logits``."""
    return hybrid.forward_full(cfg, params, tokens, collect_cache=True,
                               max_len=max_len or tokens.shape[1],
                               full_logits=full_logits)


# ----------------------------------------------------------------------------
# dispatcher
# ----------------------------------------------------------------------------

def build(cfg: ModelConfig) -> ModelAPI:
    """The ``ModelAPI`` of ``cfg``; ``ValueError`` for an unknown family."""
    fam = cfg.family
    if fam in T.FAMILIES:
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: T.init_params(
                cfg, generator, device),
            loss=_loss_fn(lambda params, batch: T.forward_train(
                cfg, params, batch), with_aux=True),
            prefill=lambda params, tokens, full_logits=False, max_len=None,
                patch_embeds=None: T.forward_prefill(
                    cfg, params, tokens, max_len=max_len,
                    full_logits=full_logits, patch_embeds=patch_embeds),
            decode=lambda params, tokens, cache: T.forward_decode(
                cfg, params, tokens, cache),
            init_cache=lambda batch, max_len, device=None: T.init_kv_cache(
                cfg, batch, max_len, device=device),
            decode_paged=lambda params, *args: T.forward_decode_paged(
                cfg, params, *args))
    no_paged = _raise(
        f"the {fam} family decodes from its own state with decode(); the "
        f"paged KV decode serves attention-only families, and the "
        f"reference's serving engine refuses {fam!r} too")
    if fam == "ssm":
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: _ssm_init(cfg, generator,
                                                          device),
            loss=_loss_fn(lambda params, batch: _ssm_forward_train(
                cfg, params, batch), with_aux=True),
            prefill=lambda params, tokens, full_logits=False, max_len=None:
                _ssm_prefill(cfg, params, tokens, full_logits, max_len),
            decode=lambda params, tokens, cache: _ssm_decode(
                cfg, params, tokens, cache),
            init_cache=lambda batch, max_len, device=None: _ssm_init_cache(
                cfg, batch, max_len, device),
            decode_paged=no_paged)
    if fam == "hybrid":
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: hybrid.init_params(
                cfg, generator, device),
            loss=_loss_fn(lambda params, batch: hybrid.forward_full(
                cfg, params, batch["tokens"]), with_aux=False),
            prefill=lambda params, tokens, full_logits=False, max_len=None:
                _hybrid_prefill(cfg, params, tokens, full_logits, max_len),
            decode=lambda params, tokens, cache: hybrid.forward_decode(
                cfg, params, tokens, cache),
            init_cache=lambda batch, max_len, device=None: hybrid.init_cache(
                cfg, batch, max_len, device),
            decode_paged=no_paged)
    if fam == "encdec":
        return ModelAPI(
            cfg=cfg,
            init=lambda generator, device=None: E.init_params(
                cfg, generator, device),
            loss=_loss_fn(lambda params, batch: E.forward_train(
                cfg, params, batch), with_aux=False),
            prefill=lambda params, tokens, audio_embeds, max_len=None:
                E.forward_prefill(cfg, params, tokens, audio_embeds, max_len),
            decode=lambda params, tokens, cache: E.forward_decode(
                cfg, params, tokens, cache),
            init_cache=lambda batch, max_len, device=None: E.init_cache(
                cfg, batch, max_len, device),
            decode_paged=no_paged)
    raise ValueError(f"unknown family {fam!r}")

"""Model API of the port.

``build(cfg)`` returns a ``ModelAPI`` with the functions the serving
engine calls:
  init(generator, device=None) -> params
  prefill(params, tokens, full_logits=False) -> (logits, KVCache)
  decode_paged(params, tokens, kpool, vpool, block_tables, lengths,
               slot_ids, slot_offs) -> (logits, kpool, vpool)

Only the dense family is ported.  The training loss, the contiguous-cache
``decode`` and ``init_cache`` of ``repro.models.model`` come with the
training slice; the other families raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

# Where the families the port does not run yet are queued.
_QUEUED = {
    "ssm": "ROADMAP.md queue 1, item 1 (models/mamba.py)",
    "hybrid": "ROADMAP.md queue 1, item 1 (models/hybrid.py)",
    "moe": "ROADMAP.md queue 1, item 9 (models/moe.py)",
    "vlm": "ROADMAP.md queue 1, item 9 (the vlm frontend)",
    "encdec": "ROADMAP.md queue 1, item 11 (models/encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """A family's entry points, closed over its config."""

    cfg: ModelConfig
    init: Callable[..., Dict]
    prefill: Callable[..., Any]
    decode_paged: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelAPI:
    """The ``ModelAPI`` of ``cfg``; raises for a family not yet ported."""
    if cfg.family != "dense":
        where = _QUEUED.get(cfg.family)
        if where is None:
            raise ValueError(f"unknown family {cfg.family!r}")
        raise NotImplementedError(
            f"the port runs the dense family only; {cfg.family!r} "
            f"({cfg.name}) is {where}")
    return ModelAPI(
        cfg=cfg,
        init=lambda generator, device=None: T.init_params(cfg, generator,
                                                          device),
        prefill=lambda params, tokens, full_logits=False: T.forward_prefill(
            cfg, params, tokens, full_logits=full_logits),
        decode_paged=lambda params, *args: T.forward_decode_paged(
            cfg, params, *args))

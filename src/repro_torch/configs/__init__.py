"""Architecture registry: ``get_config("<arch-id>")`` plus reduced configs
for CPU smoke tests (same family/topology, tiny dims).

The port's own copy of ``repro.configs``: the same ten architectures,
in the same order."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "chatglm3-6b", "olmo-1b", "granite-3-8b", "phi3-medium-14b",
    "llava-next-mistral-7b", "zamba2-2.7b", "whisper-tiny",
    "olmoe-1b-7b", "kimi-k2-1t-a32b", "falcon-mamba-7b",
]

_MODULE_OF = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
              for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    """The registered ``ModelConfig`` of ``arch``; KeyError if unknown."""
    if arch not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(_MODULE_OF[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    """Every registered config, by architecture id."""
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
        head_dim=16 if cfg.head_dim else 0,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, experts_per_tok=2, moe_d_ff=32,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=32, dt_rank=8)
    if cfg.family == "hybrid":
        # every=1 keeps TWO shared-attn invocations (weight reuse across
        # calls, G=2 caches — same as the old 4-layer/every-2 shape) at
        # half the mamba-layer compile cost
        kw.update(shared_attn_every=1)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.family == "vlm":
        kw.update(n_patches=16)
    kw.update(dtype="float32", param_dtype="float32")
    return dataclasses.replace(cfg, **kw)

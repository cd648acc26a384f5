"""Input builders for every (arch x shape) cell.

The port of ``repro.launch.specs``'s ``batch_shapes`` and
``make_batch``: the same shapes and, from the same seed, the same
numbers (drawn with numpy, then moved to the caller's device).
Modality frontends are stubs: vlm cells get precomputed patch
embeddings, audio cells precomputed frame embeddings.  ``input_specs``
gives shape-only stand-ins for the dry-run: fake tensors with the
batch's shapes and dtypes, nothing allocated (the reference's
``jax.ShapeDtypeStruct``s).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, ShapeCell


def _token_shapes(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, tuple]:
    B, S = cell.global_batch, cell.seq_len
    emb_dt = L.dtype_of(cfg)
    if cfg.family == "vlm":
        P = min(cfg.n_patches, S // 2)
        shapes = {"tokens": ((B, S - P), torch.int32),
                  "patch_embeds": ((B, P, cfg.d_model), emb_dt)}
    elif cfg.family == "encdec":
        Se = encdec.enc_len_for(cfg, S)
        shapes = {"tokens": ((B, S), torch.int32),
                  "audio_embeds": ((B, Se, cfg.d_model), emb_dt)}
    else:
        shapes = {"tokens": ((B, S), torch.int32)}
    return shapes


def batch_shapes(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, tuple]:
    """{name: (shape, dtype)} for the step input batch."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        shapes = _token_shapes(cfg, cell)
        shapes["labels"] = ((B, S), torch.int32)
        return shapes
    if cell.kind == "prefill":
        return _token_shapes(cfg, cell)
    # decode: one new token against a seq_len-sized cache
    return {"tokens": ((B, 1), torch.int32)}


def input_specs(cfg: ModelConfig, cell: ShapeCell,
                fake_mode=None) -> Dict[str, torch.Tensor]:
    """{name: a fake CPU tensor of the batch leaf's shape and dtype},
    made under ``fake_mode`` (a ``FakeTensorMode``; a new one unless
    given): no memory is allocated, whatever the cell's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mode or FakeTensorMode():
        return {k: torch.empty(shape, dtype=dt)
                for k, (shape, dt) in batch_shapes(cfg, cell).items()}


def make_batch(cfg: ModelConfig, cell: ShapeCell, seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Concrete random batch on ``device`` (the card unless named), for
    smoke tests; real training reads the data pipeline.  Integers
    uniform below the vocab (tokens, labels), embeddings N(0, 1) drawn in
    float64 and cast through float32; in a vlm train batch the patch
    positions carry label -1 (no next-token target)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dt) in batch_shapes(cfg, cell).items():
        if dt == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else 2
            x = rng.integers(0, hi, size=shape).astype(np.int32)
            out[k] = torch.from_numpy(x).to(dev)
        else:
            x = rng.normal(0, 1, size=shape).astype(np.float32)
            out[k] = torch.from_numpy(x).to(dev, dt)
    if cell.kind == "train" and cfg.family == "vlm":
        out["labels"][:, :out["patch_embeds"].shape[1]] = -1
    return out

"""Unified model configuration covering every assigned architecture family."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's shape, family knobs and numerics."""
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # -- attention / embedding ------------------------------------------------
    rope_theta: float = 10_000.0
    rope_frac: float = 1.0      # fraction of head_dim rotated (chatglm3: 0.5)
    norm: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"         # swiglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # -- MoE --------------------------------------------------------------------
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # -- SSM (mamba1/mamba2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64      # mamba2 only
    ssm_chunk: int = 256        # mamba2 SSD chunk size
    dt_rank: int = 0            # mamba1: 0 -> d_model // 16
    # -- hybrid (zamba2-style shared attention blocks) ------------------------------
    shared_attn_every: int = 0  # one shared attn+mlp block call every k layers
    # -- encoder-decoder (whisper) ---------------------------------------------------
    n_enc_layers: int = 0
    # -- modality frontend stub --------------------------------------------------------
    frontend: str = "none"      # none | patch_stub | audio_stub
    n_patches: int = 576        # vlm: patch positions per example
    # -- numerics -------------------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        """Head dimension (``head_dim`` or ``d_model // n_heads``)."""
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width (``ssm_expand * d_model``)."""
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        """Mamba1 dt rank (``dt_rank`` or ``d_model // 16``)."""
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def attn_free(self) -> bool:
        """True for the attention-free SSM family."""
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM state or hybrid w/ bounded attn)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        D, V, hd = self.d_model, self.vocab, self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_attn = D * (self.n_heads * hd) * 2 + D * (self.n_kv_heads * hd) * 2
        n = emb
        if self.family in ("dense", "vlm", "moe"):
            mlp_mult = 3 if self.act == "swiglu" else 2
            if self.family == "moe":
                per_mlp = self.n_experts * mlp_mult * D * self.moe_d_ff \
                    + D * self.n_experts \
                    + self.n_shared_experts * mlp_mult * D * self.moe_d_ff
            else:
                per_mlp = mlp_mult * D * self.d_ff
            n += self.n_layers * (per_attn + per_mlp)
        elif self.family == "ssm":
            din, N, R = self.d_inner, self.ssm_state, self.dt_rank_
            per = (D * 2 * din + din * self.ssm_conv + din * (R + 2 * N)
                   + R * din + din * N + din + din * D)
            n += self.n_layers * per
        elif self.family == "hybrid":
            din, N = self.d_inner, self.ssm_state
            nh = din // self.ssm_head_dim
            per = (D * (2 * din + 2 * N + nh) + din * self.ssm_conv
                   + din + din * D)
            n += self.n_layers * per
            mlp_mult = 3 if self.act == "swiglu" else 2
            n += per_attn + mlp_mult * D * self.d_ff  # one shared block
        elif self.family == "encdec":
            mlp_mult = 3 if self.act == "swiglu" else 2
            enc = self.n_enc_layers * (per_attn + mlp_mult * D * self.d_ff)
            dec = self.n_layers * (2 * per_attn + mlp_mult * D * self.d_ff)
            n += enc + dec
        return n

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.n_params()
        D = self.d_model
        mlp_mult = 3 if self.act == "swiglu" else 2
        dense_side = self.n_params() - self.n_layers * (
            self.n_experts * mlp_mult * D * self.moe_d_ff)
        active_moe = self.n_layers * (self.experts_per_tok * mlp_mult * D
                                      * self.moe_d_ff)
        return dense_side + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    shape: str           # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_serve(self) -> bool:
        """True for the prefill and decode cells."""
        return self.kind in ("prefill", "decode")


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    """The ``ShapeCell`` named ``name``; KeyError if none."""
    for s in SHAPES:
        if s.shape == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """Returns a skip-reason string, or None when the cell must run."""
    if cell.shape == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §4)")
    return None

"""olmoe-1b-7b [moe] — 64 experts, top-8, expert d_ff=1024.
[arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    n_experts=64, experts_per_tok=8, moe_d_ff=1024,
    norm="rmsnorm", act="swiglu")

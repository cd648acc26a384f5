"""phi3-medium-14b [dense] — RoPE SwiGLU GQA kv=10. [arXiv:2404.14219]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352,
    norm="rmsnorm", act="swiglu")

"""llava-next-mistral-7b [vlm] — Mistral-7B backbone; anyres patch frontend
is a STUB (input_specs supplies precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    norm="rmsnorm", act="swiglu", frontend="patch_stub", n_patches=576)

"""olmo-1b [dense] — non-parametric LayerNorm, MHA (kv=16), tied embeddings.
[arXiv:2402.00838; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab=50304,
    norm="nonparam_ln", act="swiglu", tie_embeddings=True)

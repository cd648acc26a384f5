"""granite-3-8b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155,
    norm="rmsnorm", act="swiglu")

"""zamba2-2.7b [hybrid] — Mamba2 layers + shared attention block.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6, norm="rmsnorm", act="swiglu")

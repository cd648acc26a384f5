"""falcon-mamba-7b [ssm] — pure Mamba1, attention-free. [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    norm="rmsnorm", act="swiglu")

"""whisper-tiny [audio] — enc-dec backbone; conv audio frontend is a STUB
(the caller supplies precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, n_enc_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    norm="layernorm", act="gelu", tie_embeddings=True,
    frontend="audio_stub")

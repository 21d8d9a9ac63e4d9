"""whisper-small [arXiv:2212.04356]: enc-dec audio backbone, conv frontend stubbed."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab=51865,
    enc_seq=1500,
    frontend="audio",
    act="gelu",
    qkv_bias=True,
    tie_embeddings=True,
)

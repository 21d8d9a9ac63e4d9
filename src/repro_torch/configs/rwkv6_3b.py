"""rwkv6-3b (Finch) [arXiv:2404.05892]: attention-free, data-dependent decay."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,           # head size 64
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab=65536,
)

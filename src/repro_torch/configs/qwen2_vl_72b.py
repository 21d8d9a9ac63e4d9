"""qwen2-vl-72b [arXiv:2409.12191]: VLM backbone; M-RoPE/vision stubbed.

The vision tower and dynamic-resolution patching are a frontend stub:
``input_specs`` feeds precomputed patch/text embeddings; the backbone applies
the temporal M-RoPE component (== standard RoPE for text positions).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision",
)

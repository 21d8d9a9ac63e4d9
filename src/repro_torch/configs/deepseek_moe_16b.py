"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64 routed top-6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,            # dense (first) layer FFN
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    n_dense_layers=1,
)

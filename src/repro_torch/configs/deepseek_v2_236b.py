"""deepseek-v2-236b [arXiv:2405.04434]: MLA (kv_lora=512) + 2 shared + 160 routed top-6."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=12288,            # dense (first) layer FFN
    vocab=102400,
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    mla_d_nope=128,
    mla_d_v=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_expert=1536,
    n_dense_layers=1,
)

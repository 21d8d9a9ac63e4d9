"""hymba-1.5b [arXiv:2411.13676]: parallel SWA-attention + Mamba heads per layer."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    layer_pattern="swa",
    window=1024,
    ssm_state=16,
    ssm_expand=1,
)

"""llama3-405b [arXiv:2407.21783]: dense GQA at maximum assigned scale."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
)

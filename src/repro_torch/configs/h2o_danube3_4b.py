"""h2o-danube-3-4b [arXiv:2401.16818]: llama/mistral mix with sliding-window attention."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_head=120,
    d_ff=10240,
    vocab=32000,
    layer_pattern="swa",
    window=4096,
)

"""gemma2-9b [arXiv:2408.00118]: local/global alternation + logit softcaps."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=14336,
    vocab=256000,
    layer_pattern="alt_local_global",
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)

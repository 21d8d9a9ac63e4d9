"""Model configuration covering all ten assigned architecture families.

A copy of the JAX package's ``models/config.py`` (data only), so that the
port's configs compare with the reference's field for field. One frozen
dataclass drives the zoo; each ``repro_torch/configs/<id>.py``
instantiates it with the published numbers. ``unroll_layers`` is kept
for that comparison: the port's layer loop is always a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    # --- attention flavour
    qkv_bias: bool = False
    attn_softcap: float = 0.0            # gemma2: 50.0 on attn logits
    logit_softcap: float = 0.0           # gemma2: 30.0 on output logits
    window: int = 0                      # sliding-window size (0 = full)
    layer_pattern: str = "causal"        # causal | alt_local_global | swa
    rope_theta: float = 10_000.0
    # --- MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora: int = 512
    q_lora: int = 0
    rope_head_dim: int = 64
    mla_d_nope: int = 128
    mla_d_v: int = 128
    # --- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                    # per-expert hidden dim
    n_dense_layers: int = 0              # leading dense layers (deepseek)
    capacity_factor: float = 1.25        # expert capacity vs perfect balance
    # --- SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 1
    # --- encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500                  # stubbed frontend frames
    # --- modality stub: "none" means tokens; otherwise input embeddings
    frontend: str = "none"               # none | audio | vision
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                    # silu | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    # Python-unroll the layer stacks instead of lax.scan. Used by the
    # dry-run's differential cost accounting: XLA's cost_analysis counts a
    # scan body ONCE regardless of trip count, so true per-step FLOPs /
    # bytes / collective totals are extracted from small unrolled lowerings
    # (L=1 vs L=2) and scaled. Never enable for real full-depth lowerings.
    unroll_layers: bool = False

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the embedding shards over 256 lanes/devices."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.mla_d_nope + self.rope_head_dim)
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k decode shape."""
        return (self.family in ("ssm", "hybrid")
                or (self.window > 0 and self.layer_pattern == "swa"))

    def n_params(self) -> int:
        """Approximate parameter count (embedding included once if tied)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            # rwkv6: tm (r,k,v,w,g,out ≈ 6 d²) + ffn (k: d·f, v: f·d, r: d²)
            per = 6 * d * d + 2 * d * f + d * d
            return L * per + emb
        if self.use_mla:
            att = (d * self.q_lora + self.q_lora * self.q_dim if self.q_lora
                   else d * self.q_dim)
            att += d * (self.kv_lora + self.rope_head_dim)
            att += self.kv_lora * self.n_heads * (self.mla_d_nope
                                                  + self.mla_d_v)
            att += self.n_heads * self.mla_d_v * d
        else:
            att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family in ("moe",):
            dense_ff = 3 * d * f
            moe_ff = (self.n_experts + self.n_shared_experts) * 3 * d * \
                self.d_expert + d * self.n_experts
            n_moe = L - self.n_dense_layers
            ff_total = self.n_dense_layers * dense_ff + n_moe * moe_ff
        else:
            ff_total = L * 3 * d * f
        total = L * att + ff_total + emb
        if self.family == "hybrid":
            di = d * self.ssm_expand
            total += L * (2 * d * di + di * d + di * self.ssm_state * 2)
        if self.family == "encdec":
            total += self.n_enc_layers * (4 * d * d + 3 * d * f)
            total += L * 4 * d * d   # cross-attention
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        n_moe = L - self.n_dense_layers
        inactive = n_moe * (self.n_experts - self.top_k) * 3 * d * \
            self.d_expert
        return int(self.n_params() - inactive)

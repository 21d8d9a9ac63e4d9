"""Seeded inputs and serving helpers for the port's LM tests.

Shared by the CPU parity tests (``tests/test_torch_lm*.py``, which hold
the port against the JAX package) and the card tests
(``tests/test_torch_cuda.py``, where JAX is not installed), so this
module imports only numpy and torch.
"""
import numpy as np
import torch

# the seven configs served with the reference's plain GQA attention
GQA_ARCHS = ("llama3_405b", "qwen2_72b", "qwen2_vl_72b", "gemma2_9b",
             "h2o_danube3_4b", "hymba_1_5b", "whisper_small")
# the moe family: routed + shared experts (deepseek-moe with GQA,
# deepseek-v2 with MLA and its latent cache)
MOE_ARCHS = ("deepseek_moe_16b", "deepseek_v2_236b")
# the parameters the reference initializes to a constant (zeros, ones,
# -4.6): drawn afresh here so that a misplaced one shows
CONSTANT_INIT = ("bq", "bk", "bv", "norm1", "norm2", "norm_post1",
                 "norm_post2", "norm_x", "norm_attn", "norm_ssm",
                 "beta_attn", "beta_ssm", "conv_b", "dt_bias", "D",
                 "final_norm", "enc_norm")


def perturbed(tree, rng, name=""):
    """A float32 numpy copy of a parameter tree (numpy or JAX arrays)
    with every leaf moved by seeded noise, so layers differ from one
    another (the reference's init repeats one layer) and the
    constant-initialized leaves are no longer constant."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    scale = 0.1 if name in CONSTANT_INIT else 0.02
    return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)


def batch(cfg, rng, B, S):
    """Tokens and labels uniform in [1, vocab), plus whisper's frames
    ``[B, enc_seq, d]``, as numpy arrays."""
    out = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)
                                   ).astype(np.float32)
    return out


def fill_cross(cfg, params, frames, cache):
    """Whisper's serving preparation, the port's copy of the reference
    test helper ``encode_and_fill_cross`` (``tests/test_archs.py``): run
    the encoder on ``frames`` and write each decoder layer's cross k/v
    into ``cache["xk"]`` / ``cache["xv"]`` (returned)."""
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        enc = tf.encode(cfg, params, frames)
        kv = [tf.cross_heads(cfg, tf.layer(params, i)["xattn"], enc)
              for i in range(cfg.n_layers)]
    cache["xk"] = torch.stack([k for k, _ in kv]).to(cache["xk"].dtype)
    cache["xv"] = torch.stack([v for _, v in kv]).to(cache["xv"].dtype)
    return cache

"""The port's GQA serving families against the JAX package, on the CPU:
the modules and the prefill forward.

The seven configs served with the reference's plain GQA attention
(dense ×5, hymba, whisper) at ``reduced(...)`` (2 layers or one gemma2
pair, d 64, heads of 16, d_ff 128, vocab 512, windows 16). The
reference's ``init_params(PRNGKey(0), float32)`` is moved by seeded
numpy noise (``helpers.torch_lm.perturbed``: layers differ, biases and
norms are not constant) and carried across with
``bridge.lm_params_from_reference``; tokens, frames, embeddings and
activations are drawn with numpy from a seed and handed to both
packages. ``rope``, ``blockwise_attention`` (small chunks, so chunks
are skipped outside a window and rows of a chunk masked whole),
``decode_attention``, ``gqa_qkv``, the Mamba head, ``layernorm``,
``init_params``, ``forward`` and ``loss_fn`` are held against the
reference's. The decode path is ``tests/test_torch_lm_decode.py``.

Tolerance: float32 on both sides, but XLA and ATen order their sums
differently, so values are held within 1e-4 of the largest magnitude
(the largest difference seen is ~1e-6 of it); shapes, dtypes and bf16
bits carried by the bridge are exact.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn, layers as jlayers  # noqa: E402
from repro.models import rope as jrope, ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import attention, layers, rope, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402

from helpers.torch_lm import GQA_ARCHS, batch, perturbed  # noqa: E402

TOL = 1e-4
B, S = 2, 24


def _close(got, want, tol=TOL):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _world(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    ref = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(sum(map(ord, arch)))
    p = perturbed(ref, rng)
    return dict(jcfg=jcfg, cfg=cfg, rng=rng,
                jp=jax.tree.map(jnp.asarray, p),
                tp=bridge.lm_params_from_reference(p, "cpu"))


_WORLDS: dict = {}


@pytest.fixture(params=GQA_ARCHS)
def world(request):
    if request.param not in _WORLDS:
        _WORLDS[request.param] = _world(request.param)
    return _WORLDS[request.param]


# ---------------------------------------------------------------------------
# rope, layernorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta,D", [(10_000.0, 16), (5e5, 128),
                                     (1e6, 120)])
def test_apply_rope(theta, D):
    """Interleaved pairs, float32 angles, the input's dtype back."""
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 9, 3, D)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 9)).astype(np.int32)
    _close(rope.rope_freqs(D, theta), jrope.rope_freqs(D, theta), 1e-6)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = rope.apply_rope(_t(x), _t(pos), theta)
    _close(got, want, 1e-5)
    half = rope.apply_rope(_t(x).to(torch.bfloat16), _t(pos), theta)
    assert half.dtype == torch.bfloat16
    # position 0 is the identity
    np.testing.assert_array_equal(
        rope.apply_rope(_t(x), torch.zeros((2, 9), dtype=torch.int32),
                        theta).numpy(), x)


def test_layernorm():
    rng = np.random.default_rng(1)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 5, 64), (64,), (64,)))
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1e-6)
    _close(layers.layernorm(_t(x), _t(w), _t(b), 1e-6), want, 1e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,cap,G,S_", [
    (True, 0, 0.0, 1, 40),
    (True, 16, 0.0, 1, 40),          # chunks skipped below the window
    (True, 16, 50.0, 4, 37),         # ... and a ragged last chunk
    (True, 7, 0.0, 4, 40),           # rows of a chunk masked whole
    (True, 0, 50.0, 4, 37),
    (False, 0, 0.0, 4, 37),
    (False, 0, 50.0, 1, 40),
    (False, 16, 0.0, 1, 40),
])
def test_blockwise_attention(causal, window, cap, G, S_):
    """Chunks of 8: the static schedule skips KV chunks below a window's
    reach and past the causal bound; NEG_INF keeps rows a chunk masks
    whole finite."""
    rng = np.random.default_rng(S_ + G + window)
    Hkv, D = 2, 16
    q = rng.normal(size=(2, Hkv * G, S_, D)).astype(np.float32) * 3
    k, v = (rng.normal(size=(2, Hkv, S_, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, cap=cap, q_chunk=8, kv_chunk=8)
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    # chunking does not change the values: one chunk of everything
    whole = attention.blockwise_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window, cap=cap)
    _close(got, whole)


def test_blockwise_attention_refuses_causal_cross_lengths():
    q = torch.zeros((1, 2, 5, 16))
    kv = torch.zeros((1, 2, 7, 16))
    with pytest.raises(ValueError, match="equal q/k lengths"):
        attention.blockwise_attention(q, kv, kv, causal=True)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_decode_attention(cap):
    """One query row a sequence against a cache whose tail past
    ``length`` holds garbage."""
    rng = np.random.default_rng(int(cap) + 3)
    q = rng.normal(size=(3, 8, 1, 16)).astype(np.float32) * 3
    kc, vc = (rng.normal(size=(3, 2, 32, 16)).astype(np.float32) * 5
              for _ in range(2))
    length = np.array([1, 17, 32], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(length),
                                  cap=cap)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(length),
                                     cap=cap)
    _close(got, want)
    kc[0, :, 1:] = 1e3                  # past length: no effect
    again = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(length),
                                       cap=cap)
    np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("arch", ["qwen2_72b", "llama3_405b"])
def test_gqa_qkv(arch):
    """qwen2 carries a q/k/v bias (drawn here), llama3 none."""
    w = _world(arch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 11, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11))
    jl = jax.tree.map(lambda a: a[1], w["jp"]["layers"])["attn"]
    want = jattn.gqa_qkv(w["jcfg"], jl, jnp.asarray(x), jnp.asarray(pos))
    got = attention.gqa_qkv(w["cfg"], tf.layer(w["tp"], 1)["attn"], _t(x),
                            _t(pos))
    assert ("bq" in jl) == w["cfg"].qkv_bias
    for g, j in zip(got, want):
        _close(g, j)


# ---------------------------------------------------------------------------
# the Mamba head (hymba)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hymba():
    w = _world("hymba_1_5b")
    w["jl"] = jax.tree.map(lambda a: a[0], w["jp"]["layers"])["ssm"]
    w["tl"] = tf.layer(w["tp"], 0)["ssm"]
    return w


def _mamba_state(cfg, rng, batch_):
    di = cfg.d_model * cfg.ssm_expand
    return (rng.normal(size=(batch_, cfg.ssm_conv - 1, di)).astype(
        np.float32), rng.normal(size=(batch_, di, cfg.ssm_state)).astype(
        np.float32))


@pytest.mark.parametrize("S_", [13, 1], ids=["sequence", "one_step"])
def test_mamba_head(hymba, S_):
    """Over a sequence and one step, both from a carried non-zero state:
    the output and the new conv tail and SSM state."""
    cfg, jcfg = hymba["cfg"], hymba["jcfg"]
    rng = np.random.default_rng(S_)
    x = rng.normal(size=(B, S_, 64)).astype(np.float32)
    conv, h = _mamba_state(cfg, rng, B)
    jo, jst = jssm.mamba_head(jcfg, hymba["jl"], jnp.asarray(x),
                              jssm.MambaState(jnp.asarray(conv),
                                              jnp.asarray(h)))
    to, tst = ssm.mamba_head(cfg, hymba["tl"], _t(x),
                             ssm.MambaState(_t(conv), _t(h)))
    _close(to, jo)
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)
    assert tst.h.dtype == torch.float32


def test_hybrid_mix_in_float32(hymba):
    """Hymba's mix: JAX promotes the float32 0-d betas times the bf16
    normalized outputs to float32, where PyTorch would stay in bf16; the
    port casts up, so the mix is float32 before the cast back."""
    rng = np.random.default_rng(12)
    a, m = (rng.normal(size=(B, 5, 64)).astype(np.float32)
            for _ in range(2))
    jl = hymba["jl"]
    ja, jm = (jnp.asarray(v, jnp.bfloat16) for v in (a, m))
    eps = hymba["cfg"].norm_eps
    want = (jl["beta_attn"] * jlayers.rmsnorm(ja, jl["norm_attn"], eps)
            + jl["beta_ssm"] * jlayers.rmsnorm(jm, jl["norm_ssm"], eps)
            ) * 0.5
    assert want.dtype == jnp.float32
    got = tf.hybrid_mix(hymba["cfg"], hymba["tl"],
                        _t(a).to(torch.bfloat16), _t(m).to(torch.bfloat16))
    assert got.dtype == torch.float32
    _close(got, want, 1e-2)


def test_mamba_zero_state(hymba):
    j = jssm.mamba_zero_state(hymba["jcfg"], 3)
    t = ssm.mamba_zero_state(hymba["cfg"], 3, device="cpu")
    for got, want in zip(t, j):
        assert tuple(got.shape) == want.shape and not got.any()
        assert str(got.dtype).split(".")[-1] == want.dtype.name


# ---------------------------------------------------------------------------
# init, the bridge, layer()
# ---------------------------------------------------------------------------

def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout(world, dtype):
    """Same names, shapes and dtypes as the reference's init (gemma2's
    pair stacks, whisper's encoder and cross keys, hymba's 0-d betas
    and float32 ``A_log``); stacks are materialised; one seed, one
    draw."""
    cfg = world["cfg"]
    jp = jax.eval_shape(lambda: jtf.init_params(
        world["jcfg"], jax.random.PRNGKey(0), dtype=getattr(jnp, dtype)))
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=getattr(torch, dtype), device="cpu")
    flat_j, flat_t = _flat(jp), _flat(tp)
    assert flat_t.keys() == flat_j.keys()
    for name, a in flat_j.items():
        assert tuple(flat_t[name].shape) == a.shape, name
        assert str(flat_t[name].dtype).split(".")[-1] == a.dtype.name, name
    for name, t in flat_t.items():
        if "layers" in name:
            assert t.stride(0) != 0 and t.is_contiguous(), name
            assert torch.equal(t[0], t[-1]), name
    again = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=getattr(torch, dtype), device="cpu")
    assert all(torch.equal(t, _flat(again)[n]) for n, t in flat_t.items())


def test_bridge_carries_bf16_bit_for_bit(world):
    """The reference's bf16 init across the bridge: nested dicts, 0-d
    float32 betas, float32 ``A_log``, bit for bit."""
    jp = jtf.init_params(world["jcfg"], jax.random.PRNGKey(3),
                         dtype=jnp.bfloat16)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    flat_t = _flat(tp)
    assert flat_t.keys() == _flat(jp).keys()
    for name, a in _flat(jp).items():
        t, a = flat_t[name], np.asarray(a)
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert tuple(t.shape) == a.shape, name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name


def test_layer_recurses(world):
    """``layer(params, i)`` indexes every nested stack (gemma2's pair,
    hymba's ``ssm``, whisper's ``xattn`` and ``enc_layers``)."""
    for stack in ("layers", "enc_layers"):
        if stack not in world["jp"]:
            continue
        n = jax.tree.leaves(world["jp"][stack])[0].shape[0]
        assert tf.depth(world["tp"], stack) == n
        want = _flat(jax.tree.map(lambda a: a[n - 1], world["jp"][stack]))
        got = _flat(tf.layer(world["tp"], n - 1, stack))
        assert got.keys() == want.keys()
        for name, a in want.items():
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(a))


def test_entry_points_default_to_the_card(world):
    """Without ``device`` the new entry points allocate on the card, and
    raise where there is none: they never fall back to the host."""
    cfg = world["cfg"]
    makers = [lambda: tf.init_params(cfg, torch.Generator().manual_seed(0))[
                  "final_norm"],
              lambda: kvcache.make_cache(cfg, 1, 8)["pos"]]
    if cfg.family == "hybrid":
        makers.append(lambda: ssm.mamba_zero_state(cfg, 1).h)
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

def _batches(w, S_=S, seed=7):
    nb = batch(w["cfg"], np.random.default_rng(seed), B, S_)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: _t(v) for k, v in nb.items()})


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(functools.partial(jtf.forward, jcfg, remat_policy=None))


def test_forward_logits(world):
    """Prefill logits over 24 tokens, past the reduced window of 16."""
    jb, tb = _batches(world)
    jb.pop("labels"), tb.pop("labels")
    want = _jit_forward(world["jcfg"])(world["jp"], jb)
    with torch.no_grad():
        got = tf.forward(world["cfg"], world["tp"], tb)
    assert tuple(got.shape) == (B, S, world["cfg"].vocab_padded)
    _close(got, want)


def test_forward_bf16(world):
    """bf16 weights (the reference's init, carried bit for bit) and bf16
    activations on both sides: the logits' dtype, and their values
    within 3e-2 of the largest (bf16 rounds at 2^-8, and the two
    libraries round intermediate products at different places)."""
    jp = jtf.init_params(world["jcfg"], jax.random.PRNGKey(4),
                         dtype=jnp.bfloat16)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    jb, tb = _batches(world, seed=13)
    jb.pop("labels"), tb.pop("labels")
    want = _jit_forward(world["jcfg"])(jp, jb)
    with torch.no_grad():
        got = tf.forward(world["cfg"], tp, tb)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)


def test_forward_embeds():
    """qwen2-vl's modality stub: ``{"embeds": [B, S, d]}`` in place of
    tokens (cast to the params' dtype)."""
    w = _world("qwen2_vl_72b")
    e = np.random.default_rng(8).normal(size=(B, 19, 64)).astype(np.float32)
    want = _jit_forward(w["jcfg"])(w["jp"], {"embeds": jnp.asarray(e)})
    with torch.no_grad():
        got = tf.forward(w["cfg"], w["tp"], {"embeds": _t(e)})
    _close(got, want)


def test_loss_fn(world):
    jb, tb = _batches(world, seed=9)
    mask = np.random.default_rng(10).uniform(size=(B, S)) < 0.7
    jb["loss_mask"] = jnp.asarray(mask, jnp.float32)
    tb["loss_mask"] = _t(mask.astype(np.float32))
    want = float(jax.jit(functools.partial(
        jtf.loss_fn, world["jcfg"], remat_policy=None))(world["jp"], jb))
    with torch.no_grad():
        got = float(tf.loss_fn(world["cfg"], world["tp"], tb))
    np.testing.assert_allclose(got, want, rtol=TOL)

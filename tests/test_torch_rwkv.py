"""The port's rwkv6 serving path against the JAX package, on the CPU.

At ``reduced(rwkv6_3b)`` (2 layers, d 64, 4 heads of dk 16, d_ff 128,
vocab 512) the reference's ``init_params(PRNGKey(0), float32)`` is
carried across with ``bridge.lm_params_from_reference``; tokens, states
and activations are drawn with numpy from a seed and handed to both
packages. The time-mix, channel-mix, ``forward``, the decode cache,
``decode_step`` and ``prefill_via_decode`` are held against the
reference's, and the port's own decode against its forward (the
reference's ``test_decode_matches_forward``, rel < 2e-2).

Tolerance: float32 on both sides, but the op order differs — the
reference runs its chunked scan (Pallas, interpret mode) where the port's
CPU path runs the sequential scan, and XLA and ATen order their matmul
sums differently — so values are held to rtol = atol = 1e-4 (the largest
difference seen is ~1e-5 on logits of magnitude ~3). Integer fields
(``pos``) and the configs are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm, transformer as jtf  # noqa: E402
from repro.serving import decode as jdecode, kvcache as jkv  # noqa: E402

from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import ssm, transformer as tf  # noqa: E402
from repro_torch.serving import decode, kvcache  # noqa: E402

TOL = 1e-4
B, S = 2, 12


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.reduced(jconfigs.get_config("rwkv6_3b"))
    cfg = configs.reduced(configs.get_config("rwkv6_3b"))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, toks=toks, rng=rng,
                jl0=jax.tree.map(lambda a: a[0], jp["layers"]),
                tl0=tf.layer(tp, 0))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(configs.reduced(t)) == \
        dataclasses.asdict(jconfigs.reduced(j))
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.vocab_padded == j.vocab_padded
    assert configs.reduced(t).n_params() == jconfigs.reduced(j).n_params()


def test_registry_matches_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ALIASES == jconfigs.ALIASES
    assert {a: dataclasses.asdict(c) for a, c in
            configs.all_configs().items()} == \
        {a: dataclasses.asdict(c) for a, c in
         jconfigs.all_configs().items()}
    assert configs.get_config("rwkv6-3b") == configs.get_config("rwkv6_3b")


# ---------------------------------------------------------------------------
# init and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout(world, dtype):
    """Same names, shapes and dtypes as the reference's init; the layer
    stack is materialised, and one seed gives one draw."""
    cfg = world["cfg"]
    jp = jax.eval_shape(lambda: jtf.init_params(
        world["jcfg"], jax.random.PRNGKey(0), dtype=getattr(jnp, dtype)))
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=getattr(torch, dtype), device="cpu")
    flat_j = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_leaves_with_path(tp)}
    assert flat_t.keys() == flat_j.keys()
    for name, a in flat_j.items():
        assert tuple(flat_t[name].shape) == a.shape, name
        assert str(flat_t[name].dtype).split(".")[-1] == a.dtype.name, name
    lay = tp["layers"]
    assert all(v.stride(0) != 0 and v.is_contiguous() for v in lay.values())
    assert torch.equal(lay["wr"][0], lay["wr"][1])
    # truncated at 2 sigma, scaled by 1/sqrt(fan_in) (rounding of bf16
    # can reach a hair past the bound)
    bound = 2 / np.sqrt(cfg.d_model) * (1 + 2 ** -7)
    assert float(lay["wr"].float().abs().max()) <= bound
    again = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=getattr(torch, dtype), device="cpu")
    assert all(torch.equal(again["layers"][k], v) for k, v in lay.items())
    assert torch.equal(again["embed"], tp["embed"])


def test_bridge_carries_bf16_bit_for_bit(world):
    jp = jtf.init_params(world["jcfg"], jax.random.PRNGKey(3),
                         dtype=jnp.bfloat16)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(a)
        assert str(t.dtype).split(".")[-1] == a.dtype.name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("make", [
    lambda cfg: tf.init_params(cfg, torch.Generator().manual_seed(0))[
        "embed"],
    lambda cfg: kvcache.make_cache(cfg, 1, 8)["wkv"],
    lambda cfg: ssm.rwkv_zero_state(cfg, 1).wkv,
], ids=["init_params", "make_cache", "rwkv_zero_state"])
def test_entry_points_default_to_the_card(world, make):
    """Without ``device`` the LM entry points allocate on the card, and
    raise where there is none: they never fall back to the host."""
    if torch.cuda.is_available():
        assert make(world["cfg"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(world["cfg"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_ddlerp(world):
    rng = np.random.default_rng(1)
    x, xx = (rng.normal(size=(B, S, 64)).astype(np.float32)
             for _ in range(2))
    jl, tl = world["jl0"], world["tl0"]
    want = jssm._ddlerp(jnp.asarray(x), jnp.asarray(xx), jl["mu_k"],
                        jl["la_k"], jl["lb_k"])
    got = ssm._ddlerp(_t(x), _t(xx), tl["mu_k"], tl["la_k"], tl["lb_k"])
    _close(got, want)


def test_time_mix_sequence(world):
    """S = 12: the scan (the reference's interpret-mode kernel, the port's
    plain version) over the sequence; the state passes through."""
    rng = np.random.default_rng(2)
    cfg, jcfg = world["cfg"], world["jcfg"]
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    shift = rng.normal(size=(B, 64)).astype(np.float32)
    wkv = np.zeros((B, 4, 16, 16), np.float32)
    jo = jssm.rwkv_time_mix(jcfg, world["jl0"], jnp.asarray(x),
                            jnp.asarray(shift), jnp.asarray(wkv))
    with torch.no_grad():
        to = ssm.rwkv_time_mix(cfg, world["tl0"], _t(x), _t(shift), _t(wkv))
    for got, want in zip(to, jo):
        _close(got, want)


def test_time_mix_decode_step(world):
    """S = 1 against a carried, non-zero wkv state."""
    rng = np.random.default_rng(3)
    cfg, jcfg = world["cfg"], world["jcfg"]
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    shift = rng.normal(size=(B, 64)).astype(np.float32)
    wkv = rng.normal(size=(B, 4, 16, 16)).astype(np.float32)
    jo = jssm.rwkv_time_mix(jcfg, world["jl0"], jnp.asarray(x),
                            jnp.asarray(shift), jnp.asarray(wkv))
    with torch.no_grad():
        to = ssm.rwkv_time_mix(cfg, world["tl0"], _t(x), _t(shift), _t(wkv))
    assert not np.allclose(np.asarray(jo[2]), wkv)
    for got, want in zip(to, jo):
        _close(got, want)


def test_channel_mix(world):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    shift = rng.normal(size=(B, 64)).astype(np.float32)
    jo = jssm.rwkv_channel_mix(world["jcfg"], world["jl0"], jnp.asarray(x),
                               jnp.asarray(shift))
    with torch.no_grad():
        to = ssm.rwkv_channel_mix(world["cfg"], world["tl0"], _t(x),
                                  _t(shift))
    for got, want in zip(to, jo):
        _close(got, want)


def test_zero_state(world):
    j = jssm.rwkv_zero_state(world["jcfg"], 3)
    t = ssm.rwkv_zero_state(world["cfg"], 3, device="cpu")
    for got, want in zip(t, j):
        assert tuple(got.shape) == want.shape and not got.any()
        assert str(got.dtype).split(".")[-1] == want.dtype.name


# ---------------------------------------------------------------------------
# forward, cache, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def logits(world):
    want = jtf.forward(world["jcfg"], world["jp"],
                       {"tokens": jnp.asarray(world["toks"])},
                       remat_policy=None)
    with torch.no_grad():
        got = tf.forward(world["cfg"], world["tp"],
                         {"tokens": _t(world["toks"])})
    return got, np.asarray(want)


def test_forward_logits(world, logits):
    got, want = logits
    assert tuple(got.shape) == (B, S, world["cfg"].vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_cache(world, dtype):
    j = jkv.make_cache(world["jcfg"], 3, 64, dtype=getattr(jnp, dtype))
    t = kvcache.make_cache(world["cfg"], 3, 64, dtype=getattr(torch, dtype),
                           device="cpu")
    assert t.keys() == j.keys()
    for name in j:
        assert tuple(t[name].shape) == j[name].shape, name
        assert str(t[name].dtype).split(".")[-1] == j[name].dtype.name
        assert not t[name].any()
    assert kvcache.cache_bytes(t) == jkv.cache_bytes(j)


def _random_cache(world, seed):
    rng = np.random.default_rng(seed)
    cache = jkv.make_cache(world["jcfg"], B, 16, dtype=jnp.float32)
    cache = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                 if k != "pos" else jnp.asarray(5, jnp.int32))
             for k, v in cache.items()}
    return cache, bridge.lm_cache_from_reference(cache, "cpu")


def test_decode_step(world):
    """One step from a non-zero cache: logits and every cache field."""
    jc, tc = _random_cache(world, 5)
    tok = world["toks"][:, :1]
    want, jnew = jdecode.decode_step(world["jcfg"], world["jp"], jc,
                                     jnp.asarray(tok))
    before = {k: v.clone() for k, v in tc.items()}
    with torch.no_grad():
        got, tnew = decode.decode_step(world["cfg"], world["tp"], tc,
                                       _t(tok))
    _close(got, want)
    assert tnew.keys() == jnew.keys()
    assert int(tnew["pos"]) == int(jnew["pos"]) == 6
    assert tnew["pos"].dtype == torch.int32
    for name in ("tm_shift", "cm_shift", "wkv"):
        _close(tnew[name], jnew[name])
    assert all(torch.equal(tc[k], before[k]) for k in tc)  # not in place


def test_prefill_via_decode(world):
    cfg, jcfg = world["cfg"], world["jcfg"]
    toks = world["toks"]
    want, jc = jdecode.prefill_via_decode(
        jcfg, world["jp"], jkv.make_cache(jcfg, B, 16, dtype=jnp.float32),
        jnp.asarray(toks))
    with torch.no_grad():
        got, tc = decode.prefill_via_decode(
            cfg, world["tp"], kvcache.make_cache(cfg, B, 16,
                                                 dtype=torch.float32,
                                                 device="cpu"),
            _t(toks))
    _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for name in ("tm_shift", "cm_shift", "wkv"):
        _close(tc[name], jc[name])


def test_decode_matches_forward(world, logits):
    """The port's own serving check, as the reference's: the last logits
    of a prompt decoded token by token against forward's last position
    (rel < 2e-2, ``tests/test_archs.py``)."""
    cfg = world["cfg"]
    with torch.no_grad():
        got, _ = decode.prefill_via_decode(
            cfg, world["tp"], kvcache.make_cache(cfg, B, 16,
                                                 dtype=torch.float32,
                                                 device="cpu"),
            _t(world["toks"]))
    ref = logits[0][:, -1]
    rel = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    assert rel < 2e-2, rel

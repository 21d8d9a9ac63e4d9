"""The port's GQA serving families against the JAX package, on the CPU:
the decode caches and the decode step.

The same worlds as ``tests/test_torch_lm.py`` (the seven configs at
``reduced(...)``, the reference's float32 init moved by seeded numpy
noise, carried across by ``bridge``). ``make_cache`` (layout and
``cache_bytes``), ``decode_step`` from a seeded non-zero cache (every
field, before and after the ring wraps, and the cache it was given left
as it was), ``prefill_via_decode`` over 24 tokens (past the reduced
window of 16, so the windowed caches wrap; the reference's own test
stops at 12) against the reference's, and the port's decode against its
own forward (rel < 2e-2, the reference's ``test_decode_matches_forward``
bound). Whisper's cross cache is filled from the same frames on both
sides: the reference's test helper ``encode_and_fill_cross`` and the
port's copy (``helpers.torch_lm.fill_cross``). Tolerance: within 1e-4
of the largest magnitude (float32, sums in another order); ``pos`` and
the layouts are exact. The moe family's decode path is in
``tests/test_torch_moe.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import decode as jdecode, kvcache as jkv  # noqa: E402

from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import decode, kvcache  # noqa: E402

from helpers.torch_lm import (  # noqa: E402
    GQA_ARCHS, batch, fill_cross, perturbed)
from test_archs import encode_and_fill_cross  # noqa: E402

TOL = 1e-4
B, S, SLOTS = 2, 24, 32


def _close(got, want, tol=TOL):
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
    nb = batch(cfg, np.random.default_rng(11), B, S)
    return dict(jcfg=jcfg, cfg=cfg, jp=jax.tree.map(jnp.asarray, p),
                tp=bridge.lm_params_from_reference(p, "cpu"), nb=nb,
                step=jax.jit(jdecode.decode_step, static_argnums=0))


_WORLDS: dict = {}


@pytest.fixture(params=GQA_ARCHS)
def world(request):
    if request.param not in _WORLDS:
        _WORLDS[request.param] = _world(request.param)
    return _WORLDS[request.param]


def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_cache(world, dtype):
    """Names, shapes, dtypes and zeros as the reference's (gemma2's
    local and global stacks, an O(window) cache for swa, hymba's conv
    tail and float32 state, whisper's cross k/v), and the same
    ``cache_bytes``."""
    for seq_len in (SLOTS, 8):
        j = jkv.make_cache(world["jcfg"], 3, seq_len,
                           dtype=getattr(jnp, dtype))
        t = kvcache.make_cache(world["cfg"], 3, seq_len,
                               dtype=getattr(torch, dtype), device="cpu")
        fj, ft = _flat(j), _flat(t)
        assert ft.keys() == fj.keys()
        for name, a in fj.items():
            assert tuple(ft[name].shape) == a.shape, name
            assert str(ft[name].dtype).split(".")[-1] == a.dtype.name, name
            assert not ft[name].any(), name
        assert kvcache.cache_bytes(t) == jkv.cache_bytes(j)


def _random_cache(world, seed, pos):
    """A reference cache of ``SLOTS`` slots filled with seeded noise at
    ``pos``, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    cache = jkv.make_cache(world["jcfg"], B, SLOTS, dtype=jnp.float32)
    cache = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        cache)
    cache["pos"] = jnp.asarray(pos, jnp.int32)
    return cache, bridge.lm_cache_from_reference(cache, "cpu")


@pytest.mark.parametrize("pos", [5, 21, 40],
                         ids=["early", "ring_wrapped", "past_the_cache"])
def test_decode_step(world, pos):
    """One step from a non-zero cache: logits and every cache field. At
    21 the windowed rings (16 slots) have wrapped; at 40 the full caches
    (32 slots) are past their end and write their last slot, as the
    reference's."""
    jc, tc = _random_cache(world, pos, pos)
    tok = world["nb"]["tokens"][:, :1]
    want, jnew = world["step"](world["jcfg"], world["jp"], jc,
                               jnp.asarray(tok))
    before = {n: t.clone() for n, t in _flat(tc).items()}
    with torch.no_grad():
        got, tnew = decode.decode_step(world["cfg"], world["tp"], tc,
                                       _t(tok))
    _close(got, want)
    fj, ft = _flat(jnew), _flat(tnew)
    assert ft.keys() == fj.keys()
    assert int(tnew["pos"]) == int(jnew["pos"]) == pos + 1
    assert tnew["pos"].dtype == torch.int32
    for name, a in fj.items():
        assert str(ft[name].dtype).split(".")[-1] == a.dtype.name, name
        _close(ft[name], a)
    assert all(torch.equal(t, before[n]) for n, t in _flat(tc).items())


def test_decode_step_bf16(world):
    """bf16 weights and a bf16 cache on both sides: every new field
    keeps the reference's dtype (hymba's conv tail in the model's dtype,
    its SSM state in float32), and the values agree within 3e-2 of the
    largest (bf16 rounding)."""
    jp = jtf.init_params(world["jcfg"], jax.random.PRNGKey(5),
                         dtype=jnp.bfloat16)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    rng = np.random.default_rng(6)
    jc = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape), a.dtype), jkv.make_cache(
            world["jcfg"], B, SLOTS, dtype=jnp.bfloat16))
    jc["pos"] = jnp.asarray(19, jnp.int32)
    tc = bridge.lm_cache_from_reference(jc, "cpu")
    tok = world["nb"]["tokens"][:, :1]
    want, jnew = world["step"](world["jcfg"], jp, jc, jnp.asarray(tok))
    with torch.no_grad():
        got, tnew = decode.decode_step(world["cfg"], tp, tc, _t(tok))
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 3e-2)
    fj, ft = _flat(jnew), _flat(tnew)
    assert ft.keys() == fj.keys()
    for name, a in fj.items():
        assert str(ft[name].dtype).split(".")[-1] == a.dtype.name, name
        _close(ft[name].float(), np.asarray(a, np.float32), 3e-2)


def _prompt_cache(world, which):
    """The empty f32 cache for the prompt, with whisper's cross k/v
    filled from the batch's frames."""
    if which == "reference":
        c = jkv.make_cache(world["jcfg"], B, SLOTS, dtype=jnp.float32)
        if world["cfg"].family == "encdec":
            c = encode_and_fill_cross(world["jcfg"], world["jp"],
                                      jnp.asarray(world["nb"]["frames"]), c)
        return c
    c = kvcache.make_cache(world["cfg"], B, SLOTS, dtype=torch.float32,
                           device="cpu")
    if world["cfg"].family == "encdec":
        c = fill_cross(world["cfg"], world["tp"], _t(world["nb"]["frames"]),
                       c)
    return c


def test_prefill_via_decode(world):
    """24 tokens decoded one by one on both sides: the last logits and
    the whole cache."""
    toks = world["nb"]["tokens"]
    jc = _prompt_cache(world, "reference")
    for t in range(S):
        want, jc = world["step"](world["jcfg"], world["jp"], jc,
                                 jnp.asarray(toks[:, t:t + 1]))
    with torch.no_grad():
        got, tc = decode.prefill_via_decode(
            world["cfg"], world["tp"], _prompt_cache(world, "port"),
            _t(toks))
    _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    fj, ft = _flat(jc), _flat(tc)
    assert ft.keys() == fj.keys()
    for name, a in fj.items():
        _close(ft[name], a)


def test_decode_matches_forward(world):
    """The port's own serving check: the last logits of the prompt
    decoded token by token against its forward's last position (rel <
    2e-2, the reference's bound), argmax equal."""
    tb = {k: _t(v) for k, v in world["nb"].items() if k != "labels"}
    with torch.no_grad():
        ref = tf.forward(world["cfg"], world["tp"], tb)[:, -1]
        got, _ = decode.prefill_via_decode(
            world["cfg"], world["tp"], _prompt_cache(world, "port"),
            tb["tokens"])
    rel = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    assert rel < 2e-2, rel
    assert torch.equal(got.argmax(-1), ref.argmax(-1))

"""The port's moe family against the JAX package, on the CPU: routing,
the MoE block, MLA, the model and its decode path.

Both moe configs at ``reduced(...)``: 2 layers (1 dense + 1 MoE), d 64,
8 experts, top 2, ``d_expert`` 32, 2 shared experts; deepseek-moe with
GQA heads of 16, deepseek-v2 with MLA (``kv_lora`` 32, ``q_lora`` 32,
``rope_head_dim`` 8, d_nope = d_v = 16). The reference's
``init_params(PRNGKey(0), float32)`` is moved by seeded numpy noise
(``helpers.torch_lm.perturbed``) and carried across with
``bridge.lm_params_from_reference``; inputs are drawn with numpy from a
seed and handed to both packages.

Tolerance: integer outputs (expert ids, ties included, ``load``, the
dropped fraction, cache layouts and ``pos``) are exact; float outputs are
held within 1e-4 of the largest magnitude (float32 on both sides, sums
in another order), gates within 1e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn, moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import decode as jdecode, kvcache as jkv  # noqa: E402

from repro_torch import bridge, configs  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import decode, kvcache  # noqa: E402

from helpers.torch_lm import MOE_ARCHS, batch, perturbed  # noqa: E402

TOL = 1e-4
B, S, SLOTS = 2, 24, 32


def _close(got, want, tol=TOL):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree):
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _world(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    ref = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(sum(map(ord, arch)))
    p = perturbed(ref, rng)
    return dict(jcfg=jcfg, cfg=cfg, jp=jax.tree.map(jnp.asarray, p),
                tp=bridge.lm_params_from_reference(p, "cpu"),
                nb=batch(cfg, np.random.default_rng(11), B, S),
                step=jax.jit(jdecode.decode_step, static_argnums=0))


_WORLDS: dict = {}


@pytest.fixture(params=MOE_ARCHS)
def world(request):
    if request.param not in _WORLDS:
        _WORLDS[request.param] = _world(request.param)
    return _WORLDS[request.param]


def _drop_free(cfg):
    """The reference test's drop-free capacity (``tests/test_archs.py``):
    ``capacity_factor = n_experts`` gives every expert room for every
    pair."""
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


# ---------------------------------------------------------------------------
# routing and the MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["seeded", "ties"])
def test_route_topk(case):
    """Ids exact, gates within 1e-6. ``ties``: scores on a coarse
    lattice, so most rows hold equal scores across the top-k boundary
    and inside it; ``jax.lax.top_k`` puts the lower id first."""
    rng = np.random.default_rng(3)
    if case == "ties":
        scores = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4
        scores[0] = 0.5                                   # a row all tied
    else:
        scores = rng.uniform(size=(64, 8)).astype(np.float32)
    for k in (1, 2, 6):
        jids, jg = jmoe.route_topk(jnp.asarray(scores), k)
        ids, g = moe.route_topk(_t(scores), k)
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
    if case == "ties":
        np.testing.assert_array_equal(moe.route_topk(_t(scores), 6)[0][0],
                                      np.arange(6))


def _moe_layer(world):
    return (jax.tree.map(lambda a: a[0], world["jp"]["layers"])["moe"],
            tf.layer(world["tp"], 0)["moe"])


@pytest.mark.parametrize("mode", ["capacity_1.25", "drop_free",
                                  "deterministic"])
def test_moe_ffn(world, mode):
    """The block at the published capacity factor 1.25 (pairs dropped:
    asserted), at the drop-free capacity, and at a
    ``deterministic_capacity`` of 5: ``load`` and ``dropped_frac``
    exact, the output within 1e-4."""
    cfg = world["cfg"]
    jl, tl = _moe_layer(world)
    x = np.random.default_rng(17).normal(size=(B, 40, 64)).astype(
        np.float32)
    kw = {"capacity_1.25": {},
          "drop_free": {"capacity_factor": float(cfg.n_experts)},
          "deterministic": {"deterministic_capacity": 5}}[mode]
    want, jst = jmoe.moe_ffn(world["jcfg"], jl, jnp.asarray(x), **kw)
    got, st = moe.moe_ffn(cfg, tl, _t(x), **kw)
    _close(got, want)
    assert st.load.dtype == torch.int32
    np.testing.assert_array_equal(st.load.numpy(), np.asarray(jst.load))
    assert float(st.dropped_frac) == float(jst.dropped_frac)
    if mode == "drop_free":
        assert float(st.dropped_frac) == 0.0
    else:
        assert float(st.dropped_frac) > 0.0


def test_moe_ffn_bf16(world):
    """bf16 activations and weights (the router stays float32): the
    output's dtype, the integer stats exact, the values within 3e-2 of
    the largest (bf16 rounding), and two runs bit-identical."""
    jl, tl = _moe_layer(world)
    jl = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in jl.items()}
    tl = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tl.items()}
    x = np.random.default_rng(18).normal(size=(B, 40, 64)).astype(
        np.float32)
    want, jst = jmoe.moe_ffn(world["jcfg"], jl, jnp.asarray(x, jnp.bfloat16))
    got, st = moe.moe_ffn(world["cfg"], tl, _t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.load.numpy(), np.asarray(jst.load))
    assert float(st.dropped_frac) == float(jst.dropped_frac)
    _close(got.float(), np.asarray(want, np.float32), 3e-2)
    again, _ = moe.moe_ffn(world["cfg"], tl, _t(x).to(torch.bfloat16))
    assert torch.equal(again.view(torch.int16), got.view(torch.int16))


def test_moe1(world):
    """Decode's MoE on one token a row: every row's k experts' weights
    gathered, no capacity."""
    jl, tl = _moe_layer(world)
    x = np.random.default_rng(19).normal(size=(5, 64)).astype(np.float32)
    want = jdecode._moe1(world["jcfg"], jl, jnp.asarray(x))
    _close(decode._moe1(world["cfg"], tl, _t(x)), want)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def v2():
    w = _world("deepseek_v2_236b")
    w["jl"] = jax.tree.map(lambda a: a[0], w["jp"]["layers"])["attn"]
    w["tl"] = tf.layer(w["tp"], 0)["attn"]
    return w


def _mla_inputs(S_=19):
    rng = np.random.default_rng(23)
    x = rng.normal(size=(B, S_, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_, dtype=np.int32), (B, S_))
    return x, pos


def test_mla_project(v2):
    """The q_lora bottleneck, the split into nope and rope halves, RoPE
    on the queries' rope half and on the one shared rope key."""
    x, pos = _mla_inputs()
    want = jattn.mla_project(v2["jcfg"], v2["jl"], jnp.asarray(x),
                             jnp.asarray(pos))
    got = attention.mla_project(v2["cfg"], v2["tl"], _t(x), _t(pos))
    assert got._fields == want._fields
    for g, j in zip(got, want):
        _close(g, j)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention(v2, causal):
    """Per-head K/V from the latent, D 24 against Dv 16, in chunks of 8
    (a ragged last chunk)."""
    x, pos = _mla_inputs()
    jproj = jattn.mla_project(v2["jcfg"], v2["jl"], jnp.asarray(x),
                              jnp.asarray(pos))
    tproj = attention.MLAProj(*(_t(a) for a in jproj))
    kw = dict(causal=causal, q_chunk=8, kv_chunk=8)
    want = jattn.mla_attention(v2["jcfg"], v2["jl"], jproj, **kw)
    got = attention.mla_attention(v2["cfg"], v2["tl"], tproj, **kw)
    assert tuple(got.shape) == (B, 19, v2["cfg"].n_heads * v2["cfg"].mla_d_v)
    _close(got, want)


# ---------------------------------------------------------------------------
# init, the bridge, forward, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout(world, dtype):
    """Same names, shapes and dtypes as the reference's init:
    ``dense_layers`` (one block with the dense FFN at ``d_ff``) beside
    ``layers`` (the MoE blocks), the router float32 in a bf16 init, the
    MLA weights; stacks materialised; one seed, one draw."""
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
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert "mlp" not in tp["layers"] and "moe" not in tp["dense_layers"]
    assert tf.depth(tp, "dense_layers") == cfg.n_dense_layers
    assert tf.depth(tp) == cfg.n_layers - cfg.n_dense_layers
    for name, t in flat_t.items():
        if "layers" in name:
            assert t.stride(0) != 0 and t.is_contiguous(), name
    again = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=getattr(torch, dtype), device="cpu")
    assert all(torch.equal(t, _flat(again)[n]) for n, t in flat_t.items())


def test_bridge_carries_bf16_bit_for_bit(world):
    """The reference's bf16 init across the bridge: ``dense_layers``,
    the float32 router, the MLA weights, bit for bit."""
    jp = jtf.init_params(world["jcfg"], jax.random.PRNGKey(3),
                         dtype=jnp.bfloat16)
    tp = bridge.lm_params_from_reference(jp, "cpu")
    flat_t = _flat(tp)
    assert flat_t.keys() == _flat(jp).keys()
    assert "['dense_layers']['mlp']['wi']" in flat_t
    assert flat_t["['layers']['moe']['router']"].dtype == torch.float32
    for name, a in _flat(jp).items():
        t, a = flat_t[name], np.asarray(a)
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        if a.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), a), name


def test_entry_points_default_to_the_card(world):
    """Without ``device`` the entry points allocate on the card, and
    raise where there is none."""
    cfg = world["cfg"]
    for make in (lambda: tf.init_params(
            cfg, torch.Generator().manual_seed(0))["final_norm"],
                 lambda: kvcache.make_cache(cfg, 1, 8)["pos"]):
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg):
    return jax.jit(functools.partial(jtf.forward, jcfg, remat_policy=None))


@pytest.mark.parametrize("capacity", ["published", "drop_free"])
def test_forward_logits(world, capacity):
    """Prefill logits over 24 tokens: the dense layer, then the MoE
    layer, at the published capacity factor (pairs dropped) and the
    drop-free one."""
    jcfg, cfg = world["jcfg"], world["cfg"]
    if capacity == "drop_free":
        jcfg, cfg = _drop_free(jcfg), _drop_free(cfg)
    toks = world["nb"]["tokens"]
    want = _jit_forward(jcfg)(world["jp"], {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tf.forward(cfg, world["tp"], {"tokens": _t(toks)})
    assert tuple(got.shape) == (B, S, cfg.vocab_padded)
    _close(got, want)


def test_loss_fn(world):
    nb = world["nb"]
    mask = np.random.default_rng(10).uniform(size=(B, S)) < 0.7
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: _t(v) for k, v in nb.items()}
    jb["loss_mask"] = jnp.asarray(mask, jnp.float32)
    tb["loss_mask"] = _t(mask.astype(np.float32))
    want = float(jax.jit(functools.partial(
        jtf.loss_fn, world["jcfg"], remat_policy=None))(world["jp"], jb))
    with torch.no_grad():
        got = float(tf.loss_fn(world["cfg"], world["tp"], tb))
    np.testing.assert_allclose(got, want, rtol=TOL)


# ---------------------------------------------------------------------------
# the caches and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_cache(world, dtype):
    """deepseek-v2: the latent ``ckv`` / ``krope`` over all layers;
    deepseek-moe: k/v over the MoE layers and a ``dense`` stack; names,
    shapes, dtypes, zeros and ``cache_bytes`` as the reference's."""
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
    assert set(t) == ({"pos", "ckv", "krope"} if world["cfg"].use_mla
                      else {"pos", "k", "v", "dense"})


def _random_cache(world, seed, pos):
    """A reference cache of ``SLOTS`` slots filled with seeded noise at
    ``pos``, and the port's copy of it (``bridge``)."""
    rng = np.random.default_rng(seed)
    cache = jkv.make_cache(world["jcfg"], B, SLOTS, dtype=jnp.float32)
    cache = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        cache)
    cache["pos"] = jnp.asarray(pos, jnp.int32)
    return cache, bridge.lm_cache_from_reference(cache, "cpu")


@pytest.mark.parametrize("pos", [5, 31, 40],
                         ids=["early", "last_slot", "past_the_cache"])
def test_decode_step(world, pos):
    """One step from a non-zero cache carried across by the bridge:
    logits and every cache leaf. At 40 the 32 slots are past: the GQA
    stacks write their last slot, and MLA's latent write is dropped, as
    the reference's; the cache given is left as it was."""
    jc, tc = _random_cache(world, pos, pos)
    assert _flat(tc).keys() == _flat(jc).keys()
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
    for name, a in fj.items():
        assert str(ft[name].dtype).split(".")[-1] == a.dtype.name, name
        _close(ft[name], a)
    assert all(torch.equal(t, before[n]) for n, t in _flat(tc).items())
    if pos >= SLOTS and world["cfg"].use_mla:
        for n in ("ckv", "krope"):
            assert torch.equal(tnew[n], tc[n]), n


def test_prefill_via_decode(world):
    """24 tokens decoded one by one on both sides from an empty cache:
    the last logits and every cache leaf."""
    toks = world["nb"]["tokens"]
    jc = jkv.make_cache(world["jcfg"], B, SLOTS, dtype=jnp.float32)
    for t in range(S):
        want, jc = world["step"](world["jcfg"], world["jp"], jc,
                                 jnp.asarray(toks[:, t:t + 1]))
    with torch.no_grad():
        got, tc = decode.prefill_via_decode(
            world["cfg"], world["tp"],
            kvcache.make_cache(world["cfg"], B, SLOTS, dtype=torch.float32,
                               device="cpu"), _t(toks))
    _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    fj, ft = _flat(jc), _flat(tc)
    assert ft.keys() == fj.keys()
    for name, a in fj.items():
        _close(ft[name], a)


def test_decode_matches_forward(world):
    """The reference's serving check on the port alone, at the drop-free
    capacity: the prompt decoded token by token against forward's last
    position, rel < 2e-2, argmax equal."""
    cfg = _drop_free(world["cfg"])
    toks = _t(world["nb"]["tokens"])
    with torch.no_grad():
        ref = tf.forward(cfg, world["tp"], {"tokens": toks})[:, -1]
        got, _ = decode.prefill_via_decode(
            cfg, world["tp"], kvcache.make_cache(
                cfg, B, SLOTS, dtype=torch.float32, device="cpu"), toks)
    rel = float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)
    assert rel < 2e-2, rel
    assert torch.equal(got.argmax(-1), ref.argmax(-1))

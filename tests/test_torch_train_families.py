"""Training the nine LM families beside rwkv6: the port against the JAX
package, on the CPU.

For each of llama3-405b, qwen2-72b, qwen2-vl-72b, gemma2-9b,
h2o-danube3-4b, hymba-1.5b, whisper-small, deepseek-moe-16b and
deepseek-v2-236b at ``reduced(...)``, the reference's
``init_params(PRNGKey(0), float32)`` (or its ``init_train_state``) is
carried across with ``bridge``; batches are ``launch/train.py``'s
``synthetic_batch`` (numpy, seeded), the same in both packages. No
hypothesis: every case is one fixed draw.

Tolerances, each from the arithmetic it compares:
* ``loss_fn`` and its gradients (``train_loop._loss_and_grads``, every
  stack's per-layer leaves): the loss within rtol 1e-4, each gradient
  leaf within 1e-4 of that leaf's largest magnitude (both float32; XLA
  and ATen order their matmul sums differently), as
  ``tests/test_torch_train.py`` holds rwkv6. One leaf is zero in exact
  arithmetic and rounding noise in both packages: whisper's encoder key
  bias (its attention runs at position 0, so ``q · bk`` shifts every
  score of a row alike and the softmax cancels it). It is held to that
  zero: below 1e-8 of the tree's largest gradient, in both.
* a driver step (``make_train_step``) from a bridged state against the
  reference's ``train_step``: loss, grad norm and lr within rtol 1e-4;
  m and v, which are the gradients scaled (and squared), within 1e-4
  (2e-4 for v) of each leaf's largest magnitude. The new params are not
  held here: AdamW's first step moves a param by about lr · sign(g), so
  a gradient at rounding level moves it by up to 2 · lr on a difference
  of float order.
* the AdamW update itself on each family's tree (``apply_updates`` on
  the same gradients, state and params, the clip off): the bounds of
  ``tests/test_torch_train.py``, m and v within 1 ulp, params within 1
  ulp plus 4 ulp of the update, the grad norm within 1 ulp (ATen's CPU
  ``sqrt`` is not correctly rounded). Updated in slices, a leaf gives
  the bits of one whole-leaf update.
* accumulation against the full batch: the reference's own test's
  bounds (loss rtol 1e-5; params rtol 1e-3, atol 1e-5).
* synthetic batches and checkpoints: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402

from helpers.torch_lm import perturbed  # noqa: E402
from helpers.torch_train import (  # noqa: E402
    adamw_configs, flat_ref, np_bits, opt_inputs, within_ulp)
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import moe as moelib  # noqa: E402
from repro_torch.training import checkpoint, tree  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

TOL = 1e-4
B, S = 2, 8
ARCHS = ("llama3_405b", "qwen2_72b", "qwen2_vl_72b", "gemma2_9b",
         "h2o_danube3_4b", "hymba_1_5b", "whisper_small",
         "deepseek_moe_16b", "deepseek_v2_236b")
# launch/train.py's optimizer at its default --lr and --steps
ADAMW = dict(lr=3e-4, warmup_steps=10, decay_steps=100)
# gradient leaves that are zero in exact arithmetic (see the docstring)
ZERO_IN_EXACT = {"whisper_small": ("enc_layers/attn/bk",)}


def _clone(t):
    return tree.rebuild(t, lambda _, x: x.clone())


def _cfgs(arch):
    return (jconfigs.reduced(jconfigs.get_config(arch)),
            configs.reduced(configs.get_config(arch)))


def _batches(jcfg, cfg, b=B, s=S, step=0):
    return (jtrain.synthetic_batch(jcfg, b, s, step),
            launch_train.synthetic_batch(cfg, b, s, step))


class _Worlds:
    """Each arch's configs, the reference's init (moved by seeded noise,
    so the repeated layer's copies differ) carried across, and the
    reference's loss and gradients on step 0's synthetic batch; built
    once an arch."""

    def __init__(self):
        self._by_arch = {}

    def __call__(self, arch):
        if arch not in self._by_arch:
            jcfg, cfg = _cfgs(arch)
            jp = jtf.init_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
            jp = jax.tree.map(jnp.asarray,
                              perturbed(jp, np.random.default_rng(5)))
            jb, tb = _batches(jcfg, cfg)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jtf.loss_fn(jcfg, p, b)))(jp, jb)
            self._by_arch[arch] = dict(
                jcfg=jcfg, cfg=cfg, jp=jp,
                tp=bridge.lm_params_from_reference(jp, "cpu"), batch=tb,
                loss=float(loss), grads=flat_ref(grads))
        return self._by_arch[arch]


@pytest.fixture(scope="module")
def worlds():
    return _Worlds()


def _moe_drops(monkeypatch):
    """Each ``moe_ffn`` call's dropped fraction, recorded."""
    seen, inner = [], moelib.moe_ffn

    def record(*a, **kw):
        out, stats = inner(*a, **kw)
        seen.append(float(stats.dropped_frac))
        return out, stats
    monkeypatch.setattr(moelib, "moe_ffn", record)
    return seen


# ---------------------------------------------------------------------------
# loss_fn and its gradients over every stack, under each remat policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,policy", [(a, p) for a in ARCHS
                                         for p in (None, "dots")]
                         + [("deepseek_moe_16b", "full")])
def test_loss_and_grads_match_reference(worlds, monkeypatch, arch, policy):
    """Every gradient leaf, the stacks' per-layer leaves stacked back:
    gemma2's local/global pairs, moe's ``dense_layers``, whisper's
    ``enc_layers`` and cross-attention, the tied embeddings (lookup and
    head summed), hymba's Mamba loop, the MoE dispatch with pairs dropped
    (the spare row's and a dropped gate's gradients reach nothing)."""
    w = worlds(arch)
    drops = _moe_drops(monkeypatch)
    loss, grads = train_loop._loss_and_grads(w["cfg"], w["tp"], w["batch"],
                                             policy)
    np.testing.assert_allclose(float(loss), w["loss"], rtol=TOL)
    got = dict(tree.leaves(grads))
    assert got.keys() == w["grads"].keys()
    top = max(float(np.abs(np.asarray(g)).max())
              for g in w["grads"].values())
    for k, want in w["grads"].items():
        want, g = np.asarray(want), got[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == want.shape, k
        assert g.is_contiguous(), k
        if k in ZERO_IN_EXACT.get(arch, ()):
            assert np.abs(want).max() <= 1e-8 * top, k
            assert float(g.abs().max()) <= 1e-8 * top, k
            continue
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=k)
    if w["cfg"].family == "moe":        # the batch drops pairs
        assert drops and max(drops) > 0, drops


def test_unreached_params_get_zero_gradients(worlds):
    """Leaves the loss never reads get exact zeros, as ``jax.grad``
    gives: qwen2-vl's ``embed`` beside ``embeds`` (read for its dtype),
    whisper's cross-attention biases, and the rows of whisper's
    ``dec_pos`` past the sequence."""
    for arch, keys in (("qwen2_vl_72b", ("embed",)),
                       ("whisper_small", ("layers/xattn/bq",
                                          "layers/xattn/bk",
                                          "layers/xattn/bv"))):
        w = worlds(arch)
        _, grads = train_loop._loss_and_grads(w["cfg"], w["tp"],
                                              w["batch"], "dots")
        got = dict(tree.leaves(grads))
        for k in keys:
            assert not got[k].any() and not np.asarray(w["grads"][k]).any()
    dec_pos = got["dec_pos"]
    assert not dec_pos[S:].any() and dec_pos[:S].abs().min() > 0


@pytest.mark.parametrize("cap", [dict(deterministic_capacity=1), dict(),
                                 dict(capacity_factor=8.0)],
                         ids=["capacity_1", "capacity_1.25", "drop_free"])
def test_moe_ffn_gradients_match_reference(cap):
    """``moe_ffn`` under autograd against ``jax.grad`` of the reference's
    on a [2, 24] input: the input's, the router's and the experts'
    gradients, with no pair, some or most dropped (a dropped pair's row
    goes to the spare slot and its gate gets no gradient, as the
    reference's scatter-add of a zero row gives)."""
    jcfg, cfg = _cfgs("deepseek_moe_16b")
    rng = np.random.default_rng(3)
    d, E, de = cfg.d_model, cfg.n_experts, cfg.d_expert
    p = {"router": rng.normal(0, 0.5, (d, E)),
         "wi": rng.normal(0, 0.1, (E, d, de)),
         "wg": rng.normal(0, 0.1, (E, d, de)),
         "wo": rng.normal(0, 0.1, (E, de, d)),
         "sh_wi": rng.normal(0, 0.1, (d, 2 * de)),
         "sh_wg": rng.normal(0, 0.1, (d, 2 * de)),
         "sh_wo": rng.normal(0, 0.1, (2 * de, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 24, d)).astype(np.float32)
    ct = rng.normal(size=(2, 24, d)).astype(np.float32)

    def jloss(p, x):
        y, _ = jmoe.moe_ffn(jcfg, p, x, **cap)
        return jnp.sum(y * ct)
    want = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, stats = moelib.moe_ffn(cfg, tp, tx, **cap)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)),
                              [tp[k] for k in sorted(tp)] + [tx])
    dropped = float(stats.dropped_frac)
    assert (dropped > 0.5) if cap.get("deterministic_capacity") else \
        (dropped == 0) if cap else (0 < dropped < 0.5), dropped
    for name, g, w in zip(sorted(tp) + ["x"], got,
                          [want[0][k] for k in sorted(tp)] + [want[1]]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the optimizer on each family's tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_updates_matches_reference(worlds, arch):
    """AdamW over the family's nested tree (gemma2's pairs, the moe
    stacks, whisper's encoder): params, m and v within the ulp bounds of
    the reference's, in place; the grad norm within 1 ulp (the one
    correctly rounded sqrt of the same exact sum, but for ATen's CPU
    sqrt). The clip is off: a clip scale 1 ulp apart moves an m that
    cancels to near 0 by many of its ulp (``tests/test_torch_train.py``
    holds the clip on rwkv6's tree, whose norm rounds alike)."""
    w = worlds(arch)
    ocfg, jocfg = adamw_configs(clip_norm=0.0, **ADAMW)
    (jg, js), (tg, ts) = opt_inputs(w["jp"], 21)
    wp, ws, wm = jopt.apply_updates(jocfg, w["jp"], jg, js)
    tp = _clone(w["tp"])
    gp, gs, gm = opt.apply_updates(ocfg, tp, tg, ts)
    assert gp is tp and not list(tree.leaves(tg))
    within_ulp(gm["grad_norm"], np.asarray(wm["grad_norm"]), "grad_norm")
    assert np_bits(gm["lr"]).tobytes() == np_bits(wm["lr"]).tobytes()
    before = flat_ref(w["jp"])
    for name, got, want in (("params", gp, wp), ("m", gs.m, ws.m),
                            ("v", gs.v, ws.v)):
        want = flat_ref(want)
        assert {k for k, _ in tree.leaves(got)} == want.keys()
        for k, x in tree.leaves(got):
            wk = np.asarray(want[k])
            slack = 0.0
            if name == "params":      # 4 ulp of the update lr · u
                upd = np.abs(np.asarray(before[k], np.float64) - wk)
                slack = 4 * np.spacing(upd.astype(np.float32))
            within_ulp(x, wk, f"{name}/{k}", slack)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_bit_equal_in_slices(monkeypatch, state_dtype):
    """A leaf updated in slices of 1,000 elements (10,000 elements: ten
    slices) gives the bits of one whole-leaf update: params, m, v and
    the grad norm (exact-sum gradients), with the clip on."""
    sdt = getattr(torch, state_dtype)
    rng = np.random.default_rng(8)

    def state():
        p = {"w": torch.from_numpy(rng.normal(0, 0.1, (100, 100)).astype(
                 np.float32)),
             "stack": {"b": torch.from_numpy(rng.normal(size=(3, 7)).astype(
                 np.float32))}}
        g = tree.rebuild(p, lambda _, x: torch.from_numpy(
            (rng.integers(-6, 7, tuple(x.shape)) * 2.0 ** -9).astype(
                np.float32)))
        m = tree.rebuild(p, lambda _, x: torch.from_numpy(
            rng.normal(0, 0.01, tuple(x.shape)).astype(np.float32)).to(sdt))
        v = tree.rebuild(p, lambda _, x: torch.from_numpy(
            rng.uniform(0, 1e-3, tuple(x.shape)).astype(np.float32)).to(sdt))
        return p, g, opt.OptState(step=torch.tensor(3, dtype=torch.int32),
                                  m=m, v=v)
    p, g, s = state()
    ocfg = opt.AdamWConfig(clip_norm=0.5, state_dtype=sdt, **ADAMW)
    monkeypatch.setattr(opt, "SLICE", 1 << 40)
    whole = opt.apply_updates(ocfg, _clone(p), _clone(g),
                              s._replace(m=_clone(s.m), v=_clone(s.v)))
    monkeypatch.setattr(opt, "SLICE", 1000)
    assert len(opt._slices(p["w"])) == 10
    sliced = opt.apply_updates(ocfg, p, g, s)
    assert float(whole[2]["grad_norm"]) > 0.5
    for a, b in zip(*(tree.leaves(dict(zip("psm", r))) for r in (whole,
                                                                sliced))):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert np_bits(a[1]).tobytes() == np_bits(b[1]).tobytes(), a[0]


# ---------------------------------------------------------------------------
# the driver's step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_from_bridged_state(arch):
    """One driver step (AdamW at ``launch/train.py``'s defaults, remat
    "dots") from the reference's ``init_train_state`` carried across,
    against the reference's ``train_step`` on the same batch."""
    jcfg, cfg = _cfgs(arch)
    ocfg, jocfg = adamw_configs(**ADAMW)
    js = jloop.init_train_state(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32, opt_cfg=jocfg)
    ts = bridge.train_state_from_reference(js, "cpu")
    jb, tb = _batches(jcfg, cfg)
    js, wm = jax.jit(jloop.make_train_step(jcfg, opt_cfg=jocfg))(js, jb)
    ts, gm = train_loop.make_train_step(cfg, opt_cfg=ocfg)(ts, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=TOL, err_msg=key)
    assert int(ts.opt.step) == 1
    for name, tol in (("m", TOL), ("v", 2 * TOL)):
        want = flat_ref(getattr(js.opt, name))
        for k, x in tree.leaves(getattr(ts.opt, name)):
            wk = np.asarray(want[k])
            if k in ZERO_IN_EXACT.get(arch, ()):
                continue
            np.testing.assert_allclose(x.numpy(), wk, rtol=0,
                                       atol=tol * float(np.abs(wk).max()),
                                       err_msg=f"{name}/{k}")


def test_unused_embed_moves_by_weight_decay_alone():
    """qwen2-vl trains on ``embeds``: its ``embed`` gets a zero gradient,
    so m and v stay 0 and the step scales it by weight decay alone,
    within 1 ulp of the reference's step."""
    jcfg, cfg = _cfgs("qwen2_vl_72b")
    ocfg, jocfg = adamw_configs(**ADAMW)
    js = jloop.init_train_state(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32, opt_cfg=jocfg)
    ts = bridge.train_state_from_reference(js, "cpu")
    before = ts.params["embed"].clone()
    jb, tb = _batches(jcfg, cfg)
    assert "tokens" not in tb and tb["embeds"].dtype == torch.bfloat16
    js, _ = jax.jit(jloop.make_train_step(jcfg, opt_cfg=jocfg))(js, jb)
    ts, gm = train_loop.make_train_step(cfg, opt_cfg=ocfg)(ts, tb)
    assert not ts.opt.m["embed"].any() and not ts.opt.v["embed"].any()
    after = ts.params["embed"]
    assert not torch.equal(after, before)
    within_ulp(after, np.asarray(js.params["embed"]), "embed")
    decay = 1 - float(gm["lr"]) * ocfg.weight_decay
    np.testing.assert_allclose(after.numpy(), before.numpy() * decay,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "deepseek_moe_16b"])
def test_grad_accumulation_matches_full_batch(arch):
    """``accum_steps`` 2 against 1 on the same batch of 8, as the
    reference's own test (``tests/test_training.py``); the moe config at
    its drop-free capacity (``capacity_factor = n_experts``), where a
    microbatch routes as the full batch does."""
    cfg = configs.reduced(configs.get_config(arch))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, clip_norm=0.0,
                           weight_decay=0.0)
    s0 = train_loop.init_train_state(cfg, torch.Generator().manual_seed(1),
                                     dtype=torch.float32, opt_cfg=ocfg,
                                     device="cpu")
    batch = launch_train.synthetic_batch(cfg, 8, S, 4)
    s_full, m_full = train_loop.make_train_step(cfg, opt_cfg=ocfg)(
        _clone(s0), batch)
    s_acc, m_acc = train_loop.make_train_step(cfg, opt_cfg=ocfg,
                                              accum_steps=2)(s0, batch)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_acc["loss"]),
                               rtol=1e-5)
    for (k, a), (_, b) in zip(tree.leaves(s_full.params),
                              tree.leaves(s_acc.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "deepseek_moe_16b"])
def test_grad_accumulation_matches_reference(arch):
    """``accum_steps`` 2 at the published capacity (each microbatch
    routes its own tokens, so the moe step is not the full batch's)
    against the reference's accumulating step: loss, grad norm, lr."""
    jcfg, cfg = _cfgs(arch)
    ocfg, jocfg = adamw_configs(**ADAMW)
    js = jloop.init_train_state(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32, opt_cfg=jocfg)
    ts = bridge.train_state_from_reference(js, "cpu")
    jb, tb = _batches(jcfg, cfg, b=4)
    _, wm = jax.jit(jloop.make_train_step(jcfg, opt_cfg=jocfg,
                                          accum_steps=2))(js, jb)
    _, gm = train_loop.make_train_step(cfg, opt_cfg=ocfg,
                                       accum_steps=2)(ts, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=TOL, err_msg=key)


# ---------------------------------------------------------------------------
# checkpoints of the nested trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,stack", [
    ("gemma2_9b", "params/layers/local/attn/wq"),
    ("whisper_small", "params/enc_layers/mlp/wi"),
    ("deepseek_moe_16b", "params/dense_layers/mlp/wg")])
def test_checkpoint_roundtrip_nested(arch, stack, tmp_path):
    """A trained state saves and restores bit for bit (float32 params,
    bf16 m and v), its keys the reference's paths; a checkpoint the
    reference writes restores into the port's template and one the port
    writes into the reference's."""
    jcfg, cfg = _cfgs(arch)
    ocfg = opt.AdamWConfig(state_dtype=torch.bfloat16, **ADAMW)
    state = train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(2), dtype=torch.float32,
        opt_cfg=ocfg, device="cpu")
    state, _ = train_loop.make_train_step(cfg, opt_cfg=ocfg)(
        state, launch_train.synthetic_batch(cfg, B, S, 0))
    d = str(tmp_path / "port")
    checkpoint.save(d, 1, state)
    template = train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        opt_cfg=ocfg, device="cpu")
    restored, manifest = checkpoint.restore(d, template)
    assert f"opt/m/{stack[len('params/'):]}" in manifest["bf16"]
    got, want = list(tree.leaves(restored)), list(tree.leaves(state))
    assert [k for k, _ in got] == [k for k, _ in want] and stack in dict(got)
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), k

    js = jloop.init_train_state(jcfg, jax.random.PRNGKey(7),
                                dtype=jnp.float32)
    assert set(flat_ref(js)) == {k for k, _ in want}
    jckpt.save(str(tmp_path / "ref"), 5, js)
    f32 = train_loop.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      dtype=torch.float32, device="cpu")
    restored, _ = checkpoint.restore(str(tmp_path / "ref"), f32)
    carried = bridge.train_state_from_reference(js, "cpu")
    for (k, a), (_, b) in zip(tree.leaves(restored), tree.leaves(carried)):
        assert torch.equal(a, b), k
    checkpoint.save(str(tmp_path / "back"), 6, restored)
    back, _ = jckpt.restore(str(tmp_path / "back"), jloop.init_train_state(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_matches_reference(arch):
    """Tokens, labels, whisper's ``frames`` and qwen2-vl's ``embeds``
    (bf16, ``tokens`` dropped) bit for bit, at two steps."""
    jcfg, cfg = _cfgs(arch)
    for step in (0, 3):
        want, got = _batches(jcfg, cfg, b=3, s=16, step=step)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert np_bits(got[k]).tobytes() == np_bits(w).astype(
                np_bits(got[k]).dtype).tobytes(), k
            assert tuple(got[k].shape) == w.shape
    assert ("frames" in got) == (cfg.family == "encdec")
    assert ("embeds" in got) == (cfg.frontend == "vision")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_launch_train_main_runs(arch, capsys):
    """``setup`` builds every config's state and ``main`` takes two
    steps on the CPU, printing finite losses."""
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out[:-1]] == [["step", "0"],
                                                   ["step", "1"]]
    assert all(np.isfinite(float(ln.split()[3])) for ln in out[:-1])
    assert out[-1] == "# done"

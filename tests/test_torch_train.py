"""The port's training path against the JAX package, on the CPU.

At ``reduced(rwkv6_3b)`` (2 layers, d 64, 4 heads of dk 16, d_ff 128,
vocab 512) the reference's ``init_params(PRNGKey(0), float32)`` is
carried across with ``bridge.lm_params_from_reference``; tokens, labels,
masks, gradients and optimizer states are drawn with numpy from fixed
seeds and handed to both packages. No hypothesis: every case is one
fixed draw.

Tolerances, each from the arithmetic it compares:
* ``loss_fn`` and its gradients: the loss within rtol 1e-4, each
  gradient leaf within 1e-4 of that leaf's largest magnitude. Both sides
  are float32, but the reference's forward runs its chunked scan
  (interpret mode) where the port's CPU path runs the sequential one,
  and XLA and ATen order their matmul sums differently: the rwkv
  forward's own tolerance (``tests/test_torch_rwkv.py``).
* ``apply_updates``: the same float32 expressions op for op, so m and
  v within 1 ulp (a bf16 state within 1 bf16 ulp). The new params too,
  but for one op: ATen's CPU ``sqrt`` is not correctly rounded (on
  100,000 uniform floats 633 results are 1 ulp off, where XLA's and the
  card's are exact), and that ulp of ``sqrt(v / bc2)`` reaches the
  update ``lr · u`` as up to 3 ulp of it, which ``p - lr · u`` can
  cancel into many ulp of a small result. So params are held to 1 ulp
  of the new value plus 4 ulp of the update.
* ``schedule``: ``cos`` differs by up to 1 ulp between the libraries,
  and ``1 + cos`` can cancel it into a few ulp of the rate; held to two
  ulp of the peak rate (2^-22 · lr).
* one train step from a bridged state: loss and grad norm within rtol
  1e-4 (the gradients' tolerance above).
* the port's own accumulation against the full batch: as the
  reference's ``tests/test_training.py`` (loss rtol 1e-5; params rtol
  1e-3, atol 1e-5).
* compression: codes bit-equal to the reference's on the reference's
  own uniforms; the bias over 4,096 draws within 5 standard errors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jloop  # noqa: E402

from helpers.torch_train import (  # noqa: E402
    adamw_configs as _tiny_ocfg, flat_ref as _flat_ref, np_bits as _np,
    opt_inputs, within_ulp as _within_ulp)
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import checkpoint, compression  # noqa: E402
from repro_torch.training import fault_tolerance, tree  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

TOL = 1e-4
B, S = 2, 8


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _batch(cfg, seed, b=B, s=S, mask=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if mask:
        out["loss_mask"] = (rng.uniform(size=(b, s)) < 0.7).astype(
            np.float32)
    return out


def _clone(t):
    """A copy of every tensor of a tree (a step updates its own)."""
    return tree.rebuild(t, lambda _, x: x.clone())


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def world():
    jcfg = jconfigs.reduced(jconfigs.get_config("rwkv6_3b"))
    cfg = configs.reduced(configs.get_config("rwkv6_3b"))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                tp=bridge.lm_params_from_reference(jp, "cpu"))


# ---------------------------------------------------------------------------
# loss_fn and its gradients, under each remat policy
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_grads(world):
    """The reference's loss and gradients on a masked batch (its remat
    policy does not change its values; "dots" is its default)."""
    batch = _batch(world["cfg"], 11, mask=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(world["jcfg"], p, _jb(batch))))(world["jp"])
    return batch, float(loss), _flat_ref(grads)


@pytest.mark.parametrize("policy", [None, "none", "full", "dots"])
def test_loss_and_grads_match_reference(world, ref_grads, policy):
    batch, want_loss, want = ref_grads
    loss, grads = train_loop._loss_and_grads(world["cfg"], world["tp"],
                                             _tb(batch), policy)
    np.testing.assert_allclose(float(loss), want_loss, rtol=TOL)
    got = dict(tree.leaves(grads))
    assert got.keys() == want.keys()
    for k, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(got[k].numpy(), g, rtol=0,
                                   atol=TOL * float(np.abs(g).max()),
                                   err_msg=k)


def test_loss_without_mask_and_eval_step(world):
    """No ``loss_mask``: the mean over every position; the eval step is
    the same loss without autograd."""
    batch = _batch(world["cfg"], 12)
    want = float(jtf.loss_fn(world["jcfg"], world["jp"], _jb(batch),
                             remat_policy=None))
    got = train_loop.make_eval_step(world["cfg"])(world["tp"], _tb(batch))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=TOL)


def test_remat_policy_names(world):
    batch = _tb(_batch(world["cfg"], 13))
    with pytest.raises(ValueError, match="remat_policy"):
        tf.loss_fn(world["cfg"], world["tp"], batch, remat_policy="dotz")


@pytest.mark.parametrize("policy,forwards", [(None, 1), ("full", 2),
                                             ("dots", 2)])
def test_wkv6_function_under_remat(world, monkeypatch, policy, forwards):
    """The card's route on CPU tensors: ``ops.wkv6`` is sent through the
    ``_WKV6`` Function with the kernel replaced by the plain scan (no
    card here). The loss and gradients equal the plain path's bit for
    bit, and each layer's forward runs once, plus once more in remat's
    recompute: the card launches 2 x n_layers kernels a step."""
    cfg, tp = world["cfg"], world["tp"]
    batch = _tb(_batch(cfg, 14, mask=True))
    want_loss, want = train_loop._loss_and_grads(cfg, tp, batch, policy)
    calls = []

    def prep(r, k, v, w, u, chunk):
        y = torch.empty(v.shape, dtype=torch.float32)

        def launch():
            calls.append(tuple(r.shape))
            assert not torch.is_grad_enabled()
            y.copy_(ops.ref.wkv6(r, k, v, w, u))
        return launch, y

    monkeypatch.setattr(ops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(ops, "_prep_wkv6", prep)
    loss, grads = train_loop._loss_and_grads(cfg, tp, batch, policy)
    assert len(calls) == forwards * cfg.n_layers
    assert torch.equal(loss, want_loss)
    for (k, g), (_, w) in zip(tree.leaves(grads), tree.leaves(want)):
        assert torch.equal(g, w), k


def test_wkv6_cpu_gradients_match_reference():
    """``ops.wkv6`` on CPU tensors (the plain scan under autograd):
    its vector-Jacobian product against ``jax.vjp`` of the reference's
    ``ref.wkv6`` on the same inputs and cotangent, within 1e-4 of each
    gradient's largest magnitude; bf16 inputs get bf16 gradients."""
    rng = np.random.default_rng(5)
    BH, T, dk, dv = 3, 21, 8, 16
    args = [rng.normal(size=(BH, T, dk)), rng.normal(size=(BH, T, dk)),
            rng.normal(size=(BH, T, dv)), rng.uniform(0.05, 0.999,
                                                      (BH, T, dk)),
            rng.normal(size=(BH, dk))]
    args = [a.astype(np.float32) for a in args]
    ct = rng.normal(size=(BH, T, dv)).astype(np.float32)
    y, vjp = jax.vjp(jref.wkv6, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(ct))
    xs = [_t(a).requires_grad_(True) for a in args]
    got_y = ops.wkv6(*xs)
    got = torch.autograd.grad(got_y, xs, _t(ct))
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(y),
                               rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()))
    xb = [_t(a).to(torch.bfloat16).requires_grad_(True) for a in args]
    gb = torch.autograd.grad(ops.wkv6(*xb), xb, _t(ct))
    assert all(g.dtype == torch.bfloat16 for g in gb)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_apply_updates_matches_reference(world, state_dtype, clip):
    """New params, m and v within 1 ulp of the reference's (params: plus
    4 ulp of the update), with the clip off and on (gnorm > 0.5); the
    grad norm and lr equal. The update is in place: params, m and v come
    back as the given tensors, and the grads tree is emptied."""
    ocfg, jocfg = _tiny_ocfg(clip_norm=clip, warmup_steps=2,
                             decay_steps=50,
                             state_dtype=getattr(torch, state_dtype))
    jp, tp = world["jp"], world["tp"]
    (jg, js), (tg, ts) = opt_inputs(jp, 21, getattr(jnp, state_dtype))
    wp, ws, wm = jopt.apply_updates(jocfg, jp, jg, js)
    tp = _clone(tp)
    gp, gs, gm = opt.apply_updates(ocfg, tp, tg, ts)
    assert tg == {"layers": {}}
    assert gp["embed"] is tp["embed"] and gs.m["embed"] is ts.m["embed"]
    assert float(wm["grad_norm"]) > 0.5
    assert _np(gm["grad_norm"]).tobytes() == _np(wm["grad_norm"]).tobytes()
    assert _np(gm["lr"]).tobytes() == _np(wm["lr"]).tobytes()
    assert int(gs.step) == int(ws.step) == 4 and gs.step.dtype == torch.int32
    before = _flat_ref(jp)
    for name, got, want in (("params", gp, wp), ("m", gs.m, ws.m),
                            ("v", gs.v, ws.v)):
        want = _flat_ref(want)
        for k, x in tree.leaves(got):
            assert str(x.dtype).split(".")[-1] == want[k].dtype.name
            w = np.asarray(want[k])
            slack = 0.0
            if name == "params":      # 4 ulp of the update lr · u
                upd = np.abs(np.asarray(before[k], np.float64) - w)
                slack = 4 * np.spacing(upd.astype(np.float32))
            _within_ulp(x, w, f"{name}/{k}", slack)


def test_schedule_matches_reference():
    """Warmup then cosine decay, steps 0 to 2 x decay_steps, within two
    ulp of the peak rate."""
    ocfg, jocfg = _tiny_ocfg(lr=3e-4, warmup_steps=10, decay_steps=100)
    for s in range(0, 201):
        got = opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32))
        want = jopt.schedule(jocfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        _within_ulp(got, want, f"step {s}", 2.0 ** -22 * ocfg.lr)


def test_opt_state_layout_and_bytes(world):
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ocfg, jocfg = _tiny_ocfg(state_dtype=dt)
        got = opt.init_opt_state(ocfg, world["tp"])
        want = jopt.init_opt_state(jocfg, world["jp"])
        assert opt.opt_state_bytes(got) == jopt.opt_state_bytes(want)
        flat = _flat_ref(want)
        assert {k for k, _ in tree.leaves(got)} == flat.keys()
        for k, x in tree.leaves(got):
            assert str(x.dtype).split(".")[-1] == flat[k].dtype.name, k
            assert tuple(x.shape) == flat[k].shape and not x.any()
    np.testing.assert_allclose(
        float(opt.global_norm(world["tp"])),
        float(jopt.global_norm(world["jp"])), rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def test_train_step_from_bridged_state(world):
    """One step of each package from the reference's ``init_train_state``
    carried across: the loss, the grad norm and the lr agree."""
    ocfg, jocfg = _tiny_ocfg(lr=1e-3, warmup_steps=0)
    js = jloop.init_train_state(world["jcfg"], jax.random.PRNGKey(3),
                                dtype=jnp.float32, opt_cfg=jocfg)
    ts = bridge.train_state_from_reference(js, "cpu")
    flat = _flat_ref(js)
    assert {k for k, _ in tree.leaves(ts)} == flat.keys()
    for k, x in tree.leaves(ts):
        assert np.array_equal(_np(x), _np(flat[k])), k
        assert str(x.dtype).split(".")[-1] == flat[k].dtype.name, k
    batch = _batch(world["cfg"], 31)
    _, wm = jax.jit(jloop.make_train_step(world["jcfg"], opt_cfg=jocfg))(
        js, _jb(batch))
    ts, gm = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)(
        ts, _tb(batch))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                   rtol=TOL, err_msg=key)
    assert int(ts.opt.step) == 1


def _port_state(world, seed=1, **kw):
    ocfg = opt.AdamWConfig(**kw)
    return ocfg, train_loop.init_train_state(
        world["cfg"], torch.Generator().manual_seed(seed),
        dtype=torch.float32, opt_cfg=ocfg, device="cpu")


def test_grad_accumulation_matches_full_batch(world):
    """``accum_steps`` 4 against 1 on the same batch of 8, as the
    reference's own test."""
    ocfg, s0 = _port_state(world, lr=1e-3, warmup_steps=0, clip_norm=0.0,
                           weight_decay=0.0)
    batch = _tb(_batch(world["cfg"], 41, b=8))
    full = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)
    acc = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg,
                                     accum_steps=4)
    s_full, m_full = full(_clone(s0), batch)
    s_acc, m_acc = acc(_clone(s0), batch)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_acc["loss"]),
                               rtol=1e-5)
    for (k, a), (_, b) in zip(tree.leaves(s_full.params),
                              tree.leaves(s_acc.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_loss_decreases_over_steps(world):
    """30 steps on one batch: the loss falls below 0.7x its start."""
    ocfg, state = _port_state(world, seed=0, lr=1e-2, warmup_steps=0,
                              decay_steps=1000, weight_decay=0.0)
    step = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)
    batch = _tb(_batch(world["cfg"], 0, b=4))
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]


def test_bf16_params_and_state_run(world):
    """bf16 params with a bf16 AdamW state: finite, ``u`` stays float32
    while its m and v follow ``state_dtype``."""
    ocfg = opt.AdamWConfig(lr=1e-3, state_dtype=torch.bfloat16)
    state = train_loop.init_train_state(
        world["cfg"], torch.Generator().manual_seed(0),
        dtype=torch.bfloat16, opt_cfg=ocfg, device="cpu")
    state, m = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)(
        state, _tb(_batch(world["cfg"], 1)))
    assert np.isfinite(float(m["loss"]))
    assert state.params["layers"]["u"].dtype == torch.float32
    assert state.params["layers"]["wr"].dtype == torch.bfloat16
    assert state.opt.m["layers"]["u"].dtype == torch.bfloat16
    assert state.opt.v["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("make", [
    lambda cfg: train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(0)),
    lambda cfg: launch_train.main(["--arch", "rwkv6-3b", "--reduced",
                                   "--steps", "1"]),
], ids=["init_train_state", "launch.train"])
def test_training_defaults_to_the_card(world, make):
    """Without ``device`` the entry points run on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only behaviour is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(world["cfg"])


def test_bridge_defaults_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only behaviour is moot")
    js = jloop.init_train_state(world["jcfg"], jax.random.PRNGKey(0),
                                dtype=jnp.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.train_state_from_reference(js)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _assert_states_equal(a, b):
    la, lb = list(tree.leaves(a)), list(tree.leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_checkpoint_roundtrip_and_resume(world, tmp_path):
    """Save after 2 steps, restore into a template of another seed, and
    2 more steps from the restored state equal 2 more from the live
    one, bit for bit."""
    ocfg, state = _port_state(world, seed=2, lr=1e-3, warmup_steps=0)
    step = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)
    batches = [_tb(_batch(world["cfg"], 50 + i)) for i in range(4)]
    for b in batches[:2]:
        state, _ = step(state, b)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 7, state, extra={"data_position": 123})
    _, template = _port_state(world, seed=99)
    restored, manifest = checkpoint.restore(d, template)
    assert manifest["step"] == 7
    assert manifest["extra"]["data_position"] == 123
    _assert_states_equal(restored, state)
    assert int(restored.opt.step) == 2
    for b in batches[2:]:
        state, _ = step(state, b)
        restored, _ = step(restored, b)
    _assert_states_equal(restored, state)
    assert not [f for f in tmp_path.joinpath("ckpt").iterdir()
                if f.name.endswith(".tmp")]


def test_checkpoint_prune_and_latest(world, tmp_path):
    _, state = _port_state(world)
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, state, keep=2)
    assert checkpoint.latest_step(d) == 5
    kept = sorted(f.name for f in tmp_path.joinpath("ckpt").iterdir())
    assert kept == ["step_0000000004.manifest.json", "step_0000000004.npz",
                    "step_0000000005.manifest.json", "step_0000000005.npz"]
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), state)


def test_checkpoint_mismatches_rejected(world, tmp_path):
    """A shape that differs raises ``ValueError``, a leaf the checkpoint
    lacks ``KeyError``, as the reference's restore."""
    _, state = _port_state(world)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, state)
    cfg2 = dataclasses.replace(world["cfg"], d_ff=96)
    template = train_loop.init_train_state(
        cfg2, torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(d, template)
    extra = state._replace(params=dict(state.params,
                                       lm_bias=torch.zeros(3)))
    with pytest.raises(KeyError, match="params/lm_bias"):
        checkpoint.restore(d, extra)


def test_checkpoint_bf16_bit_for_bit(world, tmp_path):
    """bf16 leaves go through numpy as their bits and come back equal."""
    ocfg = opt.AdamWConfig(state_dtype=torch.bfloat16)
    state = train_loop.init_train_state(
        world["cfg"], torch.Generator().manual_seed(4),
        dtype=torch.bfloat16, opt_cfg=ocfg, device="cpu")
    state.opt.m["embed"].normal_(generator=torch.Generator().manual_seed(5))
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 3, state)
    template = train_loop.init_train_state(
        world["cfg"], torch.Generator().manual_seed(6),
        dtype=torch.bfloat16, opt_cfg=ocfg, device="cpu")
    restored, manifest = checkpoint.restore(d, template)
    assert "params/embed" in manifest["bf16"]
    assert "params/layers/u" not in manifest["bf16"]     # u is float32
    _assert_states_equal(restored, state)


def test_checkpoint_reference_format(world, tmp_path):
    """A float32 checkpoint written by the reference's ``save`` restores
    into the port's template with equal leaves, and one the port writes
    restores into the reference's."""
    js = jloop.init_train_state(world["jcfg"], jax.random.PRNGKey(7),
                                dtype=jnp.float32)
    d = str(tmp_path / "ref")
    jckpt.save(d, 5, js, extra={"step": 5})
    _, template = _port_state(world)
    restored, manifest = checkpoint.restore(d, template)
    assert manifest["extra"] == {"step": 5}
    _assert_states_equal(restored, bridge.train_state_from_reference(
        js, "cpu"))
    d2 = str(tmp_path / "port")
    checkpoint.save(d2, 6, restored)
    back, _ = jckpt.restore(d2, jloop.init_train_state(
        world["jcfg"], jax.random.PRNGKey(0), dtype=jnp.float32))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (136, 1.0), (7, 1e-6),
                                        (99, 1e3), (2024, 0.3)])
def test_compression_codes_match_reference(seed, scale):
    """On the reference's own draws (``jax.random.uniform`` of its key)
    the codes and the scale equal the reference's ``encode``; decoding
    errs by at most one quantum."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0, scale, (64,)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jq, js = jcomp.encode(jnp.asarray(g), key)
    u = np.asarray(jax.random.uniform(key, g.shape))
    q, s = compression.quantize(_t(g), _t(u))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    deq = compression.decode(q, s)
    assert float((deq - _t(g)).abs().max()) <= float(s) * 1.001


@pytest.mark.parametrize("seed,scale", [(136, 1.0), (3, 1e-3), (11, 50.0)])
def test_compression_unbiased(seed, scale):
    """The mean of 4,096 decodes (draws from a seeded generator) sits
    within 5 standard errors of g: each decode is one of two points a
    quantum apart, so its standard deviation is at most s/2 and the
    mean's at most s / (2 sqrt(4096)) = s/128."""
    n = 4096
    rng = np.random.default_rng(seed)
    g = _t(rng.normal(0, scale, (64,)).astype(np.float32))
    gen = torch.Generator().manual_seed(seed)
    q, s = compression.encode(g.expand(n, 64).contiguous(), gen)
    bias = float((compression.decode(q, s).mean(0) - g).abs().max())
    assert bias < 5 * float(s) / 128


def test_compression_tree():
    gen = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(5, 3, generator=gen),
             "b": {"c": torch.randn(7, generator=gen)}}
    qs, scales = compression.encode_tree(grads, gen)
    back = compression.decode_tree(qs, scales)
    assert qs["b"]["c"].dtype == torch.int8
    for k, x in tree.leaves(grads):
        y = dict(tree.leaves(back))[k]
        s = dict(tree.leaves(scales))[k]
        assert y.shape == x.shape
        assert float((y - x).abs().max()) <= float(s) * 1.001


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_monitor_fake_clock():
    t = [0.0]
    mon = fault_tolerance.StragglerMonitor(threshold=1.5,
                                           clock=lambda: t[0])
    for _ in range(10):
        t[0] += 1.0
        for h in ("h0", "h1", "h2", "h3"):
            mon.beat(h, 1.0 if h != "h3" else 2.5)
    assert mon.stragglers() == ["h3"]
    t[0] += 100.0
    mon.beat("h0", 1.0)
    assert set(mon.dead(timeout=50)) == {"h1", "h2", "h3"}


def test_preemption_flag_checkpoint_flow(world, tmp_path):
    ocfg, state = _port_state(world, seed=0)
    step = train_loop.make_train_step(world["cfg"], opt_cfg=ocfg)
    handler = fault_tolerance.PreemptionHandler()
    d = str(tmp_path / "ckpt")
    batch = _tb(_batch(world["cfg"], 0, b=4))
    for i in range(5):
        state, _ = step(state, batch)
        if i == 2:
            handler.request()        # simulated SIGTERM
        if handler.preempted():
            checkpoint.save(d, i, state,
                            extra=fault_tolerance.RunState(
                                step=i, data_position=i * 4).to_dict())
            break
    assert checkpoint.latest_step(d) == 2
    _, template = _port_state(world, seed=9)
    restored, manifest = checkpoint.restore(d, template)
    rs = fault_tolerance.RunState.from_dict(manifest["extra"])
    assert rs.step == 2 and rs.data_position == 8
    _assert_states_equal(restored, state)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_launch_train_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "8", "--ckpt-dir", d]
    launch_train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in out[:-1]] == [["step", "0"],
                                                   ["step", "2"]]
    assert all(" loss " in ln and " gnorm " in ln and "tok/s" in ln
               for ln in out[:-1])
    assert out[-1] == "# done"
    assert checkpoint.latest_step(d) == 2
    launch_train.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# resumed from step 2 (data_position 6)"
    assert out[1].split()[:2] == ["step", "4"] and out[-1] == "# done"
    assert checkpoint.latest_step(d) == 4


def test_launch_train_synthetic_batch_matches_reference(world):
    from repro.launch import train as jtrain
    for step in (0, 3):
        got = launch_train.synthetic_batch(world["cfg"], 4, 16, step)
        want = jtrain.synthetic_batch(world["jcfg"], 4, 16, step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("extra,error,match", [
    (["--mesh", "2x1"], NotImplementedError, "A11"),
])
def test_launch_train_refuses(extra, error, match):
    argv = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
            "--steps", "1"] + extra
    with pytest.raises(error, match=match):
        launch_train.main(argv)

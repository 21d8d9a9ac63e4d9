"""Training over a ``(data, model)`` mesh, on the CPU: the port's mesh
step, checkpoints that move between meshes, the agreed preemption and
the driver's ``--mesh``, against the port's one-device step and the JAX
package's.

The ranks are subprocesses (``tests/helpers/torch_mesh.py``'s training
cases): each joins a ``gloo`` group through a ``file://`` rendezvous
under the test's temporary directory, so this worker never initialises a
process group. Three spawns start together and run while the reference
steps: world 4 (2×2: a step case an arch, the shard/gather round trip, a
checkpoint written), world 2 (1×2 and 2×1 an arch, ``--accum 2`` at
2×1, the MoE block over ``data``, the agreed preemption) and the driver
under ``torch.distributed.run`` at 2×1. A fourth, at world 2, restores
world 4's checkpoint at 1×2 once it is written.

Configs: ``reduced(...)`` of rwkv6-3b (its ``wkv6`` scan), gemma2-9b
(GQA, tied embeddings, local/global pairs) and deepseek-moe-16b (a dense
layer, then MoE layers at the published capacity factor 1.25, where
pairs drop); the reference's ``init_train_state(PRNGKey(0), float32)``
carried across by ``bridge``; two steps of ``launch/train.py``'s
synthetic batches at batch 4 × seq 8 and its AdamW defaults.

Bounds, each from the arithmetic it compares:
* 1×2 against the port's one-device step: bit for bit (params, m, v,
  loss, grad norm). At one data index the step runs the same rows with
  the same whole params; each rank's AdamW on its blocks is elementwise.
* 2×1 and 2×2 against the reference's one-device step on the same global
  batch: loss and grad norm within 1e-5 relative; params, m and v within
  1e-4, 1e-4 and 2e-4 of each leaf's largest magnitude (PR 30's bounds
  for a driver step across packages; the data ranks add their halves'
  gradients in another order).
* MoE over ``data``: drops and loads equal the reference's exactly (they
  are counts), the output within 1e-5 of its largest magnitude.
* checkpoints and the shard/gather round trip: bit for bit.
"""
import os
import re
import signal
import subprocess
import sys

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
from repro.training import train_loop as jloop  # noqa: E402

from helpers.torch_mesh import ROOT, Ranks  # noqa: E402
from helpers.torch_train import adamw_configs, flat_ref, np_bits  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.training import checkpoint, tree  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402

ARCHS = ("rwkv6_3b", "gemma2_9b", "deepseek_moe_16b")
B, S, STEPS = 4, 8, 2
ADAMW = dict(lr=3e-4, warmup_steps=10, decay_steps=100)
REL = 1e-5
TOL = {"params": 1e-4, "m": 1e-4, "v": 2e-4}
ACCUM_ARCH = "deepseek_moe_16b"
# the MoE block's capacities: the published factor and one slot an expert
MOE_CAPS = (dict(capacity_factor=1.25), dict(deterministic_capacity=1))
DRIVER = ["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
          "--batch", "4", "--seq", "8", "--steps", "3"]
SPAWN_S = 150.0


def _cfgs(arch):
    return (jconfigs.reduced(jconfigs.get_config(arch)),
            configs.reduced(configs.get_config(arch)))


def _clone(t):
    return tree.rebuild(t, lambda _, x: x.clone())


class _World:
    """Each arch's reference init carried across, the batches, and the
    reference's steps (built on first use)."""

    def __init__(self):
        self.arch = {}
        for arch in ARCHS:
            jcfg, cfg = _cfgs(arch)
            ocfg, jocfg = adamw_configs(**ADAMW)
            js = jloop.init_train_state(jcfg, jax.random.PRNGKey(0),
                                        dtype=jnp.float32, opt_cfg=jocfg)
            self.arch[arch] = dict(
                jcfg=jcfg, cfg=cfg, ocfg=ocfg, jocfg=jocfg, js=js,
                ts=bridge.train_state_from_reference(js, "cpu"),
                jb=[jtrain.synthetic_batch(jcfg, B, S, s)
                    for s in range(STEPS + 1)],
                tb=[launch_train.synthetic_batch(cfg, B, S, s)
                    for s in range(STEPS + 1)])
        self._ref = {}

    def reference(self, arch, accum=1):
        """The reference's state and metrics after ``STEPS`` steps."""
        if (arch, accum) not in self._ref:
            w = self.arch[arch]
            step = jax.jit(jloop.make_train_step(
                w["jcfg"], opt_cfg=w["jocfg"], accum_steps=accum))
            js, ms = w["js"], []
            for b in w["jb"][:STEPS]:
                js, m = step(js, b)
                ms.append({k: float(v) for k, v in m.items()})
            self._ref[arch, accum] = (js, ms)
        return self._ref[arch, accum]

    def one_device(self, arch):
        """The port's one-device state and metrics after ``STEPS`` steps,
        on one intra-op thread as the ranks run (a multi-threaded CPU
        GEMM need not round as the single-threaded one does)."""
        w = self.arch[arch]
        step = train_loop.make_train_step(w["cfg"], opt_cfg=w["ocfg"])
        ts, ms = _clone(w["ts"]), []
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for b in w["tb"][:STEPS]:
                ts, m = step(ts, b)
                ms.append({k: float(v) for k, v in m.items()})
        finally:
            torch.set_num_threads(threads)
        return ts, ms


def _step_case(w, arch, mesh, **kw):
    return ("step", dict(mesh=mesh, arch=arch, state=w.arch[arch]["ts"],
                         batches=w.arch[arch]["tb"][:STEPS], opt=ADAMW,
                         **kw))


def _moe_inputs(w):
    """Layer 0's MoE params of the moe config's reference init, and a
    seeded ``[B, S, d]`` input."""
    jcfg = w.arch["deepseek_moe_16b"]["jcfg"]
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    jp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    x = np.random.default_rng(11).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    return jp, x


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                    p for p in os.environ.get("PYTHONPATH", "").split(
                        os.pathsep) if p]))


class _Runs:
    """The spawns, each joined on first use."""

    def __init__(self, w, tmp):
        self.w, self.tmp = w, tmp
        self.ckpt_2x2 = str(tmp / "ckpt_2x2")
        self.ckpt_preempt = str(tmp / "ckpt_preempt")
        self.ckpt_driver = str(tmp / "ckpt_driver")
        four = [_step_case(w, a, (2, 2), **(
            dict(save=self.ckpt_2x2) if a == "rwkv6_3b" else {}))
            for a in ARCHS]
        four.append(("roundtrip", dict(
            mesh=(2, 2), x=torch.arange(8 * 12 * 6, dtype=torch.float32
                                        ).reshape(8, 12, 6),
            specs=[("model", "data", None), (None, "data", "model"),
                   (("data", "model"), None, None), ()])))
        two = [_step_case(w, a, m) for a in ARCHS for m in ((1, 2), (2, 1))]
        two.append(_step_case(w, ACCUM_ARCH, (2, 1), accum=2))
        jp, x = _moe_inputs(w)
        self.moe = (jp, x)
        two += [("moe", dict(mesh=(2, 1), arch="deepseek_moe_16b",
                             p=bridge.lm_params_from_reference(jp, "cpu"),
                             x=torch.from_numpy(x), kw=kw))
                for kw in MOE_CAPS]
        two.append(("preempt", dict(
            mesh=(2, 1), request_on=1,
            argv=DRIVER[:-1] + ["5", "--ckpt-dir", self.ckpt_preempt])))
        for d in ("world4", "world2", "restore"):
            (tmp / d).mkdir()
        self.running = {
            4: Ranks(dict(train=four), 4, tmp / "world4", SPAWN_S),
            2: Ranks(dict(train=two), 2, tmp / "world2", SPAWN_S)}
        log = tmp / "driver.log"
        with open(log, "w") as f:
            self.driver_proc = (subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2", "-m",
                 "repro_torch.launch.train", *DRIVER, "--mesh", "2x1",
                 "--ckpt-dir", self.ckpt_driver],
                env=_env(), stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                start_new_session=True), log)
        self.joined = {}

    def __getitem__(self, key):
        if key not in self.joined:
            if key == "restore":
                self["four"]
                case = _step_case(self.w, "rwkv6_3b", (1, 2),
                                  restore=self.ckpt_2x2)
                case[1]["batches"] = self.w.arch["rwkv6_3b"]["tb"][STEPS:]
                self.joined[key] = [o["train"][0] for o in Ranks(
                    dict(train=[case]), 2, self.tmp / "restore",
                    SPAWN_S).wait()]
            elif key == "driver":
                p, log = self.driver_proc
                try:
                    p.wait(timeout=SPAWN_S)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGTERM)
                    try:
                        p.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()
                self.joined[key] = (p.returncode, log.read_text())
            else:
                n = {"four": 4, "two": 2}[key]
                self.joined[key] = self.running[n].wait()
        return self.joined[key]

    def stop(self):
        for r in self.running.values():
            r.stop()
        p = self.driver_proc[0]
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


@pytest.fixture(scope="module")
def world():
    return _World()


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    r = _Runs(world, tmp_path_factory.mktemp("train_mesh"))
    yield r
    r.stop()


def _case(runs, world_key, arch, mesh, accum=1):
    """Each rank's results of the step case ``arch`` at ``mesh``."""
    kinds = ([("step", a, (2, 2), 1) for a in ARCHS] if world_key == "four"
             else [("step", a, m, 1) for a in ARCHS
                   for m in ((1, 2), (2, 1))]
             + [("step", ACCUM_ARCH, (2, 1), 2)])
    i = kinds.index(("step", arch, mesh, accum))
    return [o["train"][i] for o in runs[world_key]]


def _assert_same_bits(a, b, what):
    fa, fb = dict(tree.leaves(a)), dict(tree.leaves(b))
    assert sorted(fa) == sorted(fb), what
    for k in fa:
        assert np_bits(fa[k]).tobytes() == np_bits(fb[k]).tobytes(), \
            (what, k)


def _assert_near_reference(got_state, got_metrics, js, jm, what):
    for g, w in zip(got_metrics, jm):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=REL,
                                       err_msg=f"{what}: {key}")
    trees = {"params": js.params, "m": js.opt.m, "v": js.opt.v}
    port = {"params": got_state.params, "m": got_state.opt.m,
            "v": got_state.opt.v}
    assert int(got_state.opt.step) == int(js.opt.step)
    for name, jt in trees.items():
        want = flat_ref(jt)
        for k, x in tree.leaves(port[name]):
            wk = np.asarray(want[k])
            np.testing.assert_allclose(
                x.numpy(), wk, rtol=0,
                atol=TOL[name] * float(np.abs(wk).max()),
                err_msg=f"{what}: {name}/{k}")


# ---------------------------------------------------------------------------
# the mesh step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_two_equals_one_device_bit_for_bit(world, runs, arch):
    ts, ms = world.one_device(arch)
    for r, res in enumerate(_case(runs, "two", arch, (1, 2))):
        assert res["metrics"] == ms, r
        _assert_same_bits(res["state"], ts, f"1x2 rank {r}")


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_matches_reference(world, runs, arch, mesh):
    js, jm = world.reference(arch)
    key = "four" if mesh == (2, 2) else "two"
    res = _case(runs, key, arch, mesh)[0]
    _assert_near_reference(res["state"], res["metrics"], js, jm,
                           f"{arch} {mesh}")


def test_accumulation_over_data_matches_reference(world, runs):
    """``--accum 2`` at 2×1: each microbatch split over ``data`` after the
    split into microbatches, so the MoE layers route the global
    microbatch's tokens as the reference's scan does."""
    js, jm = world.reference(ACCUM_ARCH, accum=2)
    res = _case(runs, "two", ACCUM_ARCH, (2, 1), accum=2)[0]
    _assert_near_reference(res["state"], res["metrics"], js, jm,
                           "accum 2 at 2x1")


@pytest.mark.parametrize("world_key", ["two", "four"])
def test_ranks_hold_the_same_bits(runs, world_key):
    """Every rank's gathered state and metrics equal rank 0's, case for
    case (the data reduction gives every rank one result)."""
    outs = runs[world_key]
    for i, res in enumerate(outs[0]["train"]):
        if not isinstance(res, dict) or "state" not in res:
            continue
        for r, o in enumerate(outs[1:], 1):
            assert o["train"][i]["metrics"] == res["metrics"], (i, r)
            _assert_same_bits(o["train"][i]["state"], res["state"],
                              f"case {i} rank {r}")


@pytest.mark.parametrize("cap", range(len(MOE_CAPS)))
def test_moe_over_data_matches_reference(world, runs, cap):
    """``moe_ffn`` with the rows split over two data ranks: the capacity
    and the drop order are the global batch's, so the drops and loads are
    the reference's on the whole batch, exactly, and pairs drop."""
    jp, x = runs.moe
    kw = MOE_CAPS[cap]
    jcfg = world.arch["deepseek_moe_16b"]["jcfg"]
    jy, jstats = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), **kw)
    n_moe = len(ARCHS) * 2 + 1
    for r, o in enumerate(runs["two"]):
        res = o["train"][n_moe + cap]
        assert float(res["dropped_frac"]) > 0, "no pair dropped"
        assert np_bits(res["dropped_frac"]).tobytes() == \
            np_bits(jstats.dropped_frac).tobytes(), r
        np.testing.assert_array_equal(res["load"].numpy(),
                                      np.asarray(jstats.load))
        want = np.asarray(jy)
        np.testing.assert_allclose(res["y"].numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_shard_then_gather_round_trips_over_2x2(runs):
    for r, o in enumerate(runs["four"]):
        got = o["train"][len(ARCHS)]
        assert [ok for _, ok in got] == [True] * 4, r
        assert [s for s, _ in got] == [(4, 6, 6), (8, 6, 3), (2, 12, 6),
                                       (8, 12, 6)], r


# ---------------------------------------------------------------------------
# checkpoints between meshes
# ---------------------------------------------------------------------------

def test_checkpoint_2x2_restores_at_1x2_and_one_device(world, runs):
    """Written at 2×2 after two steps: restored at 1×2 and on one device
    it holds the 2×2 state bit for bit, and the next step gives the same
    loss both ways (1×2 is the one-device step's bits)."""
    saved = _case(runs, "four", "rwkv6_3b", (2, 2))[0]["state"]
    assert checkpoint.latest_step(runs.ckpt_2x2) == STEPS - 1
    w = world.arch["rwkv6_3b"]
    one, _ = checkpoint.restore(runs.ckpt_2x2, _clone(w["ts"]))
    _assert_same_bits(one, saved, "restored on one device")
    step = train_loop.make_train_step(w["cfg"], opt_cfg=w["ocfg"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as the ranks run (one_device)
    try:
        one, m = step(one, w["tb"][STEPS])
    finally:
        torch.set_num_threads(threads)
    for r, res in enumerate(runs["restore"]):
        assert res["metrics"] == [{k: float(v) for k, v in m.items()}], r
        _assert_same_bits(res["state"], one, f"1x2 rank {r}")


def test_checkpoint_2x2_restores_in_reference(world, runs):
    saved = _case(runs, "four", "rwkv6_3b", (2, 2))[0]["state"]
    js, manifest = jckpt.restore(runs.ckpt_2x2, world.arch["rwkv6_3b"]["js"])
    assert manifest["step"] == STEPS - 1
    want = flat_ref(js)
    got = dict(tree.leaves(saved))
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(leaf), got[k].numpy(),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# the driver over a mesh
# ---------------------------------------------------------------------------

def test_preemption_is_agreed(runs):
    """Rank 1 alone is asked to stop: both ranks checkpoint step 0 and
    stop there (``PreemptionHandler.agreed``); rank 0 prints."""
    texts = runs["two"][0]["train"][-1], runs["two"][1]["train"][-1]
    assert texts[1] == ""
    lines = texts[0].splitlines()
    assert lines[0].split()[:2] == ["step", "0"]
    assert lines[-1] == "# preempted at step 0; checkpointed and exiting"
    assert checkpoint.latest_step(runs.ckpt_preempt) == 0


def test_launch_train_main_over_mesh(runs, capsys, tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train --mesh 2x1`` trains: rank 0 alone prints the
    mesh line and the step lines, whose losses are the one-process run's
    (printed to 4 places); its checkpoint resumes on one device."""
    rc, text = runs["driver"]
    assert rc == 0, text[-3000:]
    assert len(re.findall(r"^# mesh 2x1 on cpu \(data x model, 2 ranks over "
                          r"gloo\)$", text, re.M)) == 1, text[-3000:]
    steps = re.findall(r"^step +(\d+) loss (\S+) gnorm (\S+)", text, re.M)
    assert [s for s, _, _ in steps] == ["0", "2"], text[-3000:]
    assert len(re.findall(r"^# done$", text, re.M)) == 1
    launch_train.main(DRIVER + ["--ckpt-dir", str(tmp_path / "one")])
    one = re.findall(r"^step +(\d+) loss (\S+) gnorm (\S+)",
                     capsys.readouterr().out, re.M)
    for (s, l, g), (s1, l1, g1) in zip(steps, one):
        assert s == s1
        np.testing.assert_allclose(float(l), float(l1), atol=2e-4)
        np.testing.assert_allclose(float(g), float(g1), rtol=1e-3)
    launch_train.main(DRIVER[:-1] + ["4", "--ckpt-dir", runs.ckpt_driver])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# resumed from step 2 (data_position 12)"
    assert out[1].split()[:2] == ["step", "3"] and out[-1] == "# done"


def test_train_mesh_shape():
    assert meshlib.train_mesh_shape(4) == (4, 1)
    assert meshlib.train_mesh_shape(4, "2x2") == (2, 2)
    assert meshlib.train_mesh_shape(1, "1x1") == (1, 1)
    for world_size, arg in ((1, "3x1"), (4, "2x1"), (2, "0x2"), (2, "2")):
        with pytest.raises(ValueError):
            meshlib.train_mesh_shape(world_size, arg)

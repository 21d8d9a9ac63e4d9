"""The port's sharding rules and input specs (``launch/sharding.py``,
``launch/specs.py``) against the JAX package's, on the CPU, with no
ranks.

Every config at its published width, on the stand-in meshes the
reference's own tests and dry-run use (16×16, 2×16×16 with a pod axis)
and on 2×2: the port's spec of each leaf of the ``TrainState``
(``params/…``, ``opt/m/…``, ``opt/v/…``, ``opt/step``) is the
reference's ``PartitionSpec`` as a tuple, and likewise for the batch and
the decode cache. The reference's shapes come from its ``specs`` through
``jax.eval_shape``, the port's from its ``specs`` on the meta device:
neither allocates. The shapes and dtypes of both ``specs`` are equal.
The cases of ``tests/test_launch.py`` are mirrored on the port, and the
blocks ``shard_leaf`` cuts tile the whole leaf (the gather over real
ranks is ``tests/test_torch_train_mesh.py``'s).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402

from helpers.torch_train import flat_ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.launch import sharding, specs  # noqa: E402
from repro_torch.training import tree  # noqa: E402


def fake_mesh(axis_names, shape):
    """A mesh both packages read: the reference its ``devices.shape``,
    the port its ``shape``."""
    return SimpleNamespace(axis_names=axis_names, shape=shape,
                           devices=np.zeros(shape))


MESHES = {"16x16": fake_mesh(("data", "model"), (16, 16)),
          "2x16x16": fake_mesh(("pod", "data", "model"), (2, 16, 16)),
          "2x2": fake_mesh(("data", "model"), (2, 2))}
FAKE_MESH = MESHES["16x16"]


def _ref_flat_with_paths(t):
    return {jshd._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


_STATES = {}


def states(arch):
    """``(reference's abstract TrainState by path, the port's meta
    TrainState by key)`` at the published width, built once an arch."""
    if arch not in _STATES:
        js, _ = jspecs.state_specs(jconfigs.get_config(arch))
        ts, _ = specs.state_specs(configs.get_config(arch))
        _STATES[arch] = (_ref_flat_with_paths(js), dict(tree.leaves(ts)))
    return _STATES[arch]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# every leaf of every config, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_state_specs_match_reference(arch, mesh):
    want, got = states(arch)
    assert sorted(got) == sorted(want)
    m = MESHES[mesh]
    port = dict(tree.leaves(sharding.params_shardings(
        specs.state_specs(configs.get_config(arch))[0], m)))
    for key, leaf in want.items():
        assert port[key] == tuple(jshd.spec_for_leaf(key, leaf.shape, m)), \
            key
        assert sharding.spec_for_leaf(key, tuple(got[key].shape), m) == \
            port[key], key


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_state_shapes_match_reference(arch):
    want, got = states(arch)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == tuple(leaf.shape), key
        assert _dtype(got[key]) == str(leaf.dtype), key
        assert got[key].device.type == "meta", key


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's ``batch_shardings`` / ``cache_shardings`` return
    their ``PartitionSpec``s: a ``NamedSharding`` needs a mesh of real
    devices, which the stand-in meshes are not."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_specs_match_reference(arch, bare_specs):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for shape in specs.SHAPES:
        if not specs.cell_supported(cfg, shape)[0]:
            assert not jspecs.cell_supported(jcfg, shape)[0]
            continue
        want = jspecs.input_specs(jcfg, shape)
        got = specs.input_specs(cfg, shape)
        assert sorted(got) == sorted(want), shape
        for k, leaf in want.items():
            assert tuple(got[k].shape) == tuple(leaf.shape), (shape, k)
            assert _dtype(got[k]) == str(leaf.dtype), (shape, k)
        for name, m in MESHES.items():
            ref = jshd.batch_shardings(want, m)
            port = sharding.batch_shardings(got, m)
            for k in want:
                assert port[k] == tuple(ref[k]), (shape, name, k)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_specs_match_reference(arch, bare_specs):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        if not specs.cell_supported(cfg, shape)[0]:
            continue
        (jtok, jcache), (tok, cache) = (jspecs.decode_specs(jcfg, shape),
                                        specs.decode_specs(cfg, shape))
        assert tuple(tok["tokens"].shape) == tuple(jtok["tokens"].shape)
        want, got = flat_ref(jcache), dict(tree.leaves(cache))
        assert sorted(got) == sorted(want), shape
        for k, leaf in want.items():
            assert tuple(got[k].shape) == tuple(leaf.shape), (shape, k)
            assert _dtype(got[k]) == str(leaf.dtype), (shape, k)
        for name, m in MESHES.items():
            ref = flat_ref(jshd.cache_shardings(jcache, m))
            port = dict(tree.leaves(sharding.cache_shardings(cache, m)))
            for k in want:
                assert port[k] == tuple(ref[k]), (shape, name, k)


def test_specs_tables_match_reference():
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.SHAPE_DEFS == jspecs.SHAPE_DEFS
    assert specs.ACCUM == jspecs.ACCUM
    for arch in configs.ARCHS:
        for shape in specs.SHAPES:
            assert specs.cell_supported(configs.get_config(arch), shape) == \
                jspecs.cell_supported(jconfigs.get_config(arch), shape)


# ---------------------------------------------------------------------------
# tests/test_launch.py's cases on the port
# ---------------------------------------------------------------------------

def spec(path, shape):
    return sharding.spec_for_leaf(path, shape, FAKE_MESH)


def test_attention_rules():
    assert spec("params/layers/attn/wq", (80, 8192, 8192)) == \
        (None, "data", "model")
    assert spec("opt/m/layers/attn/wo", (80, 8192, 8192)) == \
        (None, "model", "data")
    assert spec("params/layers/attn/bq", (80, 8192)) == (None, "model")


def test_embed_rules_match_under_prefixes():
    assert spec("params/embed", (152064, 8192)) == ("model", "data")
    assert spec("opt/v/embed", (152064, 8192)) == ("model", "data")
    assert spec("params/lm_head", (8192, 152064)) == ("data", "model")


def test_moe_expert_parallel_rules():
    assert spec("params/layers/moe/wi", (27, 64, 2048, 1408)) == \
        (None, "model", "data", None)
    assert spec("params/layers/moe/wo", (27, 64, 1408, 2048)) == \
        (None, "model", None, "data")


def test_divisibility_fallback_replicates():
    assert spec("params/layers/attn/wq", (32, 1600, 1600)) == \
        (None, "data", "model")
    assert spec("params/layers/attn/wq", (32, 1602, 1602)) == \
        (None, None, None)


def test_norms_replicated():
    assert spec("params/layers/norm1", (80, 8192)) == ()
    assert spec("params/final_norm", (8192,)) == ()
    assert spec("opt/step", ()) == ()


def test_pod_axis_spreads_fsdp():
    m = MESHES["2x16x16"]
    assert sharding.spec_for_leaf("params/layers/attn/wq", (80, 8192, 8192),
                                  m) == (None, ("pod", "data"), "model")
    # 16 divides the data axis but not pod × data: data alone
    assert sharding.spec_for_leaf("params/layers/attn/wq", (80, 16, 8192),
                                  m) == (None, "data", "model")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_arch_majority_bytes_sharded(arch):
    """For every arch, at least 95% of parameter bytes shard over the
    mesh (the reference's bound)."""
    _, got = states(arch)
    total = repl = 0
    for key, leaf in got.items():
        if not key.startswith("params/"):
            continue
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        if all(ax is None for ax in (spec(key, tuple(leaf.shape))
                                     or (None,))):
            repl += nbytes
    assert repl / total < 0.05, (arch, repl / total)


# ---------------------------------------------------------------------------
# the blocks of one leaf over a 2x2 mesh
# ---------------------------------------------------------------------------

def _at(d: int, m: int):
    """Rank (d, m) of a 2x2 stand-in mesh: each axis an index and a size
    (no group: ``shard_leaf`` runs no collective)."""
    return SimpleNamespace(axis_names=("data", "model"), shape=(2, 2),
                           data=SimpleNamespace(index=d, size=2),
                           model=SimpleNamespace(index=m, size=2))


def _names(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@pytest.mark.parametrize("spec_,shape", [
    (("model", "data"), (8, 12)), ((None, "data", "model"), (3, 8, 12)),
    ((None, "model", None), (3, 8, 4)), ((("data", "model"), None), (8, 4)),
    ((), (8, 4))])
def test_shard_leaf_blocks_tile_the_leaf(spec_, shape):
    """Block i of a named dim sits at its axes' index (the first name the
    major one), so the four ranks' blocks put back in place are the leaf,
    each element held by as many ranks as the unnamed axes hold; at one
    rank ``gather_leaf`` gives the block back."""
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    back, cover = torch.zeros_like(x), torch.zeros_like(x)
    for d in range(2):
        for m in range(2):
            b = sharding.shard_leaf(x, spec_, _at(d, m))
            idx, sl = {"data": d, "model": m}, []
            for dim in range(x.ndim):
                i, n = 0, 1
                for name in _names(spec_[dim] if spec_ else None):
                    i, n = i * 2 + idx[name], n * 2
                w = x.shape[dim] // n
                assert b.shape[dim] == w, (d, m, dim)
                sl.append(slice(i * w, (i + 1) * w))
            back[tuple(sl)] = b
            cover[tuple(sl)] += 1
    assert torch.equal(back, x)
    named = sum(len(_names(e)) for e in spec_)
    assert bool((cover == 4 // 2 ** named).all())
    one = SimpleNamespace(axis_names=("data", "model"), shape=(1, 1),
                          data=engine.ONE_RANK, model=engine.ONE_RANK)
    assert torch.equal(sharding.gather_leaf(
        sharding.shard_leaf(x, spec_, one), spec_, one), x)

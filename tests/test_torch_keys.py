"""The curve keys' contract, rects and a frame in, against the JAX package.

On the CPU ``repro_torch.kernels.ops.spatial_key(rects, bbox, curve)``
runs its plain version, ``ref.spatial_key(spatial_key_inputs(rects,
bbox))``; on the card the same call is one launch that normalizes in
registers (``csrc/spatial_key.cu``, held against that plain version in
``tests/test_torch_cuda.py``). Here the CPU path is held bit for bit
against the reference's ``repro.kernels.ops.spatial_key`` as the
reference's own tests run it (its Pallas kernel in interpret mode): both
curves, a given frame, a zero-extent frame, ``bbox=None``, centres
outside the frame and degenerate rects under the unit frame. Inputs are
made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import schedule as jschedule  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import key_centres, rects  # noqa: E402

CURVES = ["hilbert", "morton"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(q, bbox, curve):
    """(the port's CPU keys, the reference's keys) of rects ``q``."""
    got = ops.spatial_key(_t(q), None if bbox is None else _t(bbox),
                          curve=curve).numpy()
    want = np.asarray(jops.spatial_key(
        jnp.asarray(q), bbox=None if bbox is None else jnp.asarray(bbox),
        curve=curve))
    return got, want


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("frame", ["given", "workload", "flat", "none"])
@pytest.mark.parametrize("n", [1, 130, 1000])
def test_keys_match_reference(curve, frame, n):
    """Random rects over [-3, 3]² keyed in a given frame (so some centres
    fall outside it), the workload's own frame, a zero-extent frame and
    the batch's own extent: bit-equal keys."""
    rng = np.random.default_rng(n)
    q = rects(rng, n, -3, 3, 0.5)
    bbox = {"given": np.float32([-1, -2, 1, 2]),
            "workload": schedule.workload_bbox(q),
            "flat": np.float32([0.5, 0.5, 0.5, 0.5]),
            "none": None}[frame]
    got, want = _both(q, bbox, curve)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if frame == "given" and n > 1:
        c = (q[:, :2] + q[:, 2:]) / 2
        assert ((c < bbox[:2]) | (c > bbox[2:])).any()


@pytest.mark.parametrize("curve", CURVES)
def test_degenerate_rects_under_the_unit_frame(curve):
    """A degenerate rect (c, c, c, c) under the frame [0, 0, 1, 1]
    normalizes to exactly c, so the edge centres (the frame's corners,
    where 1.0 clips to 32767, centres outside it, exact quantization
    steps and the floats just below) reach the keys through the rect
    contract; bit-equal to the reference where its kernel's cast is
    defined (|c| < 4) and to the plain keys of c everywhere."""
    c = key_centres(np.random.default_rng(5))
    q = np.concatenate([c, c], 1)
    unit = np.float32([0, 0, 1, 1])
    norm = ops.spatial_key_inputs(_t(q), _t(unit)).numpy()
    np.testing.assert_array_equal(norm, c)
    got = ops.spatial_key(_t(q), _t(unit), curve=curve).numpy()
    np.testing.assert_array_equal(
        got, ref.spatial_key(_t(c), curve=curve).numpy())
    fin = np.isfinite(c).all(axis=1) & (np.abs(c) < 4).all(axis=1)
    want = np.asarray(jops.spatial_key(jnp.asarray(q[fin]),
                                       bbox=jnp.asarray(unit), curve=curve))
    np.testing.assert_array_equal(got[fin], want)
    assert got[1] == got[12]        # (1, 1) clips to (32767, 32767)


@pytest.mark.parametrize("curve", CURVES)
def test_key_frame_and_inputs(curve):
    """``key_frame`` is the given frame, or the batch's centre extent;
    ``spatial_key_inputs`` is the reference's normalization bit for bit;
    the schedule's keys (the workload frame, widened where flat) match
    the reference's."""
    rng = np.random.default_rng(11)
    q = rects(rng, 257, -5, 5, 1.0)
    f = ops.key_frame(_t(q)).numpy()
    c = (q[:, :2] + q[:, 2:]) * np.float32(0.5)
    np.testing.assert_array_equal(f, np.concatenate([c.min(0), c.max(0)]))
    given = np.float32([-4, -4, 4, 4])
    np.testing.assert_array_equal(ops.key_frame(_t(q), _t(given)).numpy(),
                                  given)
    for bbox in (None, given):
        span = np.maximum((f if bbox is None else bbox)[2:]
                          - (f if bbox is None else bbox)[:2],
                          np.float32(1e-12))
        want = (c - (f if bbox is None else bbox)[:2]) / span
        got = ops.spatial_key_inputs(
            _t(q), None if bbox is None else _t(bbox)).numpy()
        np.testing.assert_array_equal(got, want)
    qc = np.tile(q[:1], (9, 1))                     # one coincident centre
    for qq in (q, qc):
        np.testing.assert_array_equal(
            schedule.spatial_keys(qq, curve, device="cpu"),
            np.asarray(jschedule.spatial_keys(qq, curve)))


def test_contract_is_checked():
    """A wrong curve, order or rect shape raises before anything runs."""
    q = _t(rects(np.random.default_rng(0), 8))
    with pytest.raises(ValueError):
        ops.prepare("spatial_key", q, None, "zorder")
    with pytest.raises(ValueError):
        ops.prepare("spatial_key", q, None, "hilbert", 16)
    with pytest.raises(ValueError):
        ops.prepare("spatial_key", q[:, :2], None, "hilbert")
    with pytest.raises(ValueError):
        ops.prepare("spatial_key", q, torch.zeros(5), "hilbert")

"""The port's ``ops.wkv6`` against the JAX package, on the CPU.

On CPU tensors the port runs the plain version, ``kernels.ref.wkv6`` (the
sequential scan); the reference runs its chunked Pallas kernel in
interpret mode (``repro.kernels.ops.wkv6``) and its own sequential scan
(``repro.kernels.ref.wkv6``). Every input is drawn with numpy from a
seed and handed to both packages.

Tolerance: rtol = atol = 5e-4, the reference's own for its kernel against
its scan (``tests/test_kernels.py``). Everything is float32 (bf16 inputs
are upcast first on both sides); the chunked kernel and the sequential
scan add the same terms in another order, so they differ by rounding.
Against the reference's sequential scan the port does the same
arithmetic in the same order: held to 1e-5.

A decay of exactly 0 is held against the sequential scan only: the
reference's chunked kernel gives NaN there (``log 0 - log 0``), a
reference fault the port's CUDA kernel does not share; the test asserts
that the NaN is still there, so the fault stays visible.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402

from repro_torch.kernels import cuda as kcuda, ops, ref  # noqa: E402

TOL = 5e-4          # the reference's kernel-vs-scan tolerance
SAME = 1e-5         # the port's scan against the reference's scan


def _inputs(seed, BH, T, dk, dv, lo=0.05, hi=0.999):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(BH, T, dk)).astype(np.float32)
    k = rng.normal(size=(BH, T, dk)).astype(np.float32)
    v = rng.normal(size=(BH, T, dv)).astype(np.float32)
    w = rng.uniform(lo, hi, size=(BH, T, dk)).astype(np.float32)
    u = rng.normal(size=(BH, dk)).astype(np.float32)
    return r, k, v, w, u


def _port(args, dtype=torch.float32):
    return ops.wkv6(*(torch.from_numpy(a).to(dtype) for a in args)).numpy()


def _jax(fn, args, dtype=jnp.float32, **kw):
    return np.asarray(fn(*(jnp.asarray(a, dtype) for a in args), **kw),
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("BH,T,dk,dv,chunk", [
    (1, 16, 8, 8, 16), (3, 64, 8, 16, 16), (2, 48, 16, 16, 16),
    (1, 33, 8, 8, 16),  # padded-T path of the reference
    (2, 128, 32, 32, 64),
])
def test_wkv6_shapes(BH, T, dk, dv, chunk):
    args = _inputs(0, BH, T, dk, dv)
    got = _port(args)
    assert got.shape == (BH, T, dv) and got.dtype == np.float32
    _close(got, _jax(jops.wkv6, args, chunk=chunk), TOL)
    _close(got, _jax(jref.wkv6, args), SAME)


def test_wkv6_extreme_decay():
    args = _inputs(1, 2, 64, 8, 8, lo=1e-8, hi=0.1)
    got = _port(args)
    assert np.isfinite(got).all()
    _close(got, _jax(jops.wkv6, args, chunk=16), TOL)
    _close(got, _jax(jref.wkv6, args), SAME)


def test_wkv6_bf16_inputs():
    """bf16 inputs round the same way in both packages, then both upcast
    to float32."""
    args = _inputs(2, 2, 32, 8, 8, lo=0.3, hi=0.99)
    got = _port(args, torch.bfloat16)
    _close(got, _jax(jops.wkv6, args, jnp.bfloat16, chunk=16), TOL)
    _close(got, _jax(jref.wkv6, args, jnp.bfloat16), SAME)


def test_wkv6_zero_decay_matches_the_scan():
    """w = 0 resets the state: the port follows the sequential definition;
    the reference's chunked kernel returns NaN there."""
    args = list(_inputs(3, 2, 32, 8, 8))
    args[3][0, 5] = 0.0            # one time step of row 0, every channel
    args[3][1, 20, :3] = 0.0       # three channels of row 1
    got = _port(args)
    assert np.isfinite(got).all()
    _close(got, _jax(jref.wkv6, args), SAME)
    # the reset: row 0's outputs after step 5 do not see steps before it
    cut = [a.copy() for a in args]
    cut[0][0, :5] = 0.0
    cut[1][0, :5] = 0.0
    _close(_port(cut)[0, 6:], got[0, 6:], SAME)
    assert np.isnan(_jax(jops.wkv6, args, chunk=16)).any()


def test_pad_time_adds_identity_steps():
    """The card's padding: w = 1 and r = k = v = 0 past T leave the first
    T outputs of the scan bit-equal."""
    args = [torch.from_numpy(a) for a in _inputs(4, 2, 33, 8, 16)]
    r, k, v, w = ops.pad_time(*args[:4], 16)
    assert r.shape[1] == k.shape[1] == v.shape[1] == w.shape[1] == 48
    assert torch.equal(w[:, 33:], torch.ones_like(w[:, 33:]))
    for a in (r, k, v):
        assert not a[:, 33:].any()
    assert torch.equal(ref.wkv6(r, k, v, w, args[4])[:, :33],
                       ref.wkv6(*args))
    same = ops.pad_time(*args[:4], 11)
    assert all(a is b for a, b in zip(same, args[:4]))


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA kernel")
    monkeypatch.setattr(kcuda.Kernel, "__call__", boom)
    monkeypatch.setattr(kcuda, "build_all", boom)
    monkeypatch.setattr(ops, "_prep_wkv6", boom)
    args = _inputs(5, 1, 33, 8, 8)
    _close(_port(args), _jax(jref.wkv6, args), SAME)
    assert kcuda.KERNELS["wkv6"].launches == 0


def test_wkv6_launcher_checks():
    """The card's launcher validates shapes before it touches a device:
    mismatched inputs, a chunk that is no multiple of 4 or does not divide
    T, and a CTA past the shared memory limit raise. The rwkv6-3b shape
    (dk = dv = 64, chunk 64) fits one CTA."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(6, 1, 64, 8, 8))
    with pytest.raises(ValueError, match="do not match"):
        ops._prep_wkv6(r, k[:, :32], v, w, u, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops._prep_wkv6(r, k, v, w, u, 6)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops._prep_wkv6(r, k, v, w, u, 48)
    big = torch.zeros(1, 256, 512)
    with pytest.raises(ValueError, match="shared memory"):
        ops._prep_wkv6(big, big, big, big, torch.zeros(1, 512), 256)
    assert ops.wkv6_smem(64, ops.WKV6_CHUNK) <= ops.MAX_DYNAMIC_SMEM
    assert kcuda.KERNELS["wkv6"].replaces == "src/repro/kernels/wkv6.py:82"

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

``_mirror`` rehearses the card's decomposition (``csrc/wkv6.cu``) in
plain PyTorch, step for step: log2 w clamped at -126, the chunk's
exclusive cumsum P, the chunk state deltas and decays, the pass over
chunk states, and the outputs by 16-step sub-chunks (the off-diagonal
scores factored at the sub-chunk's first step, the diagonal blocks per
channel). It runs in float64, so that 1e-5 against both float32
sequential scans tests its algebra and not float32 rounding: in float32
the chunked form is 1e-4 from the scan at dk 64, as the reference's
kernel is, and is held to 5e-4 there.
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


SUB = 16            # steps of a sub-chunk (kSub in csrc/wkv6.cu)


def _mirror(r, k, v, w, u, chunk):
    """The card's chunk-parallel split of the scan, on the CPU in the
    inputs' type (r/k/w [BH, T, dk], v [BH, T, dv], u [BH, dk] → y
    [BH, T, dv])."""
    T = r.shape[1]
    r, k, v, w = ops.pad_time(r, k, v, w, chunk)
    BH, Tp, dk = r.shape
    dv = v.shape[-1]
    C, nc = chunk, Tp // chunk
    rc, kc, wc = (a.reshape(BH, nc, C, dk) for a in (r, k, w))
    vc = v.reshape(BH, nc, C, dv)
    lw = torch.log2(wc)
    lw = torch.where(lw < -126.0, torch.full_like(lw, -126.0), lw)
    P = torch.cat([torch.zeros_like(lw[:, :, :1]), lw.cumsum(2)], 2)
    # 1. chunk state deltas dS_c = (k ⊙ 2^{tot - P_{j+1}})ᵀ v, decay 2^{tot}
    tot = P[:, :, C:]
    dS = (kc * torch.exp2(tot - P[:, :, 1:])).transpose(2, 3) @ vc
    decay = torch.exp2(tot[:, :, 0])
    # 2. the pass over chunk states: S_c enters chunk c
    S = torch.zeros_like(dS[:, 0])
    enter = []
    for c in range(nc):
        enter.append(S)
        S = decay[:, c, :, None] * S + dS[:, c]
    Sc = torch.stack(enter, 1)
    # 3. outputs: inter, then per 16-step sub-chunk the off-diagonal scores
    #    (factored at its first step s) and the diagonal block per channel
    y = (rc * torch.exp2(P[:, :, :C])) @ Sc
    causal = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    for s in range(0, C, SUB):
        rows = slice(s, s + SUB)
        sc = torch.zeros(BH, nc, SUB, s + SUB, dtype=r.dtype)
        if s:
            a = rc[:, :, rows] * torch.exp2(P[:, :, rows] - P[:, :, s:s + 1])
            b = kc[:, :, :s] * torch.exp2(P[:, :, s:s + 1] - P[:, :, 1:s + 1])
            sc[..., :s] = a @ b.transpose(2, 3)
        e = P[:, :, rows, None, :] - P[:, :, None, s + 1:s + SUB + 1, :]
        e = torch.where(causal[:, :, None], e, torch.full_like(e, -torch.inf))
        diag = (rc[:, :, rows, None, :] * kc[:, :, None, rows, :]
                * torch.exp2(e)).sum(-1)
        bonus = (rc[:, :, rows] * u[:, None, None, :] * kc[:, :, rows]).sum(-1)
        sc[..., s:] = diag + torch.diag_embed(bonus)
        y[:, :, rows] += sc @ vc[:, :, :s + SUB]
    return y.reshape(BH, Tp, dv)[:, :T]


def _mirror_np(args, chunk, dtype=torch.float64):
    return _mirror(*(torch.from_numpy(a).to(dtype) for a in args),
                   chunk).to(torch.float32).numpy()


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


MIRROR_SHAPES = [
    (1, 16, 8, 8, 16), (3, 64, 8, 16, 16), (2, 48, 16, 16, 16),
    (1, 33, 8, 8, 16), (2, 128, 32, 32, 64),    # the table above
    (2, 70, 16, 8, 64), (3, 100, 8, 24, 32),     # T no multiple of 16
    (2, 200, 64, 64, 64), (1, 96, 16, 16, 48),   # the card's width; C 48
]


@pytest.mark.parametrize("BH,T,dk,dv,chunk", MIRROR_SHAPES)
def test_wkv6_mirror_shapes(BH, T, dk, dv, chunk):
    """The card's split, rehearsed on the CPU, against both sequential
    scans (1e-5) and the reference's chunked kernel (5e-4)."""
    args = _inputs(10, BH, T, dk, dv)
    got = _mirror_np(args, chunk)
    assert got.shape == (BH, T, dv)
    _close(got, _port(args), SAME)
    _close(got, _jax(jref.wkv6, args), SAME)
    _close(got, _jax(jops.wkv6, args, chunk=chunk), TOL)
    _close(_mirror_np(args, chunk, torch.float32), got, TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_mirror_extreme_decay(chunk):
    args = _inputs(11, 2, 150, 16, 16, lo=1e-8, hi=0.1)
    got = _mirror_np(args, chunk)
    assert np.isfinite(got).all()
    _close(got, _port(args), SAME)
    _close(got, _jax(jref.wkv6, args), SAME)
    _close(got, _jax(jops.wkv6, args, chunk=chunk), TOL)


# w = 0 on steps at the edges of a sub-chunk (15, 16, 31) and of a chunk
# (63, 64, 127, the padded sequence's last real step 149); a whole step or
# some channels
ZERO_STEPS = [(0, 15, None), (0, 16, None), (1, 31, 3), (1, 63, None),
              (2, 64, 5), (2, 127, None), (0, 149, None), (1, 0, None)]


@pytest.mark.parametrize("chunk", [64, 32])
def test_wkv6_mirror_zero_decay_at_boundaries(chunk):
    """w = 0 resets the state at the first and last step of a sub-chunk
    and of a chunk: the split agrees with the sequential scans (the
    reference's chunked kernel gives NaN there)."""
    args = list(_inputs(12, 3, 150, 16, 16))
    for row, step, n_ch in ZERO_STEPS:
        args[3][row, step, :n_ch] = 0.0
    got = _mirror_np(args, chunk)
    assert np.isfinite(got).all()
    _close(got, _port(args), SAME)
    _close(got, _jax(jref.wkv6, args), SAME)
    # the reset: row 2's outputs after step 127 do not see the steps before
    cut = [a.copy() for a in args]
    cut[1][2, :127] = 0.0
    _close(_mirror_np(cut, chunk)[2, 128:], got[2, 128:], SAME)
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
    mismatched inputs, a chunk that is no multiple of 16, past 64 or does
    not divide T, and a head wider than the kernel's 64 raise (the C
    launcher's own refusal is a card test)."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(6, 1, 64, 8, 8))
    with pytest.raises(ValueError, match="do not match"):
        ops._prep_wkv6(r, k[:, :32], v, w, u, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops._prep_wkv6(r, k, v, w, u, 6)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops._prep_wkv6(r, k, v, w, u, 48)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops._prep_wkv6(r, k, v, w, u, 128)
    big = torch.zeros(1, 256, 512)
    with pytest.raises(ValueError, match="heads of at most 64"):
        ops._prep_wkv6(big, big, big, big, torch.zeros(1, 512), 64)
    assert kcuda.KERNELS["wkv6"].replaces == "src/repro/kernels/wkv6.py:82"


def _smoke():
    """``chip_smoke.py`` (repo root) as a module; it imports nothing of
    the card at module level."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("BH, T", [(40, 32768), (320, 4096)])
def test_smoke_wkv6_bound_at_the_prefill_shapes(BH, T):
    """The smoke's wkv6 bound at rwkv6-3b's prefill shapes: r, k, w, v
    read once and y written once (f32) over 3.35 TB/s outweigh the
    sub-chunked form's operations; the chunk-serial yardstick printed
    beside it counts more operations than the sub-chunked form."""
    smoke = _smoke()
    n_bytes, f32, tc = smoke.wkv6_work(BH, T, 64, 64, 64)
    assert n_bytes == 4 * (BH * T * 5 * 64 + BH * 64)
    b, by = smoke.wkv6_bound(BH, T, 64, 64, 64)
    assert by == "bytes"
    assert b == pytest.approx(n_bytes / smoke.HBM_BYTES_PER_S * 1e3)
    assert f32 / smoke.F32_OPS_PER_S + tc / smoke.TF32_OPS_PER_S < b / 1e3
    old = smoke.wkv6_scores_bound(BH, T, 64, 64, 64)
    assert old > b
    assert 64 * 63 // 2 * 64 * 5 * BH * T // 64 > f32


def test_smoke_kernel_means_groups_launches_by_kernel():
    """``chip_smoke.kernel_means`` keys a CUPTI event by the kernel's name
    before its argument list (anonymous namespace or not), so the three
    wkv6 kernels of a call are each a mean over their own launches."""
    class Span:
        def __init__(self, us):
            self.us = us

        def elapsed_us(self):
            return self.us

    class Event:
        def __init__(self, name, us):
            self.name, self.time_range = name, Span(us)

    anon = "(anonymous namespace)::"
    events = [Event(anon + "wkv6_state_kernel(float const*, int)", 500),
              Event(anon + "wkv6_state_kernel(float const*, int)", 700),
              Event(anon + "wkv6_scan_kernel(float*, int, int)", 300),
              Event("wkv6_output_kernel(float const*)", 1200)]
    means = _smoke().kernel_means(events)
    assert means == pytest.approx({"wkv6_state_kernel": 0.6,
                                   "wkv6_scan_kernel": 0.3,
                                   "wkv6_output_kernel": 1.2})

"""Helpers of the port's training tests against the JAX package
(``tests/test_torch_train*.py``, CPU only: this module imports JAX).

Trees cross as numpy: ``flat_ref`` keys a reference pytree by the
port's ``tree.leaves`` paths, ``np_bits`` reads either package's array
(bf16 as its int16 bits), and ``within_ulp`` holds one to the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.training import optimizer as jopt
from repro_torch import bridge
from repro_torch.training import optimizer as opt

CPU = torch.device("cpu")


def np_bits(x):
    """A numpy view of a tensor or array; bf16 as its int16 bits."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def flat_ref(t):
    """``{path: leaf}`` of a reference pytree, paths joined by ``/``."""
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(t)}


def adamw_configs(**kw):
    """The same ``AdamWConfig`` in both packages."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    return opt.AdamWConfig(**kw), jopt.AdamWConfig(**{
        k: jdt.get(v, v) if k == "state_dtype" else v
        for k, v in kw.items()})


def within_ulp(got, want, what, slack=0.0):
    """``got`` within 1 ulp of ``want`` (float32) plus ``slack``
    (absolute, elementwise); bf16 bits within 1 step."""
    got, want = np_bits(got), np_bits(want)
    if want.dtype == np.int16:              # bf16 bits: 1 ulp apart
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert int(d.max()) <= 1, what
        return
    err = np.abs(got.astype(np.float64) - want)
    tol = np.spacing(np.abs(want)).astype(np.float64) + slack
    assert (err <= tol).all(), (what, float((err / tol).max()))


def opt_inputs(jp, seed, state_dtype=jnp.float32):
    """Grads and an AdamW state at step 3 (m, v random; v > 0) over the
    reference params ``jp``'s tree, in both packages:
    ``((grads, state), (grads, state))``. The gradients are multiples of
    2^-9 up to 6 of them: with ~2·10^5 of them every square and partial
    sum of the global norm is an integer number of 2^-18 below 2^24 of
    them, exact in float32 in any order, so both norms (and clip scales)
    are a sqrt of the same sum."""
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda a: jnp.asarray(
        (rng.integers(-6, 7, a.shape) * 2.0 ** -9).astype(np.float32)), jp)
    m = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, 0.01, a.shape).astype(np.float32), state_dtype), jp)
    v = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0, 1e-3, a.shape).astype(np.float32), state_dtype), jp)
    jstate = jopt.OptState(step=jnp.asarray(3, jnp.int32), m=m, v=v)
    tstate = opt.OptState(step=torch.tensor(3, dtype=torch.int32),
                          m=bridge._lm_tree(m, CPU), v=bridge._lm_tree(v, CPU))
    return (g, jstate), (bridge._lm_tree(g, CPU), tstate)

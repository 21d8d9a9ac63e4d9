"""How far float32 puts rwkv6-3b's train step from the same step in float64.

``python -m repro_torch.launch.float_witness --layers 1 [--device cuda]``

Three steps of ``launch/train.py``'s defaults (batch 8 x seq 128, seed 0)
at the published width cut to ``--layers``: the plain float32 step, then
the same function in other float orders — every batch's rows reversed,
rolled by one, and split into two microbatches of 4 rows (``--accum 2``,
the float order of a 2x1 mesh, whose two data ranks' gradients are
summed) — and in float64. Each is held against the plain float32 step:
loss and grad norm (the largest relative difference over the steps) and
params, m and v (the largest |diff| over the leaf's largest |value|, and
that leaf). The float64 line is the plain step's own float32 error.

``python -m repro_torch.launch.float_witness --layers 2 --gradient``

The gradient at the state after one float32 step, of batch 1's rows 0:4
and 4:8, in float64 against float32 four ways: the device's step (the
``wkv6`` kernel on the card), the plain scan on the device, the rows
reversed, and the CPU. This is the witness for a gradient that two
float32 orders do not agree on: it says which of them, if any, is off.
Then where float32's error enters: float64 with one op in float32 (the
scan, the time-mix's group norm ``ln_x``, the block and final norms,
the blocks' products, the LM head's product),
float32 with the scan and the group norm in float64, and, in float64,
the smallest mean square a head a token of the group norm's input.

Float64 runs the same model code: within ``float64_model`` the model
modules' ``torch.float32`` reads as ``torch.float64`` and ``wkv6`` is
the plain scan (the kernel is float32 only). ``--reduced`` runs
``reduced(rwkv6_3b)`` (a CPU check of this script).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import types

import torch

from repro_torch import configs, resolve_device
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.models import layers, ssm, transformer
from repro_torch.training import optimizer as opt, train_loop, tree

STEPS = 3


class _Float64Torch:
    """``torch``, with ``float32`` read as ``float64``; with ``products``
    a dtype, ``einsum`` computes in it and gives float64 back."""

    def __init__(self, products=None):
        self._products = products

    def einsum(self, eq, *operands):
        if self._products is None:
            return torch.einsum(eq, *operands)
        return torch.einsum(eq, *(x.to(self._products)
                                  for x in operands)).double()

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@contextlib.contextmanager
def float64_model():
    """The model's float32 casts made float64, ``wkv6`` the plain scan."""
    mods = (ssm, ref, transformer, layers)
    saved = [m.torch for m in mods], ssm.ops
    try:
        for m in mods:
            m.torch = _Float64Torch()
        ssm.ops = types.SimpleNamespace(wkv6=ref.wkv6)
        yield
    finally:
        for m, t in zip(mods, saved[0]):
            m.torch = t
        ssm.ops = saved[1]


@contextlib.contextmanager
def plain_scan():
    """``wkv6`` the plain scan on any device."""
    saved = ssm.ops
    ssm.ops = types.SimpleNamespace(wkv6=ref.wkv6)
    try:
        yield
    finally:
        ssm.ops = saved


def leaf_errs(got: dict, want: dict, cut=lambda key, x: x) -> dict:
    """``{params, m, v: (largest |diff| / the leaf's largest |value|,
    that leaf)}`` of the state leaves ``got`` against ``want``
    (``{key: leaf}``), each leaf of ``want`` cut by ``cut(key, leaf)``
    to ``got``'s block (a mesh rank's shards)."""
    e = {n: (0.0, "-") for n in ("params", "m", "v")}
    for key, w in want.items():
        if key == "opt/step":
            continue
        name = "params" if key.startswith("params/") else key.split("/")[1]
        d = float((got[key].double().to(w.device)
                   - cut(key, w).double()).abs().max())
        top = float(w.abs().max())
        rel = d / top if top else d
        if rel > e[name][0]:
            e[name] = (rel, key)
    return e


def run_steps(cfg, ocfg, dev, order: str):
    """``({key: leaf} after STEPS steps, [(loss, grad norm)])`` of the
    step in ``order``."""
    st = train_loop.init_train_state(
        cfg, torch.Generator(dev).manual_seed(0), dtype=torch.float32,
        opt_cfg=ocfg, device=dev)
    ctx = contextlib.nullcontext()
    accum = 2 if order == "two microbatches (--accum 2)" else 1
    if order == "float64":
        o64 = dataclasses.replace(ocfg, state_dtype=torch.float64)
        params = tree.rebuild(st.params, lambda _, x: x.double())
        st = train_loop.TrainState(params, opt.init_opt_state(o64, params))
        ocfg, ctx = o64, float64_model()
    rows = {"rows reversed": lambda x: x.flip(0),
            "rows rolled": lambda x: x.roll(1, 0)}.get(order, lambda x: x)
    step = train_loop.make_train_step(cfg, opt_cfg=ocfg, accum_steps=accum)
    metrics = []
    with ctx:
        for s in range(STEPS):
            b = train.synthetic_batch(cfg, 8, 128, s, device=dev)
            st, m = step(st, {k: rows(x) for k, x in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(tree.leaves(st)), metrics


def steps_report(cfg, ocfg, dev) -> None:
    base, mb = run_steps(cfg, ocfg, dev, "plain")
    print(f"# float32 plain step: (loss, grad norm) {mb}", flush=True)
    for order in ("rows reversed", "rows rolled",
                  "two microbatches (--accum 2)", "float64"):
        got, m = run_steps(cfg, ocfg, dev, order)
        rel = max(abs(a - b) / abs(b) for x, y in zip(m, mb)
                  for a, b in zip(x, y))
        e = leaf_errs(got, base)
        print(f"# {order} against the float32 plain step: loss/gnorm rel "
              f"{rel:.3e}; " + "; ".join(
                  f"{n} {v[0]:.3e} of a leaf's max ({v[1]})"
                  for n, v in e.items()), flush=True)
        del got


def _gradient(cfg, params, batch, dev, *, ctx=None):
    with ctx or contextlib.nullcontext():
        loss, g = train_loop._loss_and_grads(
            cfg, params, {k: v.to(dev) for k, v in batch.items()}, None)
    return float(loss), {k: x.cpu() for k, x in tree.leaves(g)}


@contextlib.contextmanager
def _swap(mod, name, value):
    saved = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _rmsnorm_in(dt):
    """``layers.rmsnorm`` computed in ``dt``, its result in x's dtype."""
    def norm(x, w, eps):
        y = x.to(dt)
        y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
        return (y * (1.0 + w.to(dt))).to(x.dtype)
    return norm


def _scan_in(dt):
    """The plain ``wkv6`` scan computed in ``dt``, its result in r's
    dtype."""
    def scan(*a):
        with _swap(ref, "torch", torch if dt == torch.float32
                   else _Float64Torch()):
            return ref.wkv6(*(x.to(dt) for x in a)).to(a[0].dtype)
    return scan


@contextlib.contextmanager
def _one_op(model, *swaps):
    """``model`` (``float64_model`` or ``plain_scan``) with ``swaps``
    (``(module, name, value)``) inside it."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(model())
        for s in swaps:
            stack.enter_context(_swap(*s))
        yield


def gradient_report(cfg, ocfg, dev) -> None:
    st = train_loop.init_train_state(
        cfg, torch.Generator(dev).manual_seed(0), dtype=torch.float32,
        opt_cfg=ocfg, device=dev)
    st, _ = train_loop.make_train_step(cfg, opt_cfg=ocfg)(
        st, train.synthetic_batch(cfg, 8, 128, 0, device=dev))
    p32 = st.params
    del st
    p64 = tree.rebuild(p32, lambda _, x: x.double())
    batch = train.synthetic_batch(cfg, 8, 128, 1)
    f32, f64 = torch.float32, torch.float64
    scan32 = (ssm, "ops", types.SimpleNamespace(wkv6=_scan_in(f32)))
    scan64 = (ssm, "ops", types.SimpleNamespace(wkv6=_scan_in(f64)))
    # ssm's rmsnorm is the time-mix's group norm (ln_x) alone
    group32, group64 = ((ssm, "rmsnorm", _rmsnorm_in(d)) for d in (f32, f64))
    blocks32 = (transformer, "rmsnorm", _rmsnorm_in(f32))
    # ssm's einsums are the blocks' products; transformer's, the LM head
    products32, head32 = ((m, "torch", _Float64Torch(products=f32))
                          for m in (ssm, transformer))

    def norm(g):
        return float(sum((x.double() ** 2).sum() for x in g.values()) ** .5)

    for rows in (slice(0, 4), slice(4, 8)):
        part = {k: v[rows] for k, v in batch.items()}
        seen = []

        def group_seen(x, w, eps, _norm=ssm.rmsnorm):
            seen.append(torch.mean(x.double() ** 2, dim=-1).detach().cpu())
            return _norm(x, w, eps)
        l64, g64 = _gradient(cfg, p64, part, dev, ctx=_one_op(
            float64_model, (ssm, "rmsnorm", group_seen)))
        n64 = norm(g64)
        print(f"# rows {rows.start}:{rows.stop}, float64 on {dev}: loss "
              f"{l64:.9f}, grad norm {n64:.6f}", flush=True)
        for i, ms in enumerate(seen[:cfg.n_layers]):    # [B, S, H]
            at = tuple(int(j) for j in torch.unravel_index(ms.argmin(),
                                                           ms.shape))
            print(f"# rows {rows.start}:{rows.stop}, layer {i}: the group "
                  f"norm's input, mean y^2 a head a token: smallest "
                  f"{float(ms.min()):.3e} at (row, token, head) {at}, "
                  f"{int((ms < 1e3 * cfg.norm_eps).sum())} of {ms.numel()} "
                  f"under 1000 x eps ({cfg.norm_eps:g})", flush=True)
        ways = [(f"float32 on {dev}", p32, part, dev, None),
                (f"float32 on {dev}, the plain scan", p32, part, dev,
                 plain_scan()),
                (f"float32 on {dev}, the rows reversed", p32,
                 {k: v.flip(0) for k, v in part.items()}, dev, None)]
        if dev.type != "cpu":
            ways.append(("float32 on the CPU",
                         tree.rebuild(p32, lambda _, x: x.cpu()), part,
                         torch.device("cpu"), None))
        ways += [
            (f"float64 on {dev}, the scan in float32", p64, part, dev,
             _one_op(float64_model, scan32)),
            (f"float64 on {dev}, the group norm in float32", p64, part, dev,
             _one_op(float64_model, group32)),
            (f"float64 on {dev}, the block and final norms in float32", p64,
             part, dev, _one_op(float64_model, blocks32)),
            (f"float64 on {dev}, the blocks' products in float32", p64,
             part, dev, _one_op(float64_model, products32)),
            (f"float64 on {dev}, the head's product in float32", p64, part,
             dev, _one_op(float64_model, head32)),
            (f"float32 on {dev}, the scan and the group norm in float64",
             p32, part, dev, _one_op(plain_scan, scan64, group64))]
        for name, params, b, d, ctx in ways:
            loss, g = _gradient(cfg, params, b, d, ctx=ctx)
            worst = max((float((g[k].double() - x).abs().max()
                               / x.abs().max()), k) for k, x in g64.items())
            print(f"#   {name}: loss rel {abs(loss - l64) / l64:.3e}, grad "
                  f"norm {norm(g):.6f} (rel {abs(norm(g) - n64) / n64:.3e})"
                  f", the worst leaf {worst[1]} {worst[0]:.3e} of its "
                  "largest value off float64", flush=True)
            del g


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--gradient", action="store_true")
    p.add_argument("--reduced", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import cuda as kcuda
        kcuda.build_all([kcuda.KERNELS["wkv6"]])
    cfg = configs.get_config("rwkv6_3b")
    if args.reduced:
        cfg = configs.reduced(cfg)
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    ocfg = train.adamw_config(train.parse_args(
        ["--arch", "rwkv6-3b", "--steps", str(STEPS)]))
    print(f"# rwkv6-3b, {args.layers} layer(s), d_model {cfg.d_model}, on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}"
          , flush=True)
    (gradient_report if args.gradient else steps_report)(cfg, ocfg, dev)


if __name__ == "__main__":
    main()

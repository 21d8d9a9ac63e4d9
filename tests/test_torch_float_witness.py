"""``launch/float_witness.py`` on the CPU at ``reduced(rwkv6_3b)``.

``float64_model`` turns the train step into float64 and gives the model
modules back as they were; the other float orders of the step (rows
reversed, rolled, two microbatches) are the same function, so at this
size each lies within float32's rounding of the plain step and of
float64; and the gradient report runs every way it compares.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import float_witness as fw, train  # noqa: E402
from repro_torch.models import layers, ssm, transformer  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-4      # the train step tests' bound (loss, grad norm, leaves)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "rwkv6_3b")), n_layers=1)
    ocfg = train.adamw_config(train.parse_args(
        ["--arch", "rwkv6-3b", "--steps", str(fw.STEPS)]))
    base, metrics = fw.run_steps(cfg, ocfg, CPU, "plain")
    return cfg, ocfg, base, metrics


def _rel(m, mb):
    return max(abs(a - b) / abs(b) for x, y in zip(m, mb)
               for a, b in zip(x, y))


def test_float64_model_runs_float64_and_restores(setup):
    cfg, ocfg, base, mb = setup
    got, m = fw.run_steps(cfg, ocfg, CPU, "float64")
    assert all(x.dtype == torch.float64 for k, x in got.items()
               if k != "opt/step")
    for mod in (ssm, ref, transformer, layers):
        assert mod.torch is torch
    assert ssm.ops is ops
    assert _rel(m, mb) < TOL
    assert all(e[0] < TOL for e in fw.leaf_errs(got, base).values())


@pytest.mark.parametrize("order", ["rows reversed", "rows rolled",
                                   "two microbatches (--accum 2)"])
def test_other_float_orders_are_the_same_step(setup, order):
    cfg, ocfg, base, mb = setup
    got, m = fw.run_steps(cfg, ocfg, CPU, order)
    assert all(x.dtype == torch.float32 for k, x in got.items()
               if k != "opt/step")
    assert _rel(m, mb) < TOL
    assert all(e[0] < TOL for e in fw.leaf_errs(got, base).values())


def test_leaf_errs_cuts_the_want_side(setup):
    _, _, base, _ = setup
    key = "params/embed"
    half = {key: base[key][:7].clone()}
    half[key][0, 0] += 1.0
    e = fw.leaf_errs(half, {key: base[key]}, lambda k, x: x[:7])
    assert e["params"][1] == key
    assert e["params"][0] == pytest.approx(
        1.0 / float(base[key].abs().max()), rel=1e-5)


def test_gradient_report_holds_float32_to_float64(setup, capsys):
    cfg, ocfg, _, _ = setup
    fw.gradient_report(cfg, ocfg, CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("#   ")]
    assert len(lines) == 18       # 9 ways x rows 0:4 and 4:8 on the CPU
    for ln in lines:
        rel = float(ln.split("(rel ")[1].split(")")[0])
        assert rel < 1e-5, ln

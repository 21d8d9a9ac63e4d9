"""Import hygiene of the PyTorch port: no JAX, no reference package.

Every file of ``src/repro_torch/`` and ``chip_smoke.py`` is parsed with
``ast`` and must not import ``jax``, ``jaxlib`` or ``repro`` (the JAX
package; ``repro_torch`` itself is fine). The package must also import,
module by module, in a fresh interpreter where ``jax`` cannot be
imported at all.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _banned_imports(path: Path) -> list:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names if n.split(".")[0] in BANNED]
    return bad


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert path.exists(), path
    assert _banned_imports(path) == []


def test_package_imports_without_jax():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
            "               for k in loaded)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_training_modules_are_covered():
    """The training slice's modules are among those both checks walk."""
    mods = set(_modules())
    for name in ("repro_torch.training", "repro_torch.training.checkpoint",
                 "repro_torch.training.compression",
                 "repro_torch.training.fault_tolerance",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.train_loop",
                 "repro_torch.training.tree", "repro_torch.launch.train"):
        assert name in mods, name
    srcs = {p.relative_to(PKG).as_posix() for p in _sources()
            if PKG in p.parents}
    assert {"training/optimizer.py", "launch/train.py"} <= srcs


def test_engine_modules_are_covered():
    """The serving engine and the server over it are among the modules
    both checks walk."""
    mods = set(_modules())
    assert {"repro_torch.core.engine", "repro_torch.core.monitor"} <= mods
    srcs = {p.relative_to(PKG).as_posix() for p in _sources()
            if PKG in p.parents}
    assert "core/engine.py" in srcs

"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode=arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, at first use, under ``kernels/build/`` (ignored
by git). Library names carry a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all`` starts
one ``nvcc`` per source at once and waits for all of them.

Launchers take device pointers and PyTorch's current stream as Python ints
(``ctypes.c_void_p``), launch without synchronising, and return the
launch's ``cudaError_t``; ``Kernel.__call__`` raises on anything but 0.
Every launch adds one to ``Kernel.launches`` — the count a run reads to
show the serving path went through the kernel.

Nothing here runs at import: the CPU-only tests import every module and
never reach ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels; "
                       "set CUDA_HOME or put nvcc on PATH)")


class Kernel:
    """One CUDA source, its shared library, and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in sorted(CSRC.iterdir()):
            if p.suffix in (".cu", ".cuh"):
                h.update(p.name.encode())
                h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path) -> list:
        return [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(out),
                str(self.source)]

    def log_path(self) -> Path:
        return self.library_path().with_suffix(".log")

    def lib(self):
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                path = self.library_path()
                if not path.exists():
                    build_all([self])
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def __call__(self, *args) -> None:
        err = getattr(self.lib(), self.symbol)(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError_t {err}")
        self.launches += 1


def build_all(kernels: Sequence[Kernel] | None = None) -> dict:
    """Compile every missing library at once (one ``nvcc`` per source).

    Returns ``{name: library path}``; raises with the compiler's output if
    any build fails. Each build writes to a temporary name and is renamed
    into place, so a concurrent reader never loads a half-written library.
    """
    kernels = list(kernels if kernels is not None else KERNELS.values())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        procs.append((k, out, tmp, subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failures = []
    for k, out, tmp, p in procs:
        log, _ = p.communicate()
        k.log_path().write_text(log)
        if p.returncode != 0:
            failures.append(f"--- {k.name} (nvcc exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {k.name: k.library_path() for k in kernels}


KERNELS = {
    "traverse_fused": Kernel(
        "traverse_fused", "traverse_fused_launch",
        [_P, _I, _P, _P, ctypes.POINTER(_I), _I, _P, _P, _I, _I, _P, _P],
        "src/repro/kernels/traverse_fused.py:495"),
    "leaf_refine": Kernel(
        "leaf_refine", "leaf_refine_launch",
        [_P, _P, _I, _P, _P, _I, _I, _P, _P],
        "src/repro/kernels/leaf_refine.py:66"),
    "mlp_predict_compact": Kernel(
        "mlp_predict_compact", "mlp_predict_compact_launch",
        [_P] * 9 + [_I] * 7 + [_F, _P, _P, _P],
        "src/repro/kernels/mlp_infer.py:223"),
    "forest_infer": Kernel(
        "forest_infer", "forest_infer_launch",
        [_P, _P, _P, _I, _I, _I, _I, _P, _P],
        "src/repro/kernels/forest_infer.py:112"),
    "spatial_key": Kernel(
        "spatial_key", "spatial_key_launch",
        [_P, _I, _I, _I, _P, _P],
        "src/repro/kernels/spatial_key.py:93"),
    "traverse_compact": Kernel(
        "traverse_compact", "traverse_compact_launch",
        [_P, _I, _P, _P, ctypes.POINTER(_I), _I, _P, _P, _I, _I, _P, _P, _P],
        "src/repro/kernels/traverse_fused.py:554"),
    "knn_browse": Kernel(
        "knn_browse", "knn_browse_launch",
        [_P, _P, _I, _P, _P, _I, _I, _P, _P],
        "src/repro/kernels/knn_browse.py:96"),
    "delta_probe": Kernel(
        "delta_probe", "delta_probe_launch",
        [_P, _I, _P, _I, _I, _P, _P, _P],
        "src/repro/kernels/delta_probe.py:123"),
    "mbr_intersect": Kernel(
        "mbr_intersect", "mbr_intersect_launch",
        [_P, _I, _P, _I, _P, _P],
        "src/repro/kernels/mbr_intersect.py:42"),
    "traverse_fused_sliced": Kernel(
        "traverse_fused_sliced", "traverse_fused_sliced_launch",
        [_P, _I, _P, _P, ctypes.POINTER(_I), _I, _P, ctypes.POINTER(_I),
         _I, _I, _P, _P, _I, _P, _P],
        "src/repro/kernels/traverse_fused.py:834"),
    "traverse_compact_sliced": Kernel(
        "traverse_compact_sliced", "traverse_compact_sliced_launch",
        [_P, _I, _P, _P, ctypes.POINTER(_I), _I, _P, ctypes.POINTER(_I),
         _I, _I, _P, _P, _I, _I, _P, _P, _P],
        "src/repro/kernels/traverse_fused.py:886"),
    "forest_infer_cells": Kernel(
        "forest_infer_cells", "forest_infer_cells_launch",
        [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
        "src/repro/kernels/forest_infer.py:85"),
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0

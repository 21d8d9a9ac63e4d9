"""PyTorch/CUDA port of the AI+R-tree serving system.

``repro_torch`` mirrors the layout of the JAX package ``repro``
(``core/``, ``core/classifiers/``, ``kernels/``, ``data/``, ``launch/``)
and imports neither JAX nor ``repro``: host numpy code is copied, device
code is PyTorch, and every TPU kernel on the ported path is a CUDA kernel
written by hand for Hopper (``kernels/csrc``).

The device decides what runs: tensors on ``cpu`` take each kernel's plain
PyTorch version, tensors on ``cuda`` always launch the kernel (a kernel
that fails to build or launch raises). Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Validate ``device`` and set the float32 policy on first CUDA use.

    ``cuda`` without a card raises: there is no CPU fallback. TF32 stays
    off for both matmuls and cuDNN, so float32 work is float32 on the card
    as on the host. ``meta`` (shapes and dtypes with no storage, as
    ``launch/specs.py`` builds them) is taken as it is.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (pass device='cpu' to run on "
                               "the host)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev

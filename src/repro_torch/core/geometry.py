"""Rectangle algebra used across the AI+R-tree core.

Rectangles are ``(xmin, ymin, xmax, ymax)`` arrays. Two parallel
implementations are provided on purpose:

* ``np_*`` — numpy, used by the host-side R-tree builder / label prep.
* ``torch_*`` — PyTorch, used by the device-side traversal / serving code.

Touching intersections count as intersections (closed rectangles), matching
the classical R-tree definition and the paper's range-query semantics: every
test is inclusive (``<=`` / ``>=``) on both axes.
"""
from __future__ import annotations

import numpy as np
import torch

# Axis indices for readability.
XMIN, YMIN, XMAX, YMAX = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# numpy twins (host side)
# ---------------------------------------------------------------------------

def np_intersects(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise rect-intersection mask.

    ``a``: [..., 4], ``b``: [..., 4] broadcastable against each other.
    """
    return (
        (a[..., XMIN] <= b[..., XMAX])
        & (b[..., XMIN] <= a[..., XMAX])
        & (a[..., YMIN] <= b[..., YMAX])
        & (b[..., YMIN] <= a[..., YMAX])
    )


def np_cross_intersects(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """All-pairs intersection mask. ``a``: [A, 4], ``b``: [B, 4] → [A, B]."""
    return np_intersects(a[:, None, :], b[None, :, :])


def np_contains_point(rect: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """``rect``: [..., 4], ``pts``: [..., 2] broadcastable → bool mask."""
    return (
        (pts[..., 0] >= rect[..., XMIN])
        & (pts[..., 0] <= rect[..., XMAX])
        & (pts[..., 1] >= rect[..., YMIN])
        & (pts[..., 1] <= rect[..., YMAX])
    )


def np_area(rect: np.ndarray) -> np.ndarray:
    return np.maximum(rect[..., XMAX] - rect[..., XMIN], 0.0) * np.maximum(
        rect[..., YMAX] - rect[..., YMIN], 0.0
    )


def np_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """MBR of the union of two rects (broadcasting)."""
    lo = np.minimum(a[..., :2], b[..., :2])
    hi = np.maximum(a[..., 2:], b[..., 2:])
    return np.concatenate([lo, hi], axis=-1)


def np_enlargement(mbr: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """Area growth of ``mbr`` if enlarged to include ``rect`` (broadcasting)."""
    return np_area(np_union(mbr, rect)) - np_area(mbr)


def np_mbr_of_points(pts: np.ndarray) -> np.ndarray:
    """[N, 2] → [4] MBR."""
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    return np.concatenate([lo, hi])


def np_mbr_of_rects(rects: np.ndarray) -> np.ndarray:
    """[N, 4] → [4] MBR."""
    lo = rects[:, :2].min(axis=0)
    hi = rects[:, 2:].max(axis=0)
    return np.concatenate([lo, hi])


# ---------------------------------------------------------------------------
# torch twins (device side)
# ---------------------------------------------------------------------------

def torch_intersects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (
        (a[..., XMIN] <= b[..., XMAX])
        & (b[..., XMIN] <= a[..., XMAX])
        & (a[..., YMIN] <= b[..., YMAX])
        & (b[..., YMIN] <= a[..., YMAX])
    )


def torch_cross_intersects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, 4] × [B, 4] → [A, B] bool."""
    return torch_intersects(a[:, None, :], b[None, :, :])


def torch_contains_point(rect: torch.Tensor, pts: torch.Tensor
                         ) -> torch.Tensor:
    return (
        (pts[..., 0] >= rect[..., XMIN])
        & (pts[..., 0] <= rect[..., XMAX])
        & (pts[..., 1] >= rect[..., YMIN])
        & (pts[..., 1] <= rect[..., YMAX])
    )

"""Camera geometry (counterpart of `depthmodelhardening_tpu/ops/geometry.py`)."""

from __future__ import annotations


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth), layers.py:16-25:
    depth = 1 / (1/max + (1/min - 1/max) * disp)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp

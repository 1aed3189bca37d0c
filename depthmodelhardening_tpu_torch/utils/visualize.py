"""Depth visualization helpers.

Counterpart of `depthmodelhardening_tpu/utils/visualize.py`:

  * eval_depth_diff (my_utils.py:43-73): a 6-panel figure of two scenes,
    their disparities (magma, vmax = 95th percentile of disp1), the
    absolute disparity difference at fixed and at auto scale;
  * normalize_image (monodepth2/utils.py:27-32): per-image min/max
    normalization for logging;
  * colormap_disp (test_simple.py:140-150): a colormapped disparity;
  * save_pic (my_utils.py:128-137): float [0, 1] HWC -> PNG.

The arrays are numpy on the host; `eval_depth_diff` runs the port's
`DepthPredictor` (or `EvalView`) on its device where a disparity is not
given. The panel needs matplotlib and PIL, the PNG writer PIL; each is
imported where it is used and raises ImportError naming it where it is
not installed. `colormap_disp` falls back to grey without matplotlib,
as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..native import require_pil


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1] per image (monodepth2/utils.py:27-32)."""
    ma, mi = float(np.max(x)), float(np.min(x))
    return (x - mi) / (ma - mi if ma != mi else 1e5)


def colormap_disp(disp: np.ndarray, vmax: Optional[float] = None
                  ) -> np.ndarray:
    """(H, W) disparity -> (H, W, 3) uint8 magma colormap
    (test_simple.py:140-150: vmax = 95th percentile)."""
    if vmax is None:
        vmax = float(np.percentile(disp, 95))
    dn = np.clip(disp / (vmax + 1e-9), 0.0, 1.0)
    try:
        import matplotlib.cm as cm
    except ImportError:
        return (np.stack([dn] * 3, -1) * 255).astype(np.uint8)
    return (cm.magma(dn)[..., :3] * 255).astype(np.uint8)


def _predict(predictor, img: np.ndarray) -> np.ndarray:
    """disp0 (H, W) of one (H, W, 3) image."""
    with torch.no_grad():
        x = torch.as_tensor(np.ascontiguousarray(img[None]),
                            dtype=torch.float32, device=predictor.device)
        return predictor(x)[0, ..., 0].float().cpu().numpy()


def eval_depth_diff(img1: np.ndarray, img2: np.ndarray,
                    predictor=None, filename: Optional[str] = None,
                    disp1: Optional[np.ndarray] = None,
                    disp2: Optional[np.ndarray] = None):
    """6-panel comparison figure (my_utils.py:43-73).

    img1/img2: (H, W, 3) float [0,1]. disp1/disp2: (H, W), computed
    with `predictor` when not given. Returns (PIL.Image, disp1, disp2);
    saves `temp_<filename>.png` when filename is set.
    """
    if disp1 is None:
        disp1 = _predict(predictor, img1)
    if disp2 is None:
        disp2 = _predict(predictor, img2)
    diff = np.abs(disp1 - disp2)
    vmax = float(np.percentile(disp1, 95))

    Image = require_pil("the depth comparison panel")
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the depth comparison panel needs matplotlib, "
                          "which is not installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(12, 7))
    panels = [
        (img1, "Image 1", None),
        (img2, "Image 2", None),
        (disp1, "Disparity 1", vmax),
        (disp2, "Disparity 2", vmax),
        (diff, "Disparity difference", vmax),
        (diff, "Disparity difference (scaled)", "auto"),
    ]
    for i, (data, title, v) in enumerate(panels):
        plt.subplot(3, 2, i + 1)
        if v is None:
            plt.imshow(data)
        elif v == "auto":
            plt.imshow(data, cmap="magma")
        else:
            plt.imshow(data, cmap="magma", vmin=0, vmax=v)
        plt.title(title)
        plt.axis("off")
    fig.canvas.draw()
    if filename is not None:
        plt.savefig(f"temp_{filename}.png")
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return Image.fromarray(buf), disp1, disp2


def save_pic(tensor_hwc: np.ndarray, path: str) -> None:
    """float [0,1] HWC -> PNG (my_utils.py:128-137)."""
    Image = require_pil("saving a picture")
    Image.fromarray(
        (np.clip(tensor_hwc, 0, 1) * 255).astype(np.uint8)).save(path)

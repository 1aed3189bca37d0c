"""Adversarial object (car) image preparation.

Counterpart of `depthmodelhardening_tpu/data/object_images.py`
(reference image_preprocess.py:18-65): resize the object PNG to width
300 preserving aspect, binarize the companion *_CarMask at 0.5, and
build the paint mask: a 0.5-filled "half mask" when the paint-mask id is
negative (process_car_img :51-65), else the binarized *_PaintMask<id>
file. Outputs are NHWC float arrays ready for the attack/EoT stack
((1,H,W,3) object in [0,1], (1,H,W,1) masks), the JAX package's bit for
bit (tests/test_torch_data.py).

The JAX package resizes with PIL's default resample. PIL returns a plain
copy of an image whose size is unchanged, so where PIL is not installed
an image (and its masks) already `output_w` wide is decoded through
`native/` and grey-converted with PIL's integer luma (ITU-R 601-2:
(19595 R + 38470 G + 7471 B + 2^15) >> 16), the same bytes; any other
width needs PIL's resample and raises ImportError naming it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .. import native

CAR_IMG_WIDTH = 300  # image_preprocess.py:11


def _grey(rgb: np.ndarray) -> np.ndarray:
    """PIL's convert("L") of (H, W, 3) uint8."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _resized(path: str, size_of, grey: bool = False) -> np.ndarray:
    """The image at `path` (RGB, or grey) resized by PIL's default
    resample to `size_of(w, h)` of its own (w, h): (h', w', 3) or (h', w')
    uint8. Without PIL the size must be unchanged (PIL's plain copy)."""
    Image = native._pil()
    if Image is not None:
        from PIL import ImageOps

        with open(path, "rb") as f:
            img = Image.open(f)
            img = ImageOps.grayscale(img) if grey else img.convert("RGB")
        return np.asarray(img.resize(size_of(*img.size)))
    img = native._decode_u8(path)
    h, w = img.shape[:2]
    if size_of(w, h) != (w, h):
        native.require_pil(f"resizing {path} from {w}x{h} to "
                           f"{size_of(w, h)[0]}x{size_of(w, h)[1]}")
    return _grey(img) if grey else img


def _load_mask(path: str, output_w: int, output_h: int) -> np.ndarray:
    if not os.path.exists(path):
        # missing mask -> whole image (image_preprocess.py:39-40)
        return np.ones((output_h, output_w), np.float32)
    m = _resized(path, lambda w, h: (output_w, output_h), grey=True)
    m = np.asarray(m, np.float32) / 255.0
    return (m > 0.5).astype(np.float32)


def process_car_img(img_path: str, paint_mask_no: str = "-2",
                    output_w: int = CAR_IMG_WIDTH
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (obj (1,H,W,3) float, car_mask (1,H,W,1),
    paint_mask (1,H,W,1)).

    paint_mask_no < 0 -> constant 0.5 "half mask"
    (image_preprocess.py:55-58); otherwise loads
    <name>_PaintMask<no><ext>.
    """
    base, ext = os.path.splitext(img_path)
    img = _resized(img_path,
                   lambda w, h: (output_w, int(output_w / w * h)))
    h, w = img.shape[:2]
    obj = np.asarray(img, np.float32)[None] / 255.0
    car_mask = _load_mask(base + "_CarMask" + ext, w, h)
    if int(paint_mask_no) < 0:
        paint_mask = np.full_like(car_mask, 0.5)
    else:
        paint_mask = _load_mask(base + "_PaintMask" + paint_mask_no + ext,
                                w, h)
    return obj, car_mask[None, ..., None], paint_mask[None, ..., None]

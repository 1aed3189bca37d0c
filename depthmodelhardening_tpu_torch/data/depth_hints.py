"""Fused-SGBM depth hints: precomputation and loading.

Counterpart of `depthmodelhardening_tpu/data/depth_hints.py` (reference
DepthNetworks/depth-hints/precompute_depth_hints.py:42-263). Twelve
OpenCV SGBM matchers (4 disparity counts x 3 block sizes) each give a
candidate depth map of a stereo pair (focal * baseline / disparity, the
baseline 0.1 in the normalised-intrinsics frame); the candidates are
fused per pixel by warping the other eye through each of them and
keeping the depth whose 0.85 SSIM + 0.15 L1 reprojection loss is lowest.

SGBM runs on the host (`cv2`, one image pair at a time) and so does the
PNG reading of `precompute_for_split` (PIL); both are imported inside the
functions that need them, and where they are not installed those
functions raise ImportError naming the module. The 12-way fusion runs on
a device (`fuse_depths`, the card by default): the reprojection warp,
the loss through kernel C, the argmin. Hints are saved as
`<save_path>/<sequence>/image_0{2,3}/<frame>.npy`, as the reference's,
so the dataset's paths stay the same (depth-hints/datasets/
mono_dataset.py:368-388).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.geometry import reproject_coords
from ..ops.losses import reprojection_loss
from ..ops.sampling import grid_sample

BASELINE = 0.1  # normalised-frame baseline (precompute_depth_hints.py:120)


def _import(module: str, what: str):
    try:
        return __import__(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {module!r} module, which is not "
                          "installed here; run it where it is") from e


def make_stereo_matchers():
    """The 12 SGBM matchers (precompute_depth_hints.py:42-62)."""
    cv2 = _import("cv2", "the SGBM step")
    matchers = []
    for block_size in (1, 2, 3):
        for num_disp in (64, 96, 128, 160):
            sad = 3
            matchers.append(cv2.StereoSGBM_create(
                preFilterCap=63, P1=sad * sad * 4, P2=sad * sad * 32,
                minDisparity=0, numDisparities=num_disp,
                uniquenessRatio=10, speckleWindowSize=100,
                speckleRange=16, blockSize=block_size))
    return matchers


def scaled_K(height: int, width: int):
    """Monodepth2's K at (height, width) and its pseudo-inverse, float32."""
    K = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    K[0] *= width
    K[1] *= height
    return K, np.linalg.pinv(K)


def compute_candidate_depths(base_image: np.ndarray,
                             lookup_image: np.ndarray, focal: float,
                             reverse: bool = False) -> np.ndarray:
    """(12, H, W) candidate depths from the SGBM disparities
    (precompute_depth_hints.py:127-152) of uint8 HWC images; `reverse`
    when the base image is the right eye."""
    if reverse:
        base_image = base_image[:, ::-1]
        lookup_image = lookup_image[:, ::-1]
    disps = []
    for matcher in make_stereo_matchers():
        disp = matcher.compute(base_image, lookup_image) / 16.0
        if reverse:
            disp = disp[:, ::-1]
        disps.append(disp)
    disps = np.stack(disps).astype(np.float32)
    return focal * BASELINE / (disps + 1e-7) * (disps > 0)


def fuse_candidates(depths, base, lookup, K, invK, T):
    """The per-pixel candidate with the lowest reprojection loss
    (precompute_depth_hints.py:246-253): depths (n, H, W, 1), base and
    lookup (n, H, W, 3), K, invK, T (n, 4, 4), all on one device. Returns
    (fused (H, W, 1), the losses (n, H, W, 1))."""
    grid = reproject_coords(depths, invK, K, T)
    losses = reprojection_loss(grid_sample(lookup, grid), base)
    best = torch.argmin(losses, dim=0)
    return torch.gather(depths, 0, best[None])[0], losses


def fuse_depths(depths: np.ndarray, base_image: np.ndarray,
                lookup_image: np.ndarray, T: np.ndarray, height: int,
                width: int, device=None) -> np.ndarray:
    """depths (n, H, W), images float [0, 1] HWC, T (4, 4) -> the fused
    (H, W) on the host; the fusion runs on `device` (default the card)."""
    dev = resolve_device(device)
    K, invK = scaled_K(height, width)
    n = depths.shape[0]
    rep = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(
        dev).expand((n,) + np.shape(a)).contiguous()
    fused, _ = fuse_candidates(
        torch.as_tensor(np.asarray(depths, np.float32)).to(dev)[..., None],
        rep(base_image), rep(lookup_image), rep(K), rep(invK), rep(T))
    return fused[..., 0].cpu().numpy()


def compute_depth_hint(base_image: np.ndarray, lookup_image: np.ndarray,
                       side: str = "l", height: int = 320,
                       width: int = 1024, device=None) -> np.ndarray:
    """The hint of one stereo pair: SGBM candidates on the host, the
    fusion on `device`. base / lookup: uint8 HWC at (height, width); side:
    which eye the base image is ("l" / "r"), the extrinsic's sign as the
    reference's (precompute_depth_hints.py:160-176: -baseline for the
    left)."""
    K, _ = scaled_K(height, width)
    depths = compute_candidate_depths(base_image, lookup_image,
                                      focal=float(K[0, 0]),
                                      reverse=side == "r")
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = (-1.0 if side == "l" else 1.0) * BASELINE
    return fuse_depths(depths, base_image.astype(np.float32) / 255.0,
                       lookup_image.astype(np.float32) / 255.0, T, height,
                       width, device)


def precompute_for_split(data_path: str, filenames: Sequence[str],
                         save_path: Optional[str] = None,
                         height: int = 320, width: int = 1024,
                         overwrite: bool = False, device=None) -> List[str]:
    """Hints of a split's lines ("<sequence> <frame> <side>"), saved as
    (1, H, W) float32 .npy (precompute_depth_hints.py:206-263). Returns
    the paths written."""
    Image = _import("PIL.Image", "reading the KITTI PNGs").Image
    save_path = save_path or os.path.join(data_path, "depth_hints")
    written = []
    for line in filenames:
        sequence, frame, side = line.split()
        cam = "image_02" if side == "l" else "image_03"
        other = "image_03" if side == "l" else "image_02"
        out_dir = os.path.join(save_path, sequence, cam)
        out_file = os.path.join(out_dir, f"{int(frame):010d}.npy")
        if not overwrite and os.path.isfile(out_file):
            continue

        def load(c):
            p = os.path.join(data_path, sequence, c, "data",
                             f"{int(frame):010d}.png")
            with open(p, "rb") as f:
                img = Image.open(f).convert("RGB")
            return np.asarray(img.resize((width, height), Image.LANCZOS))

        hint = compute_depth_hint(load(cam), load(other), side=side,
                                  height=height, width=width, device=device)
        os.makedirs(out_dir, exist_ok=True)
        np.save(out_file, hint[None].astype(np.float32))
        written.append(out_file)
    return written


def load_depth_hint(save_path: str, sequence: str, frame: int, side: str,
                    do_flip: bool = False) -> np.ndarray:
    """A hint as the dataset loads it (depth-hints/datasets/
    mono_dataset.py:368-388): (H, W) float32, flipped left-right when the
    item is."""
    cam = "image_02" if side == "l" else "image_03"
    hint = np.load(os.path.join(save_path, sequence, cam,
                                f"{frame:010d}.npy"))[0]
    if do_flip:
        hint = hint[:, ::-1]
    return hint.astype(np.float32)

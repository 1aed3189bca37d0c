"""KITTI-layout trees written from seeds, with standard-library PNGs.

No KITTI file can be shipped or fetched, so the data path's tests and
`chip_smoke.py` phase 15 write their own trees: a raw drive (both
cameras, the two calib files, velodyne scans), split lists, a KITTI
object tree and a car with its mask. numpy, zlib and the port's
synthetic fixtures only (no PIL, no jax), so the card's machine runs it
as it is.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

from depthmodelhardening_tpu_torch.data.synthetic import (
    make_car_object, make_scene,
)
from depthmodelhardening_tpu_torch.physics.calibration import (
    DEFAULT_P2, DEFAULT_R0, DEFAULT_V2C,
)

DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0001_sync"
COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def write_png(path: str, img: np.ndarray, level: int = 1) -> str:
    """An 8-bit PNG (row filter 0) of uint8 (H, W) grey or (H, W, C) with
    C in 1-4 (grey, grey + alpha, RGB, RGBA)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPES[c], 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))
    return path


def to_u8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8, rounded."""
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _row(name: str, values: np.ndarray) -> str:
    return name + ": " + " ".join(f"{v:.12e}" for v in values.ravel())


def write_calib(date_dir: str, h: int, w: int) -> None:
    """calib_cam_to_cam.txt and calib_velo_to_cam.txt of the default
    KITTI-object calibration (P2 for both colour cameras, its rows scaled
    from 375 x 1242 to (h, w) images; R0, V2C)."""
    os.makedirs(date_dir, exist_ok=True)
    P = DEFAULT_P2 * np.array([[w / 1242], [h / 375], [1.0]])
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\n")
        f.write(_row("R_rect_00", DEFAULT_R0) + "\n")
        for cam in ("02", "03"):
            f.write(_row(f"P_rect_{cam}", P) + "\n")
            f.write(f"S_rect_{cam}: {float(w):e} {float(h):e}\n")
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        f.write(_row("R", DEFAULT_V2C[:, :3]) + "\n")
        f.write(_row("T", DEFAULT_V2C[:, 3]) + "\n")


def velodyne_scan(n: int, seed: int) -> np.ndarray:
    """(n, 4) float32 points in front of the camera: a road plane 1.73 m
    below the scanner 4-60 m ahead, and a wall of points at 8-30 m."""
    rs = np.random.RandomState(seed)
    pts = np.zeros((n, 4), np.float32)
    road = n // 2
    pts[:road, 0] = rs.uniform(4.0, 60.0, road)
    pts[:road, 1] = rs.uniform(-12.0, 12.0, road)
    pts[:road, 2] = -1.73 + rs.uniform(-0.02, 0.02, road)
    pts[road:, 0] = rs.uniform(8.0, 30.0, n - road)
    pts[road:, 1] = rs.uniform(-10.0, 10.0, n - road)
    pts[road:, 2] = rs.uniform(-1.7, 1.5, n - road)
    pts[:, 3] = rs.uniform(0.0, 1.0, n)
    return pts


def write_raw_tree(root: str, frames: int, h: int, w: int, seed: int = 0,
                   velodyne: Sequence[int] = (), points: int = 4000
                   ) -> Tuple[str, str]:
    """A raw drive of `frames` indices x image_02/image_03 (make_scene;
    image_03 the left view shifted 12 columns), the calib files and
    velodyne scans at the indices `velodyne`. Returns (root, drive)."""
    drive = os.path.join(root, DRIVE)
    write_calib(os.path.join(root, DATE), h, w)
    for fr in range(frames):
        left = to_u8(make_scene(1, h, w, seed=seed + fr)[0])
        for cam, img in (("02", left), ("03", np.roll(left, 12, axis=1))):
            write_png(os.path.join(drive, f"image_{cam}", "data",
                                   f"{fr:010d}.png"), img)
    vdir = os.path.join(drive, "velodyne_points", "data")
    os.makedirs(vdir, exist_ok=True)
    for fr in velodyne:
        velodyne_scan(points, seed + 1000 + fr).tofile(
            os.path.join(vdir, f"{fr:010d}.bin"))
    return root, DRIVE


def write_split(split_dir: str, name: str, **modes: Sequence[str]) -> str:
    """<split_dir>/<name>/<mode>_files.txt for each mode=lines."""
    os.makedirs(os.path.join(split_dir, name), exist_ok=True)
    for mode, lines in modes.items():
        with open(os.path.join(split_dir, name, f"{mode}_files.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    return split_dir


def write_object_tree(root: str, n: int, h: int, w: int,
                      seed: int = 0) -> Sequence[str]:
    """n KITTI-object scenes (training/image_2, label_2, every other one
    with a car) listed in trainval.txt and test.txt. Returns the names."""
    names = [f"{i:06d}" for i in range(n)]
    for i, name in enumerate(names):
        write_png(os.path.join(root, "training", "image_2", f"{name}.png"),
                  to_u8(make_scene(1, h, w, seed=seed + i)[0]))
        os.makedirs(os.path.join(root, "training", "label_2"),
                    exist_ok=True)
        with open(os.path.join(root, "training", "label_2",
                               f"{name}.txt"), "w") as f:
            f.write("Car 0 0 0 1 2 3 4 1 2 3 4 5 6 7\n" if i % 2 == 0
                    else "Pedestrian 0 0 0 1 2 3 4 1 2 3 4 5 6 7\n")
    for lst in ("trainval.txt", "test.txt"):
        with open(os.path.join(root, lst), "w") as f:
            f.write("\n".join(names) + "\n")
    return names


def write_car(path: str, width: int, height: int, seed: int = 0) -> str:
    """make_car_object as <path> (RGB) and <base>_CarMask<ext> (grey)."""
    obj, mask = make_car_object(width, height, seed=seed)
    write_png(path, to_u8(obj[0]))
    base, ext = os.path.splitext(path)
    write_png(base + "_CarMask" + ext, to_u8(mask[0, ..., 0]))
    return path

"""KITTI raw-data dataset for self-supervised training and eigen eval.

A copy of `depthmodelhardening_tpu/data/kitti_raw.py` (the same items,
arrays and draws bit for bit, held by tests/test_torch_data.py);
reference MonoDataset/KITTIRAWDataset (DepthNetworks/monodepth2/datasets/
mono_dataset.py:33-375, kitti_dataset.py:14-85). The host path only
decodes PNGs (`native/`), resizes to the native working resolution and
stacks numpy batches; every other transform (pyramids, jitter, EoT
compositing) runs on the device (training/adv_synth.py,
training/selfsup.py), and `data/loader.py` moves the batches there.

Split-file format is the reference's ("<folder> <frame_index> <side>"
per line, splits/<name>/{train,val,test}_files.txt); pass `split_dir`
pointing at a Monodepth2-style splits tree.

Yielded training items carry native-resolution frames so the on-device
EoT compositor can place objects before the model-resolution resize
(mono_dataset.py:186-199 resizes to ori 1242x375 first for the same
reason). The 16-bit depth PNGs of the depth benchmark are read with PIL
(`KittiDepthDataset.get_depth`, `export_gt_depths(split=
"eigen_benchmark")`), which raise ImportError naming it where it is not
installed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..native import load_resized, require_pil
from .velodyne import generate_depth_map

ORI_H, ORI_W = 375, 1242

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}  # kitti_dataset.py:24

# Normalized intrinsics shared by all KITTI raw sequences
# (kitti_dataset.py:27-32).
NORM_K = np.array([[0.58, 0, 0.5, 0],
                   [0, 1.92, 0.5, 0],
                   [0, 0, 1, 0],
                   [0, 0, 0, 1]], dtype=np.float32)


def readlines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.rstrip() for ln in f.readlines() if ln.strip()]


@dataclasses.dataclass
class SplitLine:
    folder: str
    frame_index: int
    side: Optional[str]

    @classmethod
    def parse(cls, line: str) -> "SplitLine":
        items = line.split()
        folder = items[0]
        frame_index = int(items[1]) if len(items) >= 2 else 0
        side = items[2] if len(items) >= 3 else None
        return cls(folder, frame_index, side)


def load_image_resized(path: str, h: int, w: int) -> np.ndarray:
    """Fused decode + half-pixel resize (`native.load_resized`)."""
    return load_resized(path, h, w)


class KittiRawDataset:
    """Raw KITTI sequences addressed by eigen-style split lines.

    data_path layout (kitti_dataset.py:35-48):
      <data_path>/<folder>/image_0{2,3}/data/<frame:010d>.png
      <data_path>/<folder[:10]>/calib_*.txt
      <data_path>/<folder>/velodyne_points/data/<frame:010d>.bin
    """

    def __init__(self, data_path: str, filenames: Sequence[str],
                 frame_ids: Sequence[str] = ("0", "s"),
                 ori_h: int = ORI_H, ori_w: int = ORI_W,
                 img_ext: str = ".png"):
        self.data_path = data_path
        self.lines = [SplitLine.parse(ln) for ln in filenames]
        self.frame_ids = tuple(frame_ids)
        self.ori_h = ori_h
        self.ori_w = ori_w
        self.img_ext = img_ext

    def __len__(self) -> int:
        return len(self.lines)

    def image_path(self, folder: str, frame_index: int, side: str) -> str:
        fname = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder,
                            f"image_0{SIDE_MAP[side]}", "data", fname)

    def get_color(self, folder: str, frame_index: int,
                  side: str) -> np.ndarray:
        return load_image_resized(
            self.image_path(folder, frame_index, side),
            self.ori_h, self.ori_w)

    def get_depth(self, folder: str, frame_index: int,
                  side: str) -> np.ndarray:
        """Velodyne ground-truth depth at native image resolution
        (kitti_dataset.py:70-85)."""
        calib_dir = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder,
                            "velodyne_points", "data",
                            f"{frame_index:010d}.bin")
        depth = generate_depth_map(calib_dir, velo, SIDE_MAP[side])
        # nearest-neighbour resize to native working size
        # (kitti_dataset.py:79-82 uses skimage order=0)
        ys = (np.arange(self.ori_h) * depth.shape[0] / self.ori_h
              ).astype(int)
        xs = (np.arange(self.ori_w) * depth.shape[1] / self.ori_w
              ).astype(int)
        return depth[ys][:, xs].astype(np.float32)

    def get_item(self, index: int, rng: Optional[np.random.RandomState]
                 = None, is_train: bool = True,
                 load_depth: bool = False) -> Dict:
        """One training item: native-res *unflipped* frames + flags.

        Flip/jitter/compositing are on-device; the item only reports the
        sampled do_flip so the synthesizer and stereo_T agree
        (mono_dataset.py:296-329, 367-373).
        """
        rng = rng or np.random.RandomState()
        line = self.lines[index]
        do_flip = bool(is_train and rng.rand() > 0.5)
        side = line.side or "l"

        frames = {}
        for fid in self.frame_ids:
            if fid == "s":
                other = {"l": "r", "r": "l"}[side]
                frames[fid] = self.get_color(line.folder, line.frame_index,
                                             other)
            else:
                frames[fid] = self.get_color(
                    line.folder, line.frame_index + int(fid), side)

        item = {
            "frames": frames,
            "side_is_l": side == "l",
            "do_flip": do_flip,
        }
        if load_depth:
            item["depth_gt"] = self.get_depth(line.folder,
                                              line.frame_index, side)
        return item


class KittiOdomDataset(KittiRawDataset):
    """KITTI odometry benchmark layout (kitti_dataset.py:88-101):
    <data_path>/sequences/<seq:02d>/image_{2,3}/<frame:06d>.png, split
    lines carry the sequence number as the folder."""

    def image_path(self, folder: str, frame_index: int, side: str) -> str:
        fname = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(self.data_path,
                            f"sequences/{int(folder):02d}",
                            f"image_{SIDE_MAP[side]}", fname)

    def get_depth(self, folder: str, frame_index: int,
                  side: str) -> np.ndarray:
        raise NotImplementedError(
            "the odometry benchmark has no depth ground truth")


class KittiDepthDataset(KittiRawDataset):
    """KITTI depth-benchmark ground truth (kitti_dataset.py:104-134):
    raw-layout images + improved dense depth PNGs under
    <folder>/proj_depth/groundtruth/image_0{2,3}/<frame:010d>.png,
    16-bit, scale 1/256, nearest-resized to working resolution (PIL)."""

    def get_depth(self, folder: str, frame_index: int,
                  side: str) -> np.ndarray:
        Image = require_pil("reading the depth benchmark's 16-bit PNGs")
        path = os.path.join(
            self.data_path, folder,
            f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}",
            f"{frame_index:010d}.png")
        img = Image.open(path)
        # PIL size is (W, H); reference resizes to full_res_shape
        # (1242, 375) with NEAREST before the /256 scale
        img = img.resize((self.ori_w, self.ori_h), Image.NEAREST)
        return np.asarray(img).astype(np.float32) / 256.0


def collate(items: Sequence[Dict]) -> Dict:
    """Stack items into numpy batch arrays (`data/loader.py` moves them
    to the device)."""
    frames = {fid: np.stack([it["frames"][fid] for it in items])
              for fid in items[0]["frames"]}
    out = {
        "frames": frames,
        "side_is_l": np.array([it["side_is_l"] for it in items], bool),
        "do_flip": np.array([it["do_flip"] for it in items], bool),
    }
    if "depth_gt" in items[0]:
        out["depth_gt"] = np.stack([it["depth_gt"] for it in items])
    return out


def load_split(split_dir: str, split: str, mode: str = "train") \
        -> List[str]:
    """Read <split_dir>/<split>/<mode>_files.txt (trainer.py:158-161)."""
    return readlines(os.path.join(split_dir, split, f"{mode}_files.txt"))


def export_gt_depths(data_path: str, split_dir: str, split: str = "eigen"
                     ) -> str:
    """Export gt_depths.npz for a split's test files
    (export_gt_depth.py:25-62): velodyne projection (vel_depth=True) for
    "eigen", annotated proj_depth PNGs (PIL) for "eigen_benchmark"."""
    lines = load_split(split_dir, split, "test")
    gt_depths = []
    for line in lines:
        sp = SplitLine.parse(line)
        if split == "eigen":
            calib_dir = os.path.join(data_path, sp.folder.split("/")[0])
            velo = os.path.join(data_path, sp.folder,
                                "velodyne_points", "data",
                                f"{sp.frame_index:010d}.bin")
            gt = generate_depth_map(calib_dir, velo, 2, vel_depth=True)
        elif split == "eigen_benchmark":
            Image = require_pil("the eigen_benchmark ground truth")
            p = os.path.join(data_path, sp.folder, "proj_depth",
                             "groundtruth", "image_02",
                             f"{sp.frame_index:010d}.png")
            gt = np.asarray(Image.open(p)).astype(np.float32) / 256.0
        else:
            raise ValueError(split)
        gt_depths.append(gt.astype(np.float32))

    out = os.path.join(split_dir, split, "gt_depths.npz")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    return out

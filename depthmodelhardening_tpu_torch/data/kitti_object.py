"""KITTI object-detection scene loader (attack / distillation scenes).

A copy of `depthmodelhardening_tpu/data/kitti_object.py` (the same
scenes and batches bit for bit, held by tests/test_torch_data.py);
reference dataLoader.py:107-257 (KittiLoader): reads
<root>/training/image_2/<name>.png scenes listed in a split file (with
optional vehicle labels), center-bottom-crops to the working size and
scales by 1/256 (the reference's quirk: dataLoader.py:201, /256 not
/255). The scenes feed `evaluation/attack_eval.py:iter_eval_scenes` and
the trainers as numpy arrays, which the callers move to their device.

Also provides seperate_sets (dataLoader.py:22-73): builds balanced
vehicle/non-vehicle train/test lists from KITTI label_2 annotations.
"""

from __future__ import annotations

import os
import random
from typing import List, Tuple

import numpy as np

from ..native import load_image

VEHICLE_TYPES = ("Car", "Van", "Truck")


def read_path_files(root_dir: str, list_name: str) \
        -> List[Tuple[str, int]]:
    """dataLoader.py:76-88: '<name> <label>' or '<name>' lines ->
    (image path, label) with label defaulting to 1."""
    base = os.path.join(root_dir, "training", "image_2")
    out = []
    with open(os.path.join(root_dir, list_name), "r") as f:
        for line in f.readlines():
            items = line.split()
            if not items:
                continue
            name = items[0]
            label = int(items[1]) if len(items) == 2 else 1
            out.append((os.path.join(base, name + ".png"), label))
    return out


def seperate_sets(root_dir: str, fn: str, seed: int = 1234,
                  train_frac: float = 0.8) -> None:
    """Balanced vehicle/non-vehicle split generation (dataLoader.py:22-73).
    Writes vehicle_detection/{trainval_vehicle,trainval_no_vehicle,
    training,testing}.txt under root_dir."""
    with open(os.path.join(root_dir, fn)) as f:
        names = [n.rstrip() for n in f.readlines() if n.strip()]
    vehicle_fns, non_vehicle_fns = [], []
    for name in names:
        label_path = os.path.join(root_dir, "training", "label_2",
                                  name + ".txt")
        with open(label_path) as lf:
            has_vehicle = any(ln.split(" ")[0] in VEHICLE_TYPES
                              for ln in lf.readlines())
        (vehicle_fns if has_vehicle else non_vehicle_fns).append(name)

    sub = os.path.join(root_dir, "vehicle_detection")
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "trainval_vehicle.txt"), "w") as f:
        f.write("\n".join(vehicle_fns) + "\n")
    with open(os.path.join(sub, "trainval_no_vehicle.txt"), "w") as f:
        f.write("\n".join(non_vehicle_fns) + "\n")

    class_num = len(non_vehicle_fns)
    random.Random(seed).shuffle(vehicle_fns)
    pairs = [(n, 0) for n in non_vehicle_fns] + \
        [(n, 1) for n in vehicle_fns[:class_num]]
    random.Random(seed).shuffle(pairs)
    n_train = int(class_num * 2 * train_frac)
    for fname, rows in (("training.txt", pairs[:n_train]),
                        ("testing.txt", pairs[n_train:])):
        with open(os.path.join(sub, fname), "w") as f:
            for name, label in rows:
                f.write(f"{name} {label}\n")


def center_bottom_crop(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """dataLoader.py:180-190: crop width-centered, anchored to the
    bottom (the sky is cut, the road kept). Like PIL's crop, regions
    outside the image are zero-filled (smaller-than-target inputs pad
    instead of silently returning the wrong shape)."""
    H, W = img.shape[:2]
    left = (W - w) // 2
    top = H - h
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    src_y0, src_x0 = max(top, 0), max(left, 0)
    dst_y0, dst_x0 = max(-top, 0), max(-left, 0)
    ch = min(H - src_y0, h - dst_y0)
    cw = min(W - src_x0, w - dst_x0)
    out[dst_y0:dst_y0 + ch, dst_x0:dst_x0 + cw] = \
        img[src_y0:src_y0 + ch, src_x0:src_x0 + cw]
    return out


class KittiObjectScenes:
    """Iterable over KITTI object-detection scenes.

    size is (width, height) like the reference (dataLoader.py:137);
    callers wanting native-resolution attack scenes pass (1242, 375)
    (simple_adv_training.py:107 original_size).
    """

    def __init__(self, root_dir: str, mode: str = "train",
                 size: Tuple[int, int] = (1242, 375),
                 train_list: str = "vehicle_detection/training.txt",
                 val_list: str = "vehicle_detection/testing.txt",
                 data_limit: int = -1):
        self.root_dir = root_dir
        self.size = size
        list_name = train_list if mode == "train" else val_list
        self.filepaths = read_path_files(root_dir, list_name)
        self.data_limit = data_limit

    def __len__(self) -> int:
        if self.data_limit != -1:
            return self.data_limit
        return len(self.filepaths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.filepaths[idx]
        img = load_image(path)  # float32 [0,1] = u8/255
        w, h = self.size
        img = center_bottom_crop(img, h, w)
        # the reference divides uint8 by 256 (dataLoader.py:201)
        return img * (255.0 / 256.0), label

    def batches(self, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True):
        """Yield (scenes (B,H,W,3) float32, labels (B,)) numpy batches."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            if drop_last and len(idxs) < batch_size:
                return
            imgs, labels = zip(*(self[j] for j in idxs))
            yield np.stack(imgs), np.asarray(labels, np.int64)

"""KITTI split-list management (a copy of
`depthmodelhardening_tpu/data/splits.py`: the same files, held by
tests/test_torch_data.py).

The reference ships the standard Monodepth2 split lists as data files
(DepthNetworks/monodepth2/splits/{eigen,eigen_zhou,eigen_full,
eigen_benchmark,benchmark,odom}/*_files.txt, ~215k lines total). Those
lists are published artifacts of the upstream Monodepth2 repo
(github.com/nianticlabs/monodepth2), not derivable from KITTI itself
(the eigen family encodes Eigen et al.'s NIPS'14 frame selection plus
Zhou et al.'s static-frame filtering), so this framework does not
re-synthesize them: `fetch_splits` downloads them from the upstream
repo and `import_splits` copies them from any local Monodepth2-style
checkout. The odometry split IS derivable (sequences 00-08 train /
09-10 test over all frames) and `make_odom_split` generates it locally.

Every loader in this package takes an explicit `split_dir`
(kitti_raw.py `load_split`), so splits live wherever the user keeps
them — typically `<repo>/splits` after running one of the helpers.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Sequence

# split -> list files the upstream repo publishes
# (DepthNetworks/monodepth2/splits/*)
SPLIT_FILES: Dict[str, List[str]] = {
    "eigen": ["test_files.txt"],
    "eigen_benchmark": ["test_files.txt"],
    "eigen_full": ["train_files.txt", "val_files.txt"],
    "eigen_zhou": ["train_files.txt", "val_files.txt",
                   "test_files.txt"],
    "benchmark": ["train_files.txt", "val_files.txt",
                  "test_files.txt"],
    "odom": ["train_files.txt", "val_files.txt", "test_files_09.txt",
             "test_files_10.txt"],
}

UPSTREAM_RAW_BASE = ("https://raw.githubusercontent.com/nianticlabs/"
                     "monodepth2/master/splits")


def validate_split_lines(lines: Sequence[str], split: str) -> None:
    """Check the 'folder frame_index side' line format
    (kitti_dataset.py:45-56; odom uses 'sequence frame side' too)."""
    for ln in lines[:100]:
        parts = ln.split()
        if not parts:
            continue
        if len(parts) not in (1, 2, 3):
            raise ValueError(
                f"malformed split line in {split}: {ln!r}")
        if len(parts) >= 2 and not parts[1].lstrip("-").isdigit():
            raise ValueError(
                f"non-integer frame index in {split}: {ln!r}")


def import_splits(src_dir: str, dest_dir: str,
                  splits: Optional[Sequence[str]] = None) -> List[str]:
    """Copy split lists from a Monodepth2-style checkout (a directory
    containing eigen/, eigen_zhou/, ... subdirs). Returns the files
    copied."""
    copied = []
    requested = list(splits) if splits else list(SPLIT_FILES)
    unknown = [sp for sp in requested if sp not in SPLIT_FILES]
    if unknown:
        raise ValueError(
            f"unknown splits {unknown}; known: {list(SPLIT_FILES)}")
    for split in requested:
        src_sub = os.path.join(src_dir, split)
        if not os.path.isdir(src_sub):
            if splits:  # explicitly requested -> error, not skip
                raise FileNotFoundError(
                    f"requested split {split!r} not found under "
                    f"{src_dir}")
            continue
        os.makedirs(os.path.join(dest_dir, split), exist_ok=True)
        for fname in os.listdir(src_sub):
            if not fname.endswith(".txt"):
                continue
            src = os.path.join(src_sub, fname)
            with open(src) as f:
                validate_split_lines(f.read().splitlines(), split)
            dst = os.path.join(dest_dir, split, fname)
            shutil.copyfile(src, dst)
            copied.append(dst)
    if not copied:
        raise FileNotFoundError(
            f"no split subdirectories found under {src_dir}")
    return copied


def fetch_splits(dest_dir: str,
                 splits: Optional[Sequence[str]] = None,
                 base_url: str = UPSTREAM_RAW_BASE,
                 timeout: float = 60.0) -> List[str]:
    """Download the published split lists from the upstream Monodepth2
    repository (requires network access)."""
    from urllib.request import urlopen

    fetched = []
    requested = list(splits) if splits else list(SPLIT_FILES)
    unknown = [sp for sp in requested if sp not in SPLIT_FILES]
    if unknown:
        raise ValueError(
            f"unknown splits {unknown}; known: {list(SPLIT_FILES)}")
    for split in requested:
        os.makedirs(os.path.join(dest_dir, split), exist_ok=True)
        for fname in SPLIT_FILES[split]:
            url = f"{base_url}/{split}/{fname}"
            with urlopen(url, timeout=timeout) as r:
                text = r.read().decode()
            validate_split_lines(text.splitlines(), split)
            dst = os.path.join(dest_dir, split, fname)
            with open(dst, "w") as f:
                f.write(text)
            fetched.append(dst)
    return fetched


# KITTI odometry ground-truth color sequences: (sequence, n_frames).
# Frame counts are the published KITTI odometry benchmark lengths.
_ODOM_LENGTHS = {0: 4541, 1: 1101, 2: 4661, 3: 801, 4: 271, 5: 2761,
                 6: 1101, 7: 1101, 8: 4071, 9: 1591, 10: 1201}


def make_odom_split(dest_dir: str,
                    val_fraction: float = 0.1,
                    seed: int = 17) -> List[str]:
    """Generate the odometry split locally: sequences 00-08 shuffled
    into train/val (frames 1..n-2 so that -1/+1 neighbors exist, as the
    upstream lists do), sequences 09/10 as the two eval lists."""
    import random

    os.makedirs(os.path.join(dest_dir, "odom"), exist_ok=True)
    written = []

    trainval = []
    for seq in range(9):
        for i in range(1, _ODOM_LENGTHS[seq] - 1):
            trainval.append(f"{seq:02d} {i} l")
    rng = random.Random(seed)
    rng.shuffle(trainval)
    n_val = int(len(trainval) * val_fraction)
    for mode, lines in (("val", trainval[:n_val]),
                        ("train", trainval[n_val:])):
        path = os.path.join(dest_dir, "odom", f"{mode}_files.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        written.append(path)

    for seq in (9, 10):
        lines = [f"{seq:02d} {i} l"
                 for i in range(_ODOM_LENGTHS[seq])]
        path = os.path.join(dest_dir, "odom",
                            f"test_files_{seq:02d}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        written.append(path)
    return written

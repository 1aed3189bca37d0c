"""Training metrics logging.

A copy of `depthmodelhardening_tpu/utils/logging.py`: the reference's
tensorboardX SummaryWriter usage (simple_adv_training.py:28-29,
trainer.py:718-752) becomes a JSONL metrics stream (always) plus
TensorBoard scalars and images when tensorboardX is importable (it is
optional). JSONL is the source of truth: each line is
{"step": N, "wall": t, **scalars}. `log_image` writes a PNG through PIL,
or the array as .npy where PIL is not installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def sec_to_hm_str(t: float) -> str:
    """10239 -> '02h50m39s' (monodepth2/utils.py:41-49)."""
    s = int(t)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    return f"{h:02d}h{m:02d}m{s:02d}s"


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(os.path.join(log_dir, name))
        self.t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": int(step), "wall": time.time() - self.t0}
        row.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def log_time(self, step: int, batch_size: int, duration: float,
                 loss: float, total_steps: Optional[int] = None) -> str:
        """examples/s + ETA print (trainer.py:706-716)."""
        eps = batch_size / max(duration, 1e-9)
        elapsed = time.time() - self.t0
        msg = (f"step {step:>6} | examples/s: {eps:5.1f} | "
               f"loss: {loss:.5f} | elapsed: {sec_to_hm_str(elapsed)}")
        if total_steps:
            left = elapsed / max(step, 1) * (total_steps - step)
            msg += f" | eta: {sec_to_hm_str(left)}"
        print(msg, flush=True)
        return msg

    def log_image(self, step: int, tag: str, image) -> str:
        """Eval-image logging (simple_adv_training.py:88-93 writer
        add_image): PNG under <log_dir>/images (always) + TensorBoard
        add_image when available. image: (H,W,3) or (H,W) float [0,1]
        or uint8."""
        import numpy as np

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        safe = tag.replace("/", "_")
        path = os.path.join(img_dir, f"{safe}_{int(step):08d}.png")
        try:
            from PIL import Image
        except ImportError:
            path = path.replace(".png", ".npy")
            np.save(path, arr)
        else:
            Image.fromarray(arr).save(path)
        if self._tb is not None:
            self._tb.add_image(tag, arr, int(step),
                               dataformats="HWC")
        return path

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

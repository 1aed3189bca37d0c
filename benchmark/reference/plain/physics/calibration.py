"""KITTI calibration parsing + coordinate transforms (host-side numpy).

A copy of `depthmodelhardening_tpu/physics/calibration.py`: the default
calibration (whose camera-2 projection P2 places the EoT quad), the calib
file reader and the velodyne / reference camera / rectified camera /
image transforms that the loaders (`data/pseudo_lidar.py`) call. Held
array-equal to it by tests/test_torch_package.py and
tests/test_torch_data.py. Reference: preprocessing/kitti_util.py:24-185.

Coordinate frames:
  velodyne: front x, left y, up z
  ref/rect camera: right x, down y, front z
  image2: u right, v down
  y_image2 = P2 @ R0_rect @ Tr_velo_to_cam @ x_velo
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Canonical KITTI-object calibration constants (cam 2), used when no calib
# file is available (physicalTrans.py:208-213, frame 003086-style P2).
DEFAULT_P2 = np.array([
    [721.5377, 0.0, 609.5593, 44.85728],
    [0.0, 721.5377, 172.854, 0.2163791],
    [0.0, 0.0, 1.0, 0.002745884],
], dtype=np.float64)

DEFAULT_R0 = np.eye(3, dtype=np.float64)

DEFAULT_V2C = np.array([
    [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
    [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
    [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
], dtype=np.float64)


def _inverse_rigid(Tr: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R|t] rigid transform."""
    inv = np.zeros_like(Tr)
    inv[:3, :3] = Tr[:3, :3].T
    inv[:3, 3] = -Tr[:3, :3].T @ Tr[:3, 3]
    return inv


def read_calib_file(path: str) -> dict:
    """Parse a KITTI calib txt ("KEY: v v v ..." lines) into arrays."""
    data = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                continue
    return data


@dataclasses.dataclass
class Calibration:
    """KITTI calibration bundle with the transforms the pipeline uses."""

    P: np.ndarray  # (3, 4) rect -> image2
    V2C: np.ndarray  # (3, 4) velo -> ref cam
    R0: np.ndarray  # (3, 3) ref -> rect

    @classmethod
    def from_file(cls, path: str) -> "Calibration":
        d = read_calib_file(path)
        return cls(P=d["P2"].reshape(3, 4),
                   V2C=d["Tr_velo_to_cam"].reshape(3, 4),
                   R0=d["R0_rect"].reshape(3, 3))

    @classmethod
    def default(cls) -> "Calibration":
        return cls(P=DEFAULT_P2.copy(), V2C=DEFAULT_V2C.copy(),
                   R0=DEFAULT_R0.copy())

    # -- intrinsics accessors ------------------------------------------------
    @property
    def f_u(self):
        return self.P[0, 0]

    @property
    def f_v(self):
        return self.P[1, 1]

    @property
    def c_u(self):
        return self.P[0, 2]

    @property
    def c_v(self):
        return self.P[1, 2]

    @property
    def b_x(self):
        return self.P[0, 3] / (-self.f_u)

    @property
    def b_y(self):
        return self.P[1, 3] / (-self.f_v)

    @property
    def C2V(self):
        return _inverse_rigid(self.V2C)

    # -- transforms ----------------------------------------------------------
    @staticmethod
    def _hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack([pts, np.ones((pts.shape[0], 1))])

    def velo_to_ref(self, pts):
        return self._hom(pts) @ self.V2C.T

    def ref_to_velo(self, pts):
        return self._hom(pts) @ self.C2V.T

    def ref_to_rect(self, pts):
        return pts @ self.R0.T

    def rect_to_ref(self, pts):
        return pts @ np.linalg.inv(self.R0).T

    def velo_to_rect(self, pts):
        return self.ref_to_rect(self.velo_to_ref(pts))

    def rect_to_velo(self, pts):
        return self.ref_to_velo(self.rect_to_ref(pts))

    def rect_to_image(self, pts):
        """(N, 3) rect-camera points -> (N, 2) image2 pixels."""
        p = self._hom(pts) @ self.P.T
        return p[:, :2] / p[:, 2:3]

    def velo_to_image(self, pts):
        return self.rect_to_image(self.velo_to_rect(pts))

    def image_to_rect(self, uv_depth):
        """(N, 3) [u, v, depth] -> (N, 3) rect points."""
        d = uv_depth[:, 2]
        x = (uv_depth[:, 0] - self.c_u) * d / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * d / self.f_v + self.b_y
        return np.stack([x, y, d], axis=1)

    def image_to_velo(self, uv_depth):
        return self.rect_to_velo(self.image_to_rect(uv_depth))

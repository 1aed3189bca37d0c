"""KITTI calibration (host-side numpy).

A copy of the part of `depthmodelhardening_tpu/physics/calibration.py`
the attack path reads (the default calibration, whose camera-2
projection P2 places the EoT quad); reading calib files waits for the
KITTI loaders (ROADMAP Queue 1, slice 6). Held
array-equal to it by tests/test_torch_package.py. Reference:
preprocessing/kitti_util.py:24-185.
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


@dataclasses.dataclass
class Calibration:
    """KITTI calibration bundle."""

    P: np.ndarray  # (3, 4) rect -> image2
    V2C: np.ndarray  # (3, 4) velo -> ref cam
    R0: np.ndarray  # (3, 3) ref -> rect

    @classmethod
    def default(cls) -> "Calibration":
        return cls(P=DEFAULT_P2.copy(), V2C=DEFAULT_V2C.copy(),
                   R0=DEFAULT_R0.copy())

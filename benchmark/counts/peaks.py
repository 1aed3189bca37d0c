"""The card's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit) and the least time a piece of work could take on it.

Copied from `chip_smoke.py:414-415` (`PEAK_*`), `:626-641` (`nbytes`,
`bound`) and `:1069` (`bound_bf16`). float32 matrix work counts at the
tensor cores' TF32 rate over 3: the 3xTF32 split is the fastest
float32-accurate route the port uses, so a float32 kernel moved onto the
tensor cores can never read above its peak.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_F32_S = 67e12  # float32 on the CUDA cores
PEAK_TF32_S = 495e12
PEAK_F32_MATMUL_S = PEAK_TF32_S / 3
PEAK_BF16_S = 989e12

ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def matmul_peak(dtype: str) -> float:
    """FLOP/s of dense matrix work in `dtype` at its fastest accurate
    route."""
    return PEAK_BF16_S if dtype in ("bfloat16", "float16") \
        else PEAK_F32_MATMUL_S


def nbytes(*described) -> int:
    """Bytes of tensors given as (shape, dtype) descriptions; None is
    nothing."""
    return sum(math.prod(shape) * ELEMENT_BYTES[dtype]
               for d in described if d is not None
               for shape, dtype in [d])


def least_seconds(nbytes_: float, flops: float, peak_flops: float) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    `peak_flops`."""
    return max(nbytes_ / PEAK_BYTES_S, flops / peak_flops)

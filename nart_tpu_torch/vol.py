""".vol density-grid parsing.

Counterpart of ``nart_tpu/vol.py``'s pure-Python loader (reference
src/core/scene.cpp:825-867): boundsMin.xyz boundsMax.xyz resX resY resZ
density[resX*resY*resZ], stored as a (Z, Y, X) C-order array.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class VolGrid:
    bounds_min: np.ndarray  # (3,)
    bounds_max: np.ndarray  # (3,)
    density: np.ndarray  # (Z, Y, X) float32


def load_vol(path: str) -> VolGrid:
    nums = np.fromfile(path, dtype=np.float64, sep=" ")
    if nums.size < 9:
        raise ValueError(f"volume file {path} could not be read")
    rx, ry, rz = (int(v) for v in nums[6:9])
    vals = nums[9 : 9 + rx * ry * rz]
    if vals.size != rx * ry * rz:
        raise ValueError(f"volume file {path} truncated")
    return VolGrid(
        bounds_min=nums[0:3].astype(np.float32),
        bounds_max=nums[3:6].astype(np.float32),
        density=vals.astype(np.float32).reshape(rz, ry, rx),
    )

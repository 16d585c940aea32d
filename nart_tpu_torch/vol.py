""".vol density-grid parsing.

Counterpart of ``nart_tpu/vol.py``'s pure-Python loader (reference
src/core/scene.cpp:825-867): boundsMin.xyz boundsMax.xyz resX resY resZ
density[resX*resY*resZ], stored as a (Z, Y, X) C-order array.

``load_vol`` parses with the port's C++ core (native.vol_load);
``load_vol_plain`` is its numpy version, the tests' plain reference, with
the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native


@dataclass
class VolGrid:
    bounds_min: np.ndarray  # (3,)
    bounds_max: np.ndarray  # (3,)
    density: np.ndarray  # (Z, Y, X) float32


def load_vol(path: str) -> VolGrid:
    """The density grid of a .vol file, by the C++ core.  Raises ValueError
    on a malformed file."""
    return VolGrid(*native.vol_load(path))


def load_vol_plain(path: str) -> VolGrid:
    """load_vol's numpy version."""
    nums = np.fromfile(path, dtype=np.float64, sep=" ")
    if nums.size < 9:
        raise ValueError(f"volume file {path} could not be read")
    if not all(0 <= v < 2.0 ** 31 for v in nums[6:9]):
        raise ValueError(f"volume file {path}: bad .vol resolution")
    rx, ry, rz = (int(v) for v in nums[6:9])
    vals = nums[9 : 9 + rx * ry * rz]
    if vals.size != rx * ry * rz:
        raise ValueError(f"volume file {path} truncated")
    return VolGrid(
        bounds_min=nums[0:3].astype(np.float32),
        bounds_max=nums[3:6].astype(np.float32),
        density=vals.astype(np.float32).reshape(rz, ry, rx),
    )

"""Pinhole camera ray generation.

Counterpart of ``nart_tpu/camera.py`` (reference
src/cameras/pinholecamera.cpp): "fov" is a half-angle in degrees, the aspect
ratio applies on x only, and the camera-space direction is normalised
before the world transform and not after.
"""

from __future__ import annotations

import numpy as np
import torch


def cast_rays(cam_to_world, fov_deg, width, height, px, py, image_sample):
    """World-space rays for pixel coords (px, py) + jitter.

    Args:
      cam_to_world: (4,4) row-major matrix A (points transform as A @ [p,1]).
      fov_deg: float half-angle in degrees.
      width, height: image dims used for the NDC mapping.
      px, py: (N,) integer pixel coords.
      image_sample: (N, 2) jitter in [0,1).
    Returns (o, d): (N,3) origins and directions.
    """
    a = cam_to_world
    tan_fov = float(np.float32(np.tan(np.radians(np.float32(fov_deg)))))
    aspect = float(np.float32(width / height))
    x = (((px.to(torch.float32) + image_sample[..., 0]) / float(width)) * 2.0
         - 1.0) * tan_fov * aspect
    y = (((py.to(torch.float32) + image_sample[..., 1]) / float(height)) * -2.0
         + 1.0) * tan_fov
    d_cam = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    o = a[:3, 3].expand(d_cam.shape).contiguous()
    d = d_cam @ a[:3, :3].T
    return o, d

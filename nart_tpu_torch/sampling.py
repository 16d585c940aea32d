"""Sampling warps and Latin-square image samples.

Counterpart of ``nart_tpu/sampling.py`` (reference src/core/sampling.cpp).
Samples are shaped (..., 2) or (...,) float32 tensors.
"""

from __future__ import annotations

import math

import torch

from . import rng

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
PI = math.pi


def uniform_sample_disk(u):
    """Polar warp with sqrt(r).  sampling.cpp:5-16."""
    r = torch.sqrt(u[..., 0])
    theta = u[..., 1] * TWO_PI
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def uniform_sample_ring(u, inner_ratio):
    """Annulus warp with the reference's formulas (sampling.cpp:18-31):
    r^2 mixes ``inner_ratio`` itself and pdf = 1/(pi*(1-inner_ratio)).
    Returns (xy, pdf)."""
    k = torch.as_tensor(inner_ratio, dtype=torch.float32, device=u.device)
    r = torch.sqrt(k + (1.0 - k) * u[..., 0])
    theta = u[..., 1] * TWO_PI
    xy = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    pdf = 1.0 / (PI * (1.0 - k))
    return xy, pdf.expand(u[..., 0].shape)


def uniform_sample_sphere(u):
    """sampling.cpp:33-45.  Returns (w, pdf=1/4pi)."""
    theta = torch.arccos(1.0 - 2.0 * u[..., 0])
    phi = u[..., 1] * TWO_PI
    sin_t = torch.sin(theta)
    w = torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )
    pdf = torch.full(u[..., 0].shape, 1.0 / (4.0 * math.pi),
                     dtype=torch.float32, device=u.device)
    return w, pdf


def cosine_sample_hemisphere(u):
    """Malley's method.  sampling.cpp:47-58.  Returns (w, pdf=z/pi)."""
    d = uniform_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    w = torch.cat([d, z[..., None]], dim=-1)
    return w, z * INV_PI


def sample_exponential_decay(u, a):
    """-ln(1-u)/a.  sampling.cpp:60-62."""
    return -torch.log(1.0 - u) / a


def latin_square(state, n_samples):
    """Latin-square stratified 2D image samples, one square per pixel lane.

    Parity: sampling.cpp:72-86 — stratified samples along the diagonal, then
    an independent Fisher-Yates shuffle of each dimension, consuming
    2*n_samples UniformFloat draws then 2*n_samples UniformInt32 draws from
    each lane's stream in reference order.

    Args:
      state: RNG states (P,) int64.
      n_samples: spp.
    Returns (samples (P, n_samples, 2) float32, updated states).
    """
    p = state.shape[0]
    inv_n = 1.0 / n_samples
    samples = torch.empty((p, n_samples, 2), dtype=torch.float32,
                          device=state.device)
    for i in range(n_samples):
        ux, state = rng.next_float(state)
        uy, state = rng.next_float(state)
        samples[:, i, 0] = (i + ux) * inv_n
        samples[:, i, 1] = (i + uy) * inv_n
    rows = torch.arange(p, device=state.device)
    for i in range(n_samples):
        for dim in (0, 1):
            choice, state = rng.next_int32(state, n_samples - 1 - i)
            col = samples[:, :, dim]
            si = col[:, i].clone()
            sc = col[rows, choice]
            col[rows, choice] = si
            col[:, i] = sc
    return samples, state

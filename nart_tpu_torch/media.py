"""Participating media: density grids, majorants, AABB clipping.

Counterpart of ``nart_tpu/media.py`` (reference src/core/media.cpp).  The
reference's MajorantGrid has width 1 (media.h:31-40): one global majorant
over the medium's box, so the majorant iterator gives one segment per ray.
"""

from __future__ import annotations

import functools

import torch

from .select import small_lut

_D_ZERO = 1e-30  # stands in for a zero direction component in the slab clip


@functools.lru_cache(maxsize=None)
def _cells_per_axis(grid_shape, device):
    """(X-1, Y-1, Z-1) as a float32 tensor on device, made once: a host
    list copied to the card at every flight step would stall the stream."""
    rz, ry, rx = grid_shape
    return torch.tensor([rx - 1.0, ry - 1.0, rz - 1.0], device=device)


def _grid_point(grid_shape, p_unit):
    """Cell corner (lo, (N, 3) int64 xyz) and fraction f of p in [0,1)^3."""
    scale = _cells_per_axis(tuple(grid_shape), p_unit.device)
    p = torch.clamp(p_unit, 0.0, 0.999) * scale
    lo = p.to(torch.int64)  # truncation, as astype(int32)
    return lo, p - lo.to(torch.float32)


def density_lookup(density, p_unit):
    """Trilinear lookup at p in [0,1)^3 with nested lerps.
    DensityGrid::LookUp (media.cpp:9-45).

    density: (Z, Y, X); p_unit: (N, 3) xyz order."""
    lo, f = _grid_point(density.shape, p_unit)
    hi = lo + 1
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]

    def at(ix, iy, iz):
        return density[iz, iy, ix]

    x0 = (at(lo[:, 0], lo[:, 1], lo[:, 2]) * (1 - fx)
          + at(hi[:, 0], lo[:, 1], lo[:, 2]) * fx)
    x1 = (at(lo[:, 0], lo[:, 1], hi[:, 2]) * (1 - fx)
          + at(hi[:, 0], lo[:, 1], hi[:, 2]) * fx)
    x2 = (at(lo[:, 0], hi[:, 1], lo[:, 2]) * (1 - fx)
          + at(hi[:, 0], hi[:, 1], lo[:, 2]) * fx)
    x3 = (at(lo[:, 0], hi[:, 1], hi[:, 2]) * (1 - fx)
          + at(hi[:, 0], hi[:, 1], hi[:, 2]) * fx)
    y0 = x0 * (1 - fy) + x2 * fy
    y1 = x1 * (1 - fy) + x3 * fy
    return y0 * (1 - fz) + y1 * fz


def pack_density_cells(density):
    """The grid's 2x2x2 cell corners as one (n_cells, 8) row table, so that
    a lookup is one 32-byte row gather.  Corner k holds
    d[z + (k>>2 & 1), y + (k>>1 & 1), x + (k & 1)]."""
    zs, ys, xs = density.shape
    rows = [density[kz:zs - 1 + kz, ky:ys - 1 + ky, kx:xs - 1 + kx]
            for kz in (0, 1) for ky in (0, 1) for kx in (0, 1)]
    return torch.stack(rows, dim=-1).reshape(-1, 8)


def cell_coords(grid_shape, p_unit):
    """(idx, f): the row of pack_density_cells' table that holds p's cell
    (not clamped) and p's fraction in it, xyz.  grid_shape is the density's
    own (Z, Y, X) shape."""
    rz, ry, rx = grid_shape
    lo, f = _grid_point(grid_shape, p_unit)
    return (lo[:, 2] * (ry - 1) + lo[:, 1]) * (rx - 1) + lo[:, 0], f


def cell_weights(f):
    """The 8 corner weights of fractions f, corner k's (wz * wy) * wx."""
    wx = (1.0 - f[:, 0], f[:, 0])
    wy = (1.0 - f[:, 1], f[:, 1])
    wz = (1.0 - f[:, 2], f[:, 2])
    return [wz[k >> 2 & 1] * wy[k >> 1 & 1] * wx[k & 1] for k in range(8)]


def density_lookup_cells(cells, grid_shape, p_unit, gather=None):
    """Trilinear lookup against pack_density_cells' table: the sum of the 8
    corner-weight products, taken left to right (the nested lerps of
    density_lookup differ by about an ulp).  grid_shape is the density's
    own (Z, Y, X) shape.  gather(idx, cells) -> (N, 8) rows replaces the
    look-up (idx clamped to the table): the float64 reference of the flight
    step's backward reads its rows through one (vol_ops)."""
    idx, f = cell_coords(grid_shape, p_unit)
    if gather is None:
        # (N, 8): the one gather, through the look-up kernels on the card
        row = small_lut(idx, cells.shape[0])(cells)
    else:
        row = gather(idx.clamp(0, cells.shape[0] - 1), cells)
    out = None
    for k, w in enumerate(cell_weights(f)):
        term = row[:, k] * w
        out = term if out is None else out + term
    return out


def _scaled(medium, inside, dens):
    return (inside, medium.sigma_a * dens, medium.sigma_s * dens,
            medium.le * dens[:, None])


def _unit(medium, p):
    bmin, bmax = medium.bounds_min, medium.bounds_max
    inside = torch.all((p >= bmin) & (p <= bmax), dim=-1)
    return inside, (p - bmin) / (bmax - bmin)


def medium_properties_cells(medium, cells, p, gather=None):
    """medium_properties with the packed-cell density table (gather: as
    for density_lookup_cells)."""
    inside, p_unit = _unit(medium, p)
    dens = density_lookup_cells(cells, medium.density.shape, p_unit, gather)
    return _scaled(medium, inside, dens)


def clip_to_aabb(o, d, bounds_min, bounds_max):
    """Medium::SampleRay's slab clip (media.cpp:281-324).

    Returns (hit, t_min, t_max); t_min may be negative when inside."""
    inv_d = 1.0 / torch.where(d == 0.0, _D_ZERO, d)
    t0 = (bounds_min - o) * inv_d
    t1 = (bounds_max - o) * inv_d
    t_min = torch.minimum(t0, t1).amax(-1)
    t_max = torch.maximum(t0, t1).amin(-1)
    return t_min <= t_max, t_min, t_max


def medium_properties(medium, p):
    """Medium::SampleMedium (media.cpp:264-279): (inside, sigma_a, sigma_s,
    le), all scaled by the density at p."""
    inside, p_unit = _unit(medium, p)
    return _scaled(medium, inside, density_lookup(medium.density, p_unit))

"""Watertight ray-triangle intersection over ray wavefronts.

Counterpart of ``nart_tpu/geometry.py`` (reference src/core/geometry.cpp:
3-115): the permute-and-shear watertight test with the same edge-function
sign logic, barycentrics, shading-normal/UV lerp and dpds/dpdt.  Rays are
(N, 3) tensors, triangles (T, 3, 3) world-space vertex stacks.  The chunked
brute-force intersector is the plain reference the cluster kernels are held
against.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

INF = math.inf
_NOISE = 2.0**-22


def edge_fn(ax, ay, bx, by):
    """2D edge function ax*by - ay*bx, robust to FMA contraction.

    Two triangles sharing an edge must compute exactly negated edge values
    so a ray through the edge is accepted by at least one of them
    (geometry.cpp:73-81).  A fused multiply-subtract leaves a rounding
    residue of inconsistent sign, so |e| below the products' noise floor
    snaps to exact zero: rays in that sliver hit both triangles."""
    p1 = ax * by
    p2 = ay * bx
    e = p1 - p2
    noise = (p1.abs() + p2.abs()) * _NOISE
    return torch.where(e.abs() <= noise, torch.zeros_like(e), e)


class RayShear(NamedTuple):
    """Watertight permutation constants (geometry.cpp:3-15)."""

    perm: torch.Tensor  # (N, 3) int64 — [minor0, minor1, major]
    sx: torch.Tensor  # (N,)
    sy: torch.Tensor  # (N,)
    sz: torch.Tensor  # (N,)


def major_axis(d):
    """C++ tie-breaking: x>y ? (x>z ? 0 : 2) : (y>z ? 1 : 2)."""
    ad = d.abs()
    two = torch.full_like(ad[..., 0], 2, dtype=torch.int64)
    return torch.where(
        ad[..., 0] > ad[..., 1],
        torch.where(ad[..., 0] > ad[..., 2], torch.zeros_like(two), two),
        torch.where(ad[..., 1] > ad[..., 2], torch.ones_like(two), two),
    )


def ray_shear(d) -> RayShear:
    major = major_axis(d)
    minor0 = (major + 1) % 3
    minor1 = (major + 2) % 3
    sz = 1.0 / d.gather(-1, major[..., None])[..., 0]
    sx = -d.gather(-1, minor0[..., None])[..., 0] * sz
    sy = -d.gather(-1, minor1[..., None])[..., 0] * sz
    return RayShear(perm=torch.stack([minor0, minor1, major], dim=-1),
                    sx=sx, sy=sy, sz=sz)


class Hit(NamedTuple):
    """Per-ray nearest-hit record (Intersection, geometry.h:29-51)."""

    t: torch.Tensor  # (N,) — inf when no hit
    tri: torch.Tensor  # (N,) int64 — triangle index (-1 = miss)
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)

    @property
    def valid(self):
        return self.tri >= 0


def watertight(o, d, shear, v0, v1, v2, n, v0n):
    """Watertight test of N rays against C triangles.

    v0, v1, v2, n: (C, 3) corners and unnormalised geometric normal; v0n:
    (C,) v0.n.  Returns (hit (N, C) bool without the t-window, t, e0, e1,
    esum), all (N, C)."""
    d_dot_n = d[:, 0:1] * n[None, :, 0] + d[:, 1:2] * n[None, :, 1] \
        + d[:, 2:3] * n[None, :, 2]
    o_dot_n = o[:, 0:1] * n[None, :, 0] + o[:, 1:2] * n[None, :, 1] \
        + o[:, 2:3] * n[None, :, 2]
    t = (v0n[None, :] - o_dot_n) / d_dot_n

    pa, pb, pc = shear.perm[:, 0], shear.perm[:, 1], shear.perm[:, 2]
    o_a = o.gather(1, pa[:, None])
    o_b = o.gather(1, pb[:, None])
    o_c = o.gather(1, pc[:, None])
    sx = shear.sx[:, None]
    sy = shear.sy[:, None]

    def corner_xy(vc):  # (C, 3) -> two (N, C): translated, permuted, sheared
        vt = vc.T
        ca = vt[pa] - o_a
        cb = vt[pb] - o_b
        cc = vt[pc] - o_c
        return ca + cc * sx, cb + cc * sy

    p0x, p0y = corner_xy(v0)
    p1x, p1y = corner_xy(v1)
    p2x, p2y = corner_xy(v2)
    e0 = edge_fn(p1x, p1y, p2x, p2y)
    e1 = edge_fn(p2x, p2y, p0x, p0y)
    e2 = edge_fn(p0x, p0y, p1x, p1y)
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    hit = ~(neg & pos) & (e0.abs() + e1.abs() + e2.abs() != 0.0)
    return hit, t, e0, e1, e0 + e1 + e2


def intersect_chunk(o, d, shear, t_min, t_best, tri_v):
    """Nearest hit of N rays over a chunk of C triangles, strictly closer
    than t_best.  Returns (t (N,), idx_in_chunk (N,), u, v); idx -1 when
    none.  Ties go to the lowest index (the reference's serial order)."""
    v0, v1, v2 = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    v0n = (v0 * n).sum(-1)
    hit, t, e0, e1, esum = watertight(o, d, shear, v0, v1, v2, n, v0n)
    hit = hit & (t > t_min[:, None]) & (t < t_best[:, None])
    return _select_nearest(hit, t, e0, e1, esum)


def _select_nearest(hit, t, e0, e1, esum):
    """Row-wise nearest hit of (N, C) candidates, lowest column on ties."""
    t_hit = torch.where(hit, t, torch.full_like(t, INF))
    best = torch.argmin(t_hit, dim=1, keepdim=True)  # first minimum
    t_sel = t_hit.gather(1, best)[:, 0]
    inv_det = 1.0 / esum.gather(1, best)[:, 0]
    u = e0.gather(1, best)[:, 0] * inv_det
    v = e1.gather(1, best)[:, 0] * inv_det
    idx = torch.where(torch.isfinite(t_sel), best[:, 0],
                      torch.full_like(best[:, 0], -1))
    return t_sel, idx, u, v


def intersect_brute(o, d, t_min, t_max, tri_v, chunk=512):
    """Nearest hit over all triangles (the plain reference intersector).

    Scans triangle chunks with a running best (strictly-closer updates, so
    the first triangle wins ties like the reference's serial loop)."""
    n = o.shape[0]
    shear = ray_shear(d)
    t_best = torch.clamp(t_max.expand(n).to(torch.float32), max=INF).clone()
    tri_best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    u_best = torch.zeros(n, device=o.device)
    v_best = torch.zeros(n, device=o.device)
    for base in range(0, tri_v.shape[0], chunk):
        t, idx, u, v = intersect_chunk(o, d, shear, t_min, t_best,
                                       tri_v[base : base + chunk])
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        tri_best = torch.where(better, base + idx, tri_best)
        u_best = torch.where(better, u, u_best)
        v_best = torch.where(better, v, v_best)
    t = torch.where(tri_best >= 0, t_best, torch.full_like(t_best, INF))
    return Hit(t=t, tri=tri_best, u=u_best, v=v_best)


class Surface(NamedTuple):
    """Surface record at a hit (Intersection fields, geometry.h:29-51)."""

    p: torch.Tensor  # (N, 3)
    gn: torch.Tensor  # (N, 3) normalised geometric normal
    sn: torch.Tensor  # (N, 3) lerped shading normal (NOT normalised — parity)
    st: torch.Tensor  # (N, 2) texture coords
    dpds: torch.Tensor  # (N, 3)
    dpdt: torch.Tensor  # (N, 3)
    mesh: torch.Tensor  # (N,) int64


def pack_surface_rows(tri_v, tri_n, tri_uv, tri_mesh):
    """Per-triangle surface attributes as one (T, 32) f32 row: v0 v1 v2 (9)
    | n0 n1 n2 (9) | uv0 uv1 uv2 (6) | mesh-as-f32 (1) | pad (7), so the
    per-hit fetch is one row gather."""
    t = tri_v.shape[0]
    return torch.cat(
        [
            tri_v.reshape(t, 9),
            tri_n.reshape(t, 9),
            tri_uv.reshape(t, 6),
            tri_mesh.to(torch.float32)[:, None],  # exact to 2^24
            torch.zeros((t, 7), dtype=torch.float32, device=tri_v.device),
        ],
        dim=-1,
    )


def surface_at_packed(hit: Hit, surf_rows) -> Surface:
    """Surface record from the packed (T, 32) rows: one gather."""
    r = surf_rows[hit.tri.clamp(min=0)]
    v = r[:, 0:9].reshape(-1, 3, 3)
    nrm = r[:, 9:18].reshape(-1, 3, 3)
    uv = r[:, 18:24].reshape(-1, 3, 2)
    mesh = r[:, 24].to(torch.int64)
    # geometry.cpp:88-113: p from barycentrics, sn/st lerp with weights
    # (u, v, 1-u-v), dpds/dpdt from the UV determinant
    u, w_v = hit.u[:, None], hit.v[:, None]
    w2 = 1.0 - u - w_v
    p = v[:, 0] * u + v[:, 1] * w_v + v[:, 2] * w2
    gn_raw = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    gn = gn_raw / torch.clamp(
        torch.linalg.vector_norm(gn_raw, dim=-1, keepdim=True), min=1e-30
    )
    sn = nrm[:, 0] * u + nrm[:, 1] * w_v + nrm[:, 2] * w2
    st = uv[:, 0] * u + uv[:, 1] * w_v + uv[:, 2] * w2

    uv0, uv1, uv2 = uv[:, 0], uv[:, 1], uv[:, 2]
    uv_det = (uv0[:, 0] - uv2[:, 0]) * (uv1[:, 1] - uv2[:, 1]) - (
        uv0[:, 1] - uv2[:, 1]
    ) * (uv1[:, 0] - uv2[:, 0])
    inv_uv_det = 1.0 / uv_det  # reference TODO: no 0-det guard (matched)
    dpds = (
        (v[:, 0] - v[:, 2]) * (uv1[:, 1] - uv2[:, 1])[:, None]
        + (v[:, 1] - v[:, 2]) * (uv2[:, 1] - uv0[:, 1])[:, None]
    ) * inv_uv_det[:, None]
    dpdt = (
        (v[:, 0] - v[:, 2]) * (uv2[:, 0] - uv1[:, 0])[:, None]
        + (v[:, 1] - v[:, 2]) * (uv0[:, 0] - uv2[:, 0])[:, None]
    ) * inv_uv_det[:, None]
    return Surface(p=p, gn=gn, sn=sn, st=st, dpds=dpds, dpdt=dpdt, mesh=mesh)

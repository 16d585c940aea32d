"""Lights: analytic disk/ring area lights, environment maps with CDF
importance sampling, distant lights, and packed area-light tables.

Counterpart of ``nart_tpu/lights.py`` (reference src/lights/*.cpp and
Piecewise2DDistribution, texturepattern.cpp:72-109).  Light functions take
one LightData record; per-lane light selection is done by the integrator.
The env sampler searches the CDFs directly (see env2d_sample).

Reference quirks preserved:
  * ring Sample_Li pdf = 1/(pi*(1-k)) / (pi*r^2)   [double-pi; k=inner/r]
    while ring Pdf()  = 1/(pi*(1-k^2)*r^2)          (ringlight.cpp:50,103)
  * env pdf jacobian 1/(4*pi*|sin theta|)           (environmentlight.cpp:25)
  * env tMax sentinel 2139095039.0 (int 0x7f7fffff as float)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .sampling import uniform_sample_disk, uniform_sample_ring
from .scene import (
    LIGHT_DISK,
    LIGHT_DISTANT,
    LIGHT_ENV,
    LIGHT_RING,
    Env2D,
    LightData,
)
from .select import small_lut

PI = math.pi
TWO_PI = 2.0 * math.pi
ENV_TMAX = 2139095039.0  # 0x7f7fffff as float (parity)
INF = math.inf


def _safe_div(a, b):
    ok = b != 0.0
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _f32(x):
    """Round a Python float to float32 (the JAX package's np.float32)."""
    return float(np.float32(x))


class LightEval(NamedTuple):
    le: torch.Tensor  # (N, 3) radiance (0 when pdf == 0)
    pdf: torch.Tensor  # (N,) solid-angle pdf
    t: torch.Tensor  # (N,) hit distance (inf when missed)


def _vec(v, like):
    """A float32 3-vector filled on like's device: a distant light's sample
    makes one every round, and a host-built one is a copy that synchronises
    the stream."""
    out = torch.zeros(3, device=like.device)
    for i, x in enumerate(v):
        out[i:i + 1].fill_(x)
    return out


def _xform_point(xf, p):
    return p @ xf[:3, :3].T + xf[:3, 3]


def _xform_dir(xf, d):
    return d @ xf[:3, :3].T


def _tex_lookup(img, st, intensity):
    """Nearest texel of an (h, w, 3) image at st, with GetValue's clamps and
    v-flip, times the intensity, through the look-up kernels
    (select.small_lut: the small-table backward up to 64 texels, the
    large-table one above)."""
    h, w, _ = img.shape
    u = torch.clamp(st[..., 0], 1e-4, 0.9999)
    v = torch.clamp(1.0 - st[..., 1], 1e-4, 0.9999)
    iu = (float(w) * u).to(torch.int64)
    iv = (float(h) * v).to(torch.int64)
    return small_lut(iv * w + iu, h * w)(img.reshape(h * w, 3)) * intensity


def _le_value(light: LightData, st):
    """Le pattern value * intensity (constant or texture GetValue)."""
    if light.le_tex is None:
        return light.le_const.expand(st.shape[:-1] + (3,)) * light.intensity
    return _tex_lookup(light.le_tex, st, light.intensity)


def _disk_like_eval(light: LightData, p, wi, is_ring: bool):
    """Shared disk/ring Li + Pdf (disklight.cpp:62-104, ringlight.cpp:66-112)."""
    xf = light.xf
    center = xf[:3, 3]
    n = _xform_dir(xf, _vec([0.0, 0.0, -1.0], p))
    radius = _f32(light.radius)

    wi_dot_n = wi @ n
    plane_d = torch.dot(center, n)
    t = _safe_div(plane_d - p @ n, wi_dot_n)
    p_hit = p + t[..., None] * wi
    delta = p_hit - center

    ux = _xform_dir(xf, _vec([1.0, 0.0, 0.0], p))
    uy = _xform_dir(xf, _vec([0.0, 1.0, 0.0], p))
    u = (delta @ ux) / radius
    v = (delta @ uy) / radius
    st = torch.stack([(u + 1.0) * 0.5, 1.0 - (v + 1.0) * 0.5], dim=-1)

    dist2 = (delta * delta).sum(-1)
    ok = (wi_dot_n < 0.0) & (t >= 0.0) & (dist2 <= radius * radius)
    if is_ring:
        inner = _f32(light.inner_radius)
        ok &= dist2 >= _f32(inner * inner)
        area_pdf = _f32(1.0 / (math.pi * (1.0 - light.inner_radius**2
                                          / light.radius**2)
                               * light.radius**2))
    else:
        area_pdf = _f32(1.0 / (math.pi * light.radius**2))
    pdf = torch.where(ok, area_pdf * _safe_div(t * t, -wi_dot_n), 0.0)
    le = torch.where((pdf > 0.0)[..., None], _le_value(light, st), 0.0)
    t_out = torch.where(pdf > 0.0, t, INF)
    return LightEval(le=le, pdf=pdf, t=t_out)


def _disk_like_sample(light: LightData, p, u2, is_ring: bool):
    """Sample_Li (disklight.cpp:25-60, ringlight.cpp:26-64).
    Returns (le, wi, pdf, t, st)."""
    xf = light.xf
    radius = _f32(light.radius)
    if is_ring:
        xy, pdf0 = uniform_sample_ring(
            u2, _f32(light.inner_radius / light.radius))
        r32 = np.float32(light.radius)
        pdf0 = pdf0 / float(np.float32(np.pi) * r32 * r32)  # double-pi quirk
    else:
        xy = uniform_sample_disk(u2)
        pdf0 = torch.full(u2.shape[:-1], 1.0 / (math.pi * light.radius**2),
                          dtype=torch.float32, device=u2.device)
    xy = xy * radius
    su = ((xy[..., 0] + 1.0) * 0.5) / radius
    sv = ((xy[..., 1] + 1.0) * 0.5) / radius
    st = torch.stack([su, 1.0 - sv], dim=-1)

    sample_world = _xform_point(
        xf, torch.stack([xy[..., 0], xy[..., 1], torch.zeros_like(su)], -1))
    n = _xform_dir(xf, _vec([0.0, 0.0, -1.0], p))
    wi = sample_world - p
    dist = torch.sqrt((wi * wi).sum(-1))
    wi = wi / torch.where(dist == 0.0, 1.0, dist)[..., None]

    wi_dot_n = -(wi @ n)
    visible = wi_dot_n > 0.0
    pdf = torch.where(visible, pdf0 * _safe_div(dist * dist, wi_dot_n), 0.0)
    le = torch.where(visible[..., None], _le_value(light, st), 0.0)
    return le, wi, pdf, dist, st


# ---------------------------------------------------------------------------
# Environment light
# ---------------------------------------------------------------------------


def env2d_pdf(dist: Env2D, st):
    """Piecewise2DDistribution::Pdf with TexturePattern::Pdf's clamps
    (texturepattern.cpp:104-109, 158-166)."""
    sx = torch.clamp(st[..., 0], max=0.9999)
    sy = torch.clamp(st[..., 1], max=0.9999)
    u = (sx * dist.width).to(torch.int64)
    v = (sy * dist.height).to(torch.int64)
    return dist.marg_pdf[v] * dist.cond_pdf.reshape(-1)[v * dist.width + u]


def _row_search(flat_cdf, row_base, n_entries, vals):
    """Largest i in [0, n_entries-1] with flat_cdf[row_base + i] <= vals
    (entry 0 is 0 <= vals): per-lane bisection within the lane's own CDF
    row, equal to searchsorted(row, vals, right=True) - 1 without
    materialising an (N, n_entries) gather of the rows."""
    lo = torch.zeros_like(row_base)
    hi = torch.full_like(row_base, n_entries - 1)
    for _ in range(max(1, math.ceil(math.log2(n_entries)))):
        mid = (lo + hi + 1) // 2
        go = flat_cdf[row_base + mid] <= vals
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return lo


def env2d_sample(dist: Env2D, u2):
    """Piecewise2DDistribution::Sample (texturepattern.cpp:72-102).

    The marginal bin is ``torch.searchsorted(marg_cdf, u, right=True) - 1``;
    the conditional bin is the same search within the lane's row (a
    bisection, see _row_search).  Returns (uv (N,2), pdf (N,)); black-row
    lanes return pdf 0 and u 0."""
    h, w = dist.height, dist.width
    inv_h, inv_w = _f32(1.0 / h), _f32(1.0 / w)
    marg_cdf, marg_pdf = dist.marg_cdf, dist.marg_pdf
    cond_flat = dist.cond_pdf.reshape(-1)
    cc_flat = dist.cond_cdf.reshape(-1)

    sy = u2[..., 1].contiguous()
    lb = torch.searchsorted(marg_cdf, sy, right=True) - 1
    lb = lb.clamp(0, h)  # BinarySearch range [0, h]
    vc = (_safe_div(sy - marg_cdf[lb], marg_pdf[lb.clamp(max=h - 1)])
          + lb.to(torch.float32) * inv_h)
    vc = torch.clamp(vc, max=0.9999999)
    v = (vc * h).to(torch.int64)

    marg_v = marg_pdf[v]
    row_ok = marg_v > 0.0
    sx = u2[..., 0]
    lb2 = _row_search(cc_flat, v * (w + 1), w + 1, sx).clamp(0, w)
    uc = (_safe_div(sx - cc_flat[v * (w + 1) + lb2],
                    cond_flat[v * w + lb2.clamp(max=w - 1)])
          + lb2.to(torch.float32) * inv_w)
    uc = torch.clamp(uc, max=0.9999999)
    u = (uc * w).to(torch.int64)
    pdf = torch.where(row_ok, marg_v * cond_flat[v * w + u], 0.0)
    uc = torch.where(row_ok, uc, 0.0)
    return torch.stack([uc, vc], dim=-1), pdf


def _env_st(wi):
    """Direction -> lat-long st with the reference's pi phi-offset
    (environmentlight.cpp:11-21)."""
    theta = torch.arccos(torch.clamp(wi[..., 2], -1.0, 1.0))
    phi = torch.atan2(wi[..., 1], wi[..., 0]) + PI
    phi = torch.where(phi > TWO_PI, phi - TWO_PI, phi)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    st = torch.stack([1.0 - phi / TWO_PI, 1.0 - theta / PI], dim=-1)
    return st, theta


_INV_4PI = _f32(0.25 / math.pi)


def _env_eval(light: LightData, p, wi):
    st, theta = _env_st(wi)
    if light.env2d is not None:
        pdf = env2d_pdf(light.env2d, st)
    else:
        pdf = torch.ones(wi.shape[:-1], device=wi.device)  # constant Pdf()=1
    sin_t = torch.sin(theta).abs()
    pdf = pdf * _INV_4PI * _safe_div(torch.ones_like(sin_t), sin_t)
    le = _le_value(light, st)
    t = torch.full(wi.shape[:-1], ENV_TMAX, device=wi.device)
    return LightEval(le=le, pdf=pdf, t=t)


def _env_sample(light: LightData, p, u2):
    """environmentlight.cpp:31-64."""
    if light.env2d is not None:
        uv, pdf = env2d_sample(light.env2d, u2)
    else:
        uv, pdf = u2, torch.ones(u2.shape[:-1], device=u2.device)
    theta = (1.0 - uv[..., 1]) * PI
    phi = (1.0 - uv[..., 0]) * TWO_PI + PI
    phi = torch.where(phi > TWO_PI, phi - TWO_PI, phi)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    sin_t = torch.sin(theta)
    wi = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                      torch.cos(theta)], dim=-1)
    # Le fetched at the sampled uv (TexturePattern::Sample,
    # texturepattern.cpp:131-155): GetValue's clamps on (u, 1-v)
    if light.le_tex is not None:
        le = _tex_lookup(light.le_tex, uv, light.intensity)
    else:
        le = (light.le_const * light.intensity).expand(u2.shape[:-1] + (3,))
    sin_abs = sin_t.abs()
    pdf = pdf * _INV_4PI * _safe_div(torch.ones_like(sin_abs), sin_abs)
    t = torch.full(u2.shape[:-1], ENV_TMAX, device=u2.device)
    return le, wi, pdf, t, uv


# ---------------------------------------------------------------------------
# Distant light (delta directional; distantlight.cpp — an extension)
# ---------------------------------------------------------------------------


def _distant_eval(light: LightData, p, wi):
    """Li: a delta light is never hit by a ray (distantlight.cpp:11-15)."""
    shape = wi.shape[:-1]
    return LightEval(
        le=torch.zeros(shape + (3,), device=wi.device),
        pdf=torch.zeros(shape, device=wi.device),
        t=torch.full(shape, INF, device=wi.device),
    )


def _distant_sample(light: LightData, p, u2):
    """Sample_Li: wi = -direction, pdf = 1 (distantlight.cpp:17-23)."""
    direction = _xform_dir(light.xf, _vec([0.0, 0.0, -1.0], u2))
    shape = u2.shape[:-1]
    wi = (-direction).expand(shape + (3,))
    pdf = torch.ones(shape, device=u2.device)
    le = (light.le_const * light.intensity).expand(shape + (3,))
    t = torch.full(shape, INF, device=u2.device)
    st = torch.zeros(shape + (2,), device=u2.device)
    return le, wi, pdf, t, st


# ---------------------------------------------------------------------------
# Packed area-light tables: selected-light evaluation in O(1) of the count
# ---------------------------------------------------------------------------


class AreaLightPack(NamedTuple):
    index: tuple  # original light-list indices covered by this pack
    center: torch.Tensor  # (L, 3)
    n: torch.Tensor  # (L, 3) emission normal
    ux: torch.Tensor  # (L, 3)
    uy: torch.Tensor  # (L, 3)
    radius: torch.Tensor  # (L,)
    inner_k2: torch.Tensor  # (L,) (inner/radius)^2 — 0 for disks
    is_ring: torch.Tensor  # (L,) bool
    area_pdf: torch.Tensor  # (L,) eval-side area pdf
    pdf0_ring_scale: torch.Tensor  # (L,) sample-side 1/(pi r^2) factor
    le: torch.Tensor  # (L, 3) le_const * intensity (0 for textured rows)
    intensity: torch.Tensor  # (L,)
    tex_off: torch.Tensor  # (L,) int64 atlas offset, -1 = constant Le
    tex_w: torch.Tensor  # (L,) int64
    tex_h: torch.Tensor  # (L,) int64
    tex_atlas: torch.Tensor  # (T, 3) f32 concatenated Le textures (or (1,3))


def pack_area_lights(lights):
    """Pack disk/ring lights (constant or textured Le) into tables; returns
    (pack | None, rest_idx) where rest_idx are the env/distant lights."""
    idx, rows, rest = [], [], []
    for i, li in enumerate(lights):
        if li.kind in (LIGHT_DISK, LIGHT_RING):
            idx.append(i)
            rows.append(li)
        else:
            rest.append(i)
    if not idx:
        return None, tuple(rest)
    dev = rows[0].xf.device

    def t32(vals):
        return torch.tensor(np.asarray(vals, np.float32), device=dev)

    def i64(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)

    zneg, xpos, ypos = (_vec(v, rows[0].xf) for v in
                        ([0.0, 0.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    tex_off, tex_w, tex_h = [], [], []
    off = 0
    for li in rows:
        if li.le_tex is None:
            tex_off.append(-1)
            tex_w.append(0)
            tex_h.append(0)
        else:
            h, w, _ = li.le_tex.shape
            tex_off.append(off)
            tex_w.append(w)
            tex_h.append(h)
            off += h * w
    ring = [li.kind == LIGHT_RING for li in rows]
    pack = AreaLightPack(
        index=tuple(idx),
        center=torch.stack([li.xf[:3, 3] for li in rows]),
        n=torch.stack([_xform_dir(li.xf, zneg) for li in rows]),
        ux=torch.stack([_xform_dir(li.xf, xpos) for li in rows]),
        uy=torch.stack([_xform_dir(li.xf, ypos) for li in rows]),
        radius=t32([li.radius for li in rows]),
        inner_k2=t32([(li.inner_radius / li.radius) ** 2 if r else 0.0
                      for li, r in zip(rows, ring)]),
        is_ring=torch.tensor(ring, device=dev),
        area_pdf=t32([
            1.0 / (math.pi * (1.0 - (li.inner_radius / li.radius) ** 2)
                   * li.radius**2) if r
            else 1.0 / (math.pi * li.radius**2)
            for li, r in zip(rows, ring)
        ]),
        pdf0_ring_scale=t32([1.0 / (math.pi * li.radius**2) for li in rows]),
        tex_off=i64(tex_off),
        tex_w=i64(tex_w),
        tex_h=i64(tex_h),
        **_pack_radiance(rows, dev),
    )
    return pack, tuple(rest)


def _pack_radiance(rows, dev):
    """The pack's fields that derive from the lights' trainable tensors
    (le, intensity, tex_atlas), by device operations only: no host-built
    tensor, so no synchronisation."""
    chunks = [li.le_tex.reshape(-1, 3) for li in rows if li.le_tex is not None]
    return dict(
        le=torch.stack([
            torch.zeros(3, device=dev) if li.le_tex is not None
            else li.le_const * li.intensity
            for li in rows
        ]),
        intensity=torch.stack([li.intensity.reshape(()) for li in rows]),
        tex_atlas=(torch.cat(chunks) if chunks
                   else torch.zeros((1, 3), device=dev)),
    )


def refresh_area_pack(pack, lights):
    """pack (pack_area_lights of lights of the same kinds, shapes and
    placement) with its radiance fields derived anew from lights' Le,
    intensity and Le textures: the replay machines' per-call
    derivation."""
    return pack._replace(**_pack_radiance([lights[i] for i in pack.index],
                                          pack.le.device))


def _pack_rows(pack, sel, fields):
    """The named fields' rows of the packed lights sel (N,) selects, and
    the fields _pack_le reads (the texture's only where the pack has an
    atlas), in one look-up (the float tables in one launch on the card;
    select.small_lut): a dict by field name."""
    names = tuple(fields) + ("le",)
    if pack.tex_atlas.shape[0] > 1:
        names += ("intensity", "tex_off", "tex_w", "tex_h")
    rows = small_lut(sel, pack.radius.shape[0])(
        *[getattr(pack, f) for f in names])
    return dict(zip(names, rows))


def _pack_st(row, delta):
    """Disk-parameterisation st of the selected rows (row: _pack_rows with
    radius, ux, uy)."""
    r = row["radius"]
    u = (delta * row["ux"]).sum(-1) / r
    v = (delta * row["uy"]).sum(-1) / r
    return torch.stack([(u + 1.0) * 0.5, 1.0 - (v + 1.0) * 0.5], dim=-1)


def _pack_le(pack, row, st):
    """Le * intensity of the selected rows: constant table or one atlas
    look-up (GetValue's clamps and v-flip; through the look-up kernels,
    select.small_lut, as _tex_lookup)."""
    le = row["le"]
    atlas = pack.tex_atlas
    if atlas.shape[0] <= 1:
        return le
    off, w, h = row["tex_off"], row["tex_w"], row["tex_h"]
    u = torch.clamp(st[..., 0], 1e-4, 0.9999)
    v = torch.clamp(1.0 - st[..., 1], 1e-4, 0.9999)
    iu = (w.to(torch.float32) * u).to(torch.int64)
    iv = (h.to(torch.float32) * v).to(torch.int64)
    texel = off.clamp(min=0) + iv * w + iu
    fetched = small_lut(texel, atlas.shape[0])(atlas)
    fetched = fetched * row["intensity"][..., None]
    return torch.where((off >= 0)[..., None], fetched, le)


def area_pack_nearest(pack: AreaLightPack, o, d, t_lim):
    """Nearest packed light along each ray (the per-bounce light pass,
    pathintegrator.cpp:167-182) over all pack rows at once.  Returns
    (le, t (= t_lim where no hit), hit)."""
    wi_dot_n = d @ pack.n.T  # (N, L)
    plane_d = (pack.center * pack.n).sum(-1)  # (L,)
    t = _safe_div(plane_d[None, :] - o @ pack.n.T, wi_dot_n)
    p_hit = o[:, None, :] + t[..., None] * d[:, None, :]  # (N, L, 3)
    delta = p_hit - pack.center[None]
    dist2 = (delta * delta).sum(-1)
    r2 = pack.radius * pack.radius
    ok = ((wi_dot_n < 0.0) & (t >= 0.0) & (dist2 <= r2[None, :])
          & (dist2 >= (pack.inner_k2 * r2)[None, :]))
    t_ok = torch.where(ok, t, INF)
    t_best = t_ok.min(dim=-1).values
    sel = torch.argmin(t_ok, dim=-1)  # first minimum
    hit = t_best < t_lim
    row = _pack_rows(pack, sel, ("radius", "ux", "uy"))
    delta_sel = delta[torch.arange(delta.shape[0], device=d.device), sel]
    st = _pack_st(row, delta_sel)
    le = torch.where(hit[:, None], _pack_le(pack, row, st), 0.0)
    return le, torch.where(hit, t_best, t_lim), hit


def area_pack_eval(pack: AreaLightPack, sel, p, wi):
    """Li of the per-lane selected packed light (sel: (N,) pack rows, read
    in one look-up)."""
    row = _pack_rows(pack, sel, ("center", "n", "radius", "inner_k2",
                                 "area_pdf", "ux", "uy"))
    center, n, radius = row["center"], row["n"], row["radius"]
    wi_dot_n = (wi * n).sum(-1)
    plane_d = (center * n).sum(-1)
    t = _safe_div(plane_d - (p * n).sum(-1), wi_dot_n)
    p_hit = p + t[..., None] * wi
    delta = p_hit - center
    dist2 = (delta * delta).sum(-1)
    r2 = radius * radius
    ok = (wi_dot_n < 0.0) & (t >= 0.0) & (dist2 <= r2)
    ok &= dist2 >= row["inner_k2"] * r2  # 0 for disks: no-op
    pdf = torch.where(ok, row["area_pdf"] * _safe_div(t * t, -wi_dot_n),
                      0.0)
    st = _pack_st(row, delta)
    le = torch.where((pdf > 0.0)[..., None], _pack_le(pack, row, st), 0.0)
    t_out = torch.where(pdf > 0.0, t, INF)
    return LightEval(le=le, pdf=pdf, t=t_out)


def area_pack_sample(pack: AreaLightPack, sel, p, u2):
    """Sample_Li of the per-lane selected packed light (disk and ring share
    the warp up to the ring's annulus remap and double-pi pdf quirk)."""
    row = _pack_rows(pack, sel, ("radius", "is_ring", "inner_k2",
                                 "pdf0_ring_scale", "area_pdf", "center",
                                 "ux", "uy", "n"))
    radius, is_ring = row["radius"], row["is_ring"]
    k = torch.sqrt(row["inner_k2"])
    xy_d = uniform_sample_disk(u2)
    xy_r, pdf_r = uniform_sample_ring(u2, k)
    xy = torch.where(is_ring[..., None], xy_r, xy_d)
    pdf0 = torch.where(is_ring, pdf_r * row["pdf0_ring_scale"],
                       row["area_pdf"])
    xy = xy * radius[..., None]

    sample_world = (row["center"] + xy[..., 0:1] * row["ux"]
                    + xy[..., 1:2] * row["uy"])
    n = row["n"]
    wi = sample_world - p
    dist = torch.sqrt((wi * wi).sum(-1))
    wi = wi / torch.where(dist == 0.0, 1.0, dist)[..., None]
    wi_dot_n = -(wi * n).sum(-1)
    visible = wi_dot_n > 0.0
    pdf = torch.where(visible, pdf0 * _safe_div(dist * dist, wi_dot_n), 0.0)
    # sample-side st: the reference's own formula (divide after offset)
    su = ((xy[..., 0] + 1.0) * 0.5) / radius
    sv = ((xy[..., 1] + 1.0) * 0.5) / radius
    st = torch.stack([su, 1.0 - sv], dim=-1)
    le = torch.where(visible[..., None], _pack_le(pack, row, st), 0.0)
    return le, wi, pdf, dist


# ---------------------------------------------------------------------------
# Public dispatch (per light kind)
# ---------------------------------------------------------------------------


def light_eval(light: LightData, p, wi) -> LightEval:
    """Light::Li — radiance looking along wi from p, with pdf and distance."""
    if light.kind == LIGHT_DISK:
        return _disk_like_eval(light, p, wi, is_ring=False)
    if light.kind == LIGHT_RING:
        return _disk_like_eval(light, p, wi, is_ring=True)
    if light.kind == LIGHT_ENV:
        return _env_eval(light, p, wi)
    if light.kind == LIGHT_DISTANT:
        return _distant_eval(light, p, wi)
    raise ValueError(f"unknown light kind {light.kind}")


def light_sample(light: LightData, p, u2):
    """Light::Sample_Li — returns (le, wi, pdf, dist, st)."""
    if light.kind == LIGHT_DISK:
        return _disk_like_sample(light, p, u2, is_ring=False)
    if light.kind == LIGHT_RING:
        return _disk_like_sample(light, p, u2, is_ring=True)
    if light.kind == LIGHT_ENV:
        return _env_sample(light, p, u2)
    if light.kind == LIGHT_DISTANT:
        return _distant_sample(light, p, u2)
    raise ValueError(f"unknown light kind {light.kind}")

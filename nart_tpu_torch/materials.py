"""Material resolution: per-hit BSDF descriptors + texture fetches.

Counterpart of ``nart_tpu/materials.py`` (reference src/materials/*.cpp and
TexturePattern::GetValue, texturepattern.cpp:172-188).  Per-mesh tables are
read through select.small_lut, the counterpart of the JAX package's
one-hot mesh_luts: its differentiable small-table read, whose backward is a
reduction over the lanes (on the card, the look-up kernels of
csrc/small_lut.cu; a plain gather's backward there serialises the lanes
of each mesh).  The gradient's float32 texture table goes through
select.small_lut too (on the card, the backward of csrc/large_lut.cu for a
table of more than 64 texels).  The render path stores the packed textures
as half floats: the reference's in-memory textures are half, so this is
exact parity and halves the bytes each fetch moves.
"""

from __future__ import annotations

import torch

from . import bxdf
from .scene import (
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_LAMBERT,
    MAT_PLASTIC,
    MAT_SPECULAR,
    SceneData,
)
from .select import small_lut

def _tex_index(scene: SceneData, tex_id, st):
    """Flat texel index per lane: u = clamp(st.x, 1e-4, .9999),
    v = clamp(1 - st.y, 1e-4, .9999), integer-truncated."""
    tid = tex_id.clamp(min=0)
    w = scene.tex_w.long()[tid]
    h = scene.tex_h.long()[tid]
    off = scene.tex_off.long()[tid]
    u = torch.clamp(st[..., 0], 1e-4, 0.9999)
    v = torch.clamp(1.0 - st[..., 1], 1e-4, 0.9999)
    iu = (w.to(torch.float32) * u).to(torch.int64)
    iv = (h.to(torch.float32) * v).to(torch.int64)
    return off + iv * w + iu


def pack_tex_half(tex_data):
    """(P, 3) f32 -> (P, 3) f16: the texture table of the render path."""
    return tex_data.to(torch.float16)


def tex_fetch(scene: SceneData, tex_id, st, tex_half=None):
    """Nearest-neighbour texture lookup: (N, 3) f32.  The float32 table (the
    gradient's) through the look-up kernels (select.small_lut); the render
    path's half table, which carries no gradient, by plain indexing."""
    idx = _tex_index(scene, tex_id, st)
    if tex_half is None:
        return small_lut(idx, scene.tex_data.shape[0])(scene.tex_data)
    return tex_half[idx].to(torch.float32)


def mesh_lookup(scene: SceneData, mesh_id):
    """Row look-ups into per-mesh tables with gather's index clamping
    (mesh_luts): float tables through the look-up kernels on the card."""
    return small_lut(mesh_id, scene.mat_type.shape[0])


# make_bsdf's pattern slots: (slot, constant table, texture-id table)
_SLOTS = (("rho_d", "rho_d_const", "rho_d_tex"),
          ("rho_s", "rho_s_const", "rho_s_tex"),
          ("tau", "tau_const", "tau_tex"),
          ("eta", "eta_const", "eta_tex"),
          ("alpha", "alpha_const", "alpha_tex"),
          ("normal", "normal_const", "normal_tex"))


def _pattern(scene, val, tid, st, tex_half):
    """Constant-or-texture pattern value per lane: val (the constant's row,
    (N, 3) or (N,)) where tid (the texture-id row) is None or negative,
    else the texel (its first channel for a scalar)."""
    if tid is None:
        return val
    tex = tex_fetch(scene, tid.long(), st, tex_half)
    if val.dim() == 1:
        return torch.where(tid >= 0, tex[..., 0], val)
    return torch.where((tid >= 0)[..., None], tex, val)


def make_bsdf(scene: SceneData, mesh_id, st, sn, dpds, alpha_tweak,
              tex_half=None):
    """Resolve the per-hit BSDF: shading frame + lobe descriptor.

    Mirrors the CreateBSDF logic of all five materials, including:
      * roughening chain alpha' = 1 - (1-alpha)*alphaTweak
      * glossy/glass degrade to delta lobes when alpha' <= 1e-4
        (plastic's specular slot threshold is 1e-3, plasticmaterial.cpp:39)
      * microfacet lobes get alpha0 = max(1e-4, alpha)
      * specular material has alpha = 0 (specularmaterial.cpp:26)
    The per-mesh tables are read in one look-up (the float ones in one
    launch on the card); slots no mesh binds a texture to skip the fetch.
    Returns (frame, desc).
    """
    textured = [slot in scene.tex_slots for slot, _, _ in _SLOTS]
    rows = mesh_lookup(scene, mesh_id)(
        scene.mat_type, scene.has_normal,
        *[getattr(scene, const) for _, const, _ in _SLOTS],
        *[getattr(scene, tex) for (_, _, tex), t in zip(_SLOTS, textured)
          if t])
    mat, has_n, tids = rows[0].long(), rows[1], iter(rows[2 + len(_SLOTS):])
    rho_d, rho_s, tau, eta, alpha, n_val = (
        _pattern(scene, val, next(tids) if t else None, st, tex_half)
        for val, t in zip(rows[2:2 + len(_SLOTS)], textured))
    alpha = torch.where(mat == MAT_SPECULAR, 0.0, alpha)  # pre-squared
    alpha_prime = 1.0 - (1.0 - alpha) * alpha_tweak

    # shading frame (+ optional normal map; glass never has one)
    nn = n_val * 2.0 - 1.0
    frame_plain = bxdf.build_frame(sn, dpds)
    frame_mapped = bxdf.build_frame(sn, dpds, nn)
    hn = has_n[..., None]
    frame = bxdf.Frame(
        t=torch.where(hn, frame_mapped.t, frame_plain.t),
        b=torch.where(hn, frame_mapped.b, frame_plain.b),
        n=torch.where(hn, frame_mapped.n, frame_plain.n),
    )

    micro = torch.where(alpha_prime > 1e-4, bxdf.L_TS, bxdf.L_SPECULAR)
    glass = torch.where(alpha_prime > 1e-4, bxdf.L_DIELECTRIC, bxdf.L_SPECDIEL)
    lambert = torch.full_like(mat, bxdf.L_LAMBERT)
    lobe0 = torch.where(
        mat == MAT_LAMBERT, lambert,
        torch.where(
            (mat == MAT_SPECULAR) | (mat == MAT_GLOSSY), micro,
            torch.where(mat == MAT_GLASS, glass, lambert),
        ),
    )
    plastic = mat == MAT_PLASTIC
    lobe1 = torch.where(
        plastic,
        torch.where(alpha_prime > 1e-3, bxdf.L_TS, bxdf.L_SPECULAR),
        -1,
    )
    desc = bxdf.BsdfDesc(
        n_lobes=torch.where(plastic, 2, 1),
        lobe=torch.stack([lobe0, lobe1], dim=-1),
        rho_d=rho_d,
        rho_s=rho_s,
        tau=tau,
        eta=eta,
        alpha0=torch.clamp(alpha, min=1e-4),
        alpha_prime=alpha_prime,
    )
    return frame, desc

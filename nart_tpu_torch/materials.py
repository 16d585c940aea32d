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


def _pattern(scene, const_table, tex_table, lut, st, slot, tex_half):
    """Constant-or-texture pattern value per lane: (N, 3).  Slots no mesh
    binds a texture to skip the fetch."""
    val = lut(const_table)
    if slot not in scene.tex_slots:
        return val
    tid = lut(tex_table).long()
    return torch.where((tid >= 0)[..., None],
                       tex_fetch(scene, tid, st, tex_half), val)


def make_bsdf(scene: SceneData, mesh_id, st, sn, dpds, alpha_tweak,
              tex_half=None):
    """Resolve the per-hit BSDF: shading frame + lobe descriptor.

    Mirrors the CreateBSDF logic of all five materials, including:
      * roughening chain alpha' = 1 - (1-alpha)*alphaTweak
      * glossy/glass degrade to delta lobes when alpha' <= 1e-4
        (plastic's specular slot threshold is 1e-3, plasticmaterial.cpp:39)
      * microfacet lobes get alpha0 = max(1e-4, alpha)
      * specular material has alpha = 0 (specularmaterial.cpp:26)
    Returns (frame, desc).
    """
    slots = scene.tex_slots
    lut = mesh_lookup(scene, mesh_id)
    mat = lut(scene.mat_type).long()

    rho_d = _pattern(scene, scene.rho_d_const, scene.rho_d_tex, lut, st,
                     "rho_d", tex_half)
    rho_s = _pattern(scene, scene.rho_s_const, scene.rho_s_tex, lut, st,
                     "rho_s", tex_half)
    tau = _pattern(scene, scene.tau_const, scene.tau_tex, lut, st, "tau",
                   tex_half)

    def scalar(const_table, tex_table, slot):
        val = lut(const_table)
        if slot not in slots:
            return val
        tid = lut(tex_table).long()
        return torch.where(tid >= 0, tex_fetch(scene, tid, st, tex_half)[..., 0],
                           val)

    eta = scalar(scene.eta_const, scene.eta_tex, "eta")
    alpha = scalar(scene.alpha_const, scene.alpha_tex, "alpha")  # pre-squared
    alpha = torch.where(mat == MAT_SPECULAR, 0.0, alpha)
    alpha_prime = 1.0 - (1.0 - alpha) * alpha_tweak

    # shading frame (+ optional normal map; glass never has one)
    has_n = lut(scene.has_normal)
    n_val = _pattern(scene, scene.normal_const, scene.normal_tex, lut, st,
                     "normal", tex_half)
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

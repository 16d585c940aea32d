"""BSDF lobes and aggregation over wavefronts of hits.

Counterpart of ``nart_tpu/bxdf.py`` (reference src/core/bxdf.cpp and
src/bxdfs/*.cpp).  Each hit carries a descriptor (lobe codes + parameters);
every lobe family is evaluated for the whole wavefront and the right result
selected per lane.  Divisions use guarded denominators, as in the JAX
package.

Reference quirks preserved:
  * Lambert Pdf returns wi.z/pi un-clamped; BSDF.pdf() sums raw lobe pdfs
  * a sampled SPECULAR flag skips lobe mixing AND the 1/numLobes division
  * index-matched dielectrics return pdf=0 and OR TRANSMISSIVE onto the
    caller's running flags
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .sampling import cosine_sample_hemisphere, uniform_sample_disk

# flag bits (bxdf.h:22)
SPECULAR, GLOSSY, DIFFUSE, TRANSMISSIVE = 1, 2, 4, 8

# lobe type codes
L_LAMBERT, L_TS, L_DIELECTRIC, L_SPECULAR, L_SPECDIEL = 0, 1, 2, 3, 4

PI = math.pi
INV_PI = 1.0 / math.pi


def _safe_sqrt(x):
    """sqrt(max(0, x)) with 0 at x <= 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _safe_div(a, b, where_ok=None):
    """a / b with b == 0 lanes giving 0."""
    ok = b != 0.0 if where_ok is None else where_ok
    b_safe = torch.where(ok, b, 1.0)
    return torch.where(ok, a / b_safe, 0.0)


def _normalize(v):
    # the zero vector divides by 1; its sqrt is kept out of the graph
    # (d sqrt / dx is infinite at 0 and would turn a zero adjoint into nan)
    n2 = (v * v).sum(-1, keepdim=True)
    zero = n2 == 0.0
    return v / torch.where(zero, 1.0, torch.sqrt(torch.where(zero, 1.0, n2)))


def _dot(a, b):
    return (a * b).sum(-1)


def reflect(w1, w2):
    """2*dot(w1,w2)*w2 - w1  (bxdf.h:14-16)."""
    return 2.0 * _dot(w1, w2)[..., None] * w2 - w1


def fresnel(eta_o, eta_i, cos_theta):
    """Unpolarised dielectric Fresnel with TIR.  bxdf.cpp:3-22.
    eta_o == eta_i returns 0."""
    cos_o = torch.clamp(cos_theta.abs(), max=1.0)
    sin_o = _safe_sqrt(1.0 - cos_o * cos_o)
    sin_i = _safe_div(eta_o, eta_i) * sin_o
    tir = sin_i > 1.0
    cos_i = _safe_sqrt(1.0 - torch.clamp(sin_i, max=1.0) ** 2)
    denom_small = (cos_o + cos_i).abs() < 1e-5
    f_para = _safe_div(eta_i * cos_o - eta_o * cos_i,
                       eta_i * cos_o + eta_o * cos_i)
    f_perp = _safe_div(eta_o * cos_o - eta_i * cos_i,
                       eta_o * cos_o + eta_i * cos_i)
    fr = (f_para * f_para + f_perp * f_perp) * 0.5
    fr = torch.where(denom_small, 0.0, fr)
    fr = torch.where(tir, 1.0, fr)
    return torch.where(eta_o == eta_i, 0.0, fr)


# ---------------------------------------------------------------------------
# Shading frame
# ---------------------------------------------------------------------------


class Frame(NamedTuple):
    """World-space shading frame; n is the unnormalised shading normal."""

    t: torch.Tensor  # (N, 3)
    b: torch.Tensor  # (N, 3)
    n: torch.Tensor  # (N, 3)


def build_frame(sn, dpds, nn=None):
    """BSDF::BuildCoordSys (bxdf.cpp:27-45); nn is an optional normal-map
    vector in [-1,1]^3 expressed in the base frame."""
    n = sn
    dot_dn = _dot(dpds, n)[..., None]
    t = _normalize(dpds - dot_dn * n)
    b = _normalize(torch.linalg.cross(sn, t))
    if nn is not None:
        n2 = _normalize(to_world(Frame(t=t, b=b, n=n), nn))
        dot_dn2 = _dot(dpds, n2)[..., None]
        t = _normalize(dpds - dot_dn2 * n2)
        b = _normalize(torch.linalg.cross(sn, t))
        n = n2
    return Frame(t=t, b=b, n=n)


def to_local(frame: Frame, v):
    return _normalize(torch.stack(
        [_dot(v, frame.t), _dot(v, frame.b), _dot(v, frame.n)], dim=-1))


def to_world(frame: Frame, v):
    return _normalize(v[..., 0:1] * frame.t + v[..., 1:2] * frame.b
                      + v[..., 2:3] * frame.n)


# ---------------------------------------------------------------------------
# BSDF descriptor
# ---------------------------------------------------------------------------


class BsdfDesc(NamedTuple):
    """Per-hit resolved BSDF: up to 2 lobes (MAX_BXDFS, bxdf.h:12)."""

    n_lobes: torch.Tensor  # (N,) int — 1 or 2
    lobe: torch.Tensor  # (N, 2) int lobe codes (slot 1 = -1 if unused)
    rho_d: torch.Tensor  # (N, 3)
    rho_s: torch.Tensor  # (N, 3)
    tau: torch.Tensor  # (N, 3)
    eta: torch.Tensor  # (N,)
    alpha0: torch.Tensor  # (N,) microfacet alpha (already max(1e-4, .))
    alpha_prime: torch.Tensor  # (N,) roughened alpha


def lobe_static_specular(code):
    return (code == L_SPECULAR) | (code == L_SPECDIEL)


def lobe_eta(desc: BsdfDesc, code):
    """Get_eta per lobe: Lambert returns 0, others their eta."""
    return torch.where(code == L_LAMBERT, 0.0, desc.eta)


# ---------------------------------------------------------------------------
# Microfacet helpers (shared by TS and Dielectric)
# ---------------------------------------------------------------------------


def _lambda(w, alpha):
    """Smith Lambda (torrancesparrowbrdf.cpp:12-17)."""
    z = w[..., 2]
    sin_t = _safe_sqrt(1.0 - z * z)
    tan_t = _safe_div(sin_t, z)
    return (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan_t * tan_t)) * 0.5


def _g(wo, wi, alpha):
    return 1.0 / (1.0 + _lambda(wo, alpha) + _lambda(wi, alpha))


def _g1(w, alpha):
    return 1.0 / (1.0 + _lambda(w, alpha))


def _d_ggx(wh, alpha):
    """Trowbridge-Reitz D (torrancesparrowbrdf.cpp:19-30)."""
    z = wh[..., 2]
    z2 = z * z
    sin2 = torch.clamp(1.0 - z2, min=0.0)
    tan2 = _safe_div(sin2, z2)
    a2 = alpha * alpha
    denom = (PI * a2 * (z2 * z2)) * (1.0 + tan2 / a2) ** 2
    return torch.where(z == 0.0, 0.0, _safe_div(torch.ones_like(denom), denom))


def _vndf_sample(wo, alpha, u2, flip_lower=False):
    """Heitz ellipsoid-stretch visible-normal sampling
    (torrancesparrowbrdf.cpp:68-97 / dielectricbrdf.cpp:106-139), with the
    vertical-wo guard on both lobes (as in the JAX package)."""
    wo_h = _normalize(torch.stack(
        [wo[..., 0] * alpha, wo[..., 1] * alpha, wo[..., 2]], dim=-1))
    if flip_lower:
        wo_h = torch.where((wo[..., 2] < 0.0)[..., None], -wo_h, wo_h)
    t1 = torch.stack([wo_h[..., 1], -wo_h[..., 0], torch.zeros_like(alpha)],
                     dim=-1)
    vertical = (wo[..., 0] == 0.0) & (wo[..., 1] == 0.0)
    # made on the device: a host-built constant is a copy that synchronises
    # the stream, and this runs every round
    x_axis = torch.zeros_like(t1)
    x_axis[..., 0].fill_(1.0)
    t1 = _normalize(torch.where(vertical[..., None], x_axis, t1))
    t2 = _normalize(torch.linalg.cross(t1, wo_h))

    disk = uniform_sample_disk(u2)
    dx, dy = disk[..., 0], disk[..., 1]
    s = (1.0 + wo_h[..., 2]) * 0.5
    dy = s * dy + (1.0 - s) * torch.sqrt(torch.clamp(1.0 - dx * dx, min=0.0))
    hx = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    wh = hx[..., None] * wo_h + dx[..., None] * t1 + dy[..., None] * t2
    wh = torch.stack([wh[..., 0] * alpha, wh[..., 1] * alpha, wh[..., 2]],
                     dim=-1)
    return _normalize(wh)


# ---------------------------------------------------------------------------
# Lobes
# ---------------------------------------------------------------------------


def lambert_f(desc):
    return desc.rho_d * INV_PI


def lambert_pdf(wi):
    return wi[..., 2] * INV_PI  # un-clamped (parity)


def lambert_sample(desc, u2):
    wi, pdf = cosine_sample_hemisphere(u2)
    flags = torch.full(pdf.shape, DIFFUSE, dtype=torch.int64, device=pdf.device)
    return lambert_f(desc), wi, pdf, flags, torch.ones_like(pdf)


def _ts_alpha(desc, use_prime):
    return torch.where(use_prime, desc.alpha_prime, desc.alpha0)


def _micro_flags(alpha, spec_below):
    """DIFFUSE at alpha >= 1, GLOSSY above spec_below, else SPECULAR."""
    full = torch.full_like(alpha, GLOSSY, dtype=torch.int64)
    flags = torch.where(alpha >= 1.0, DIFFUSE, full)
    return torch.where(alpha > spec_below, flags, SPECULAR)


def _guard(m, desc, wo, eta_outer, wi=None, wi_z=1.0):
    """A lobe's inputs on the lanes m, whose value is selected, and stand-ins
    elsewhere: wo = (0, 0, 1), wi = (0, 0, wi_z), eta 1.5, eta_outer 1,
    alpha 0.5.  The lanes m keep their bits; on the others the lobe's
    derivatives are finite, so the zero cotangent the selection sends back
    stays zero (an inf or NaN derivative of a lobe the lane lacks, at a
    grazing angle or alpha near 0, would make it NaN).  Returns (desc, wo,
    eta_outer) or, given wi, (desc, wo, wi, eta_outer)."""
    def direction(w, z):
        axis = torch.zeros_like(w)  # made on the device (as x_axis)
        axis[..., 2].fill_(z)
        return torch.where(m[..., None], w, axis)

    d = desc._replace(eta=torch.where(m, desc.eta, 1.5),
                      alpha0=torch.where(m, desc.alpha0, 0.5),
                      alpha_prime=torch.where(m, desc.alpha_prime, 0.5))
    eo = torch.where(m, eta_outer, 1.0)
    if wi is None:
        return d, direction(wo, 1.0), eo
    return d, direction(wo, 1.0), direction(wi, wi_z), eo


def _guarded(fn, m, desc, wo, wi, use_prime, eta_outer, wi_z=1.0):
    """fn(desc, wo, wi, use_prime, eta_outer) on _guard's inputs."""
    d, wo, wi, eo = _guard(m, desc, wo, eta_outer, wi, wi_z)
    return fn(d, wo, wi, use_prime, eo)


def ts_f(desc, wo, wi, use_prime, eta_outer):
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    bad = (wo[..., 2] < 0.0) | (wi[..., 2] < 0.0) | (denom == 0.0)
    return torch.where(bad[..., None], 0.0,
                       _guarded(_ts_f, ~bad, desc, wo, wi, use_prime,
                                eta_outer))


def _ts_f(desc, wo, wi, use_prime, eta_outer):
    alpha = _ts_alpha(desc, use_prime)
    wh = _normalize(wo + wi)
    g = _g(wo, wi, alpha)
    d = _d_ggx(wh, alpha)
    fr = fresnel(eta_outer, desc.eta, _dot(wh, wi))
    denom = 4.0 * wo[..., 2] * wi[..., 2]
    return desc.rho_s * _safe_div(g * d * fr, denom)[..., None]


def ts_pdf(desc, wo, wi, use_prime, eta_outer):
    """torrancesparrowbrdf.cpp:109-124."""
    alpha = _ts_alpha(desc, use_prime)
    wh = _normalize(wo + wi)
    cos_h = torch.clamp(_dot(wo, wh), max=1.0)
    pdf = _safe_div(_d_ggx(wh, alpha) * cos_h * _g1(wo, alpha), wo[..., 2])
    pdf = torch.clamp(_safe_div(pdf, 4.0 * cos_h), min=0.0)
    return torch.where(wh[..., 2] < 0.0, 0.0, pdf)


def ts_sample(desc, wo, u2, use_prime, eta_outer):
    alpha = _ts_alpha(desc, use_prime)
    flags = _micro_flags(alpha, 0.001)
    wh = _vndf_sample(wo, alpha, u2, flip_lower=False)
    # detached-sampling estimator (path replay): the sampled direction is a
    # fixed decision; gradients flow through f/pdf evaluated at it
    wi = _normalize(reflect(wo, wh)).detach()
    pdf = ts_pdf(desc, wo, wi, use_prime, eta_outer)
    return ts_f(desc, wo, wi, use_prime, eta_outer), wi, pdf, flags, alpha


def _oriented_etas(desc, wo, eta_outer):
    below = wo[..., 2] < 0.0
    return (torch.where(below, desc.eta, eta_outer),
            torch.where(below, eta_outer, desc.eta))


def dielectric_f(desc, wo, wi, use_prime, eta_outer):
    """dielectricbrdf.cpp:31-80: the reflection on the lanes where wo and wi
    lie on one side, the refraction on the others, each on its own lanes'
    inputs (_guard)."""
    same_side = wo[..., 2] * wi[..., 2] >= 0.0
    refl = _guarded(_dielectric_refl, same_side, desc, wo, wi, use_prime,
                    eta_outer)
    refr = _guarded(_dielectric_refr, ~same_side, desc, wo, wi, use_prime,
                    eta_outer, wi_z=-1.0)
    return torch.where(same_side[..., None], refl, refr)


def _dielectric_refl(desc, wo, wi, use_prime, eta_outer):
    alpha = _ts_alpha(desc, use_prime)
    eta_o, eta_i = _oriented_etas(desc, wo, eta_outer)
    wh_r = _normalize(wo + wi)
    wh_r = torch.where(wh_r[..., 2:3] < 0.0, -wh_r, wh_r)
    fr_r = fresnel(eta_o, eta_i, _dot(wh_r, wo).abs())
    denom_r = 4.0 * wo[..., 2] * wi[..., 2]
    return desc.rho_s * _safe_div(
        _g(wo, wi, alpha) * _d_ggx(wh_r, alpha) * fr_r, denom_r)[..., None]


def _dielectric_refr(desc, wo, wi, use_prime, eta_outer):
    alpha = _ts_alpha(desc, use_prime)
    eta_o, eta_i = _oriented_etas(desc, wo, eta_outer)
    wh_t = _normalize(eta_o[..., None] * wo + eta_i[..., None] * wi)
    wh_t = torch.where(wh_t[..., 2:3] < 0.0, -wh_t, wh_t)
    fr_t = fresnel(eta_o, eta_i, _dot(wh_t, wo).abs())
    wi_dot_wh = _dot(wi, wh_t)
    wo_dot_wh = _dot(wo, wh_t)
    num = (_g(wo, wi, alpha) * _d_ggx(wh_t, alpha) * (1.0 - fr_t)
           * wi_dot_wh.abs() * wo_dot_wh.abs() * eta_o * eta_o)
    den = (eta_i * wi_dot_wh + eta_o * wo_dot_wh) ** 2 * (
        wo[..., 2] * wi[..., 2]).abs()
    refr = desc.tau * _safe_div(num, den)[..., None]
    return torch.where((fr_t >= 1.0)[..., None], 0.0, refr)


def dielectric_pdf(desc, wo, wi, use_prime, eta_outer):
    """dielectricbrdf.cpp:187-225 (refraction Jacobian)."""
    alpha = _ts_alpha(desc, use_prime)
    eta_o, eta_i = _oriented_etas(desc, wo, eta_outer)
    same_side = wo[..., 2] * wi[..., 2] >= 0.0

    wh_r = _normalize(wo + wi)
    wh_r = torch.where(wh_r[..., 2:3] < 0.0, -wh_r, wh_r)
    cos_h = torch.clamp(_dot(wo, wh_r), max=1.0).abs()
    pdf_r = _safe_div(
        _d_ggx(wh_r, alpha) * torch.clamp(_dot(wo, wh_r), max=1.0)
        * _g1(wo, alpha),
        wo[..., 2],
    )
    pdf_r = torch.clamp(_safe_div(pdf_r, 4.0 * cos_h), min=0.0)

    wh_t = _normalize(eta_o[..., None] * wo + eta_i[..., None] * wi)
    wh_t = torch.where(wh_t[..., 2:3] < 0.0, -wh_t, wh_t)
    pdf_t = _safe_div(
        _d_ggx(wh_t, alpha) * torch.clamp(_dot(wo, wh_t).abs(), max=1.0)
        * _g1(wo, alpha),
        wo[..., 2].abs(),
    )
    wi_dot_wh = _dot(wi, wh_t)
    wo_dot_wh = _dot(wo, wh_t)
    den = eta_i * wi_dot_wh + eta_o * wo_dot_wh
    jdet = _safe_div(wi_dot_wh.abs() * eta_i * eta_i, den * den)
    pdf = torch.where(same_side, pdf_r, pdf_t * jdet)
    return torch.where(eta_outer == desc.eta, 0.0, pdf)


def _refract(w, wh, eta_ratio, cos_o, sin_i):
    """Refraction about microfacet wh (dielectricbrdf.cpp:173-178)."""
    b = wh * cos_o[..., None]
    a = w - b
    c = -a * eta_ratio[..., None]
    d = -wh * _safe_sqrt(1.0 - sin_i * sin_i)[..., None]
    d = torch.where((_dot(w, wh) < 0.0)[..., None], -d, d)
    return _normalize(c + d)


def dielectric_sample(desc, wo, u1, u2, use_prime, eta_outer, prev_flags):
    """dielectricbrdf.cpp:82-183.  Returns (f, wi, pdf, flags, alpha_i)."""
    alpha = _ts_alpha(desc, use_prime)
    eta_o, eta_i = _oriented_etas(desc, wo, eta_outer)
    matched = eta_outer == desc.eta
    flags = _micro_flags(alpha, 0.0001)

    wh = _vndf_sample(wo, alpha, u2, flip_lower=True).detach()
    fr = fresnel(eta_o, eta_i, _dot(wh, wo).abs())
    cos_o = torch.clamp(_dot(wo, wh), -1.0, 1.0)
    sin_o = _safe_sqrt(1.0 - cos_o * cos_o)
    sin_i = _safe_div(eta_o, eta_i) * sin_o
    tir = sin_i >= 1.0

    reflect_choice = u1 < fr
    wi_refl = _normalize(reflect(wo, wh))
    wi_refr = _refract(wo, wh, _safe_div(eta_o, eta_i), cos_o,
                       torch.clamp(sin_i, max=1.0))
    do_reflect = reflect_choice | tir
    wi = torch.where(do_reflect[..., None], wi_refl, wi_refr).detach()
    pdf_scale = torch.where(reflect_choice, fr, 1.0 - fr)
    pdf = dielectric_pdf(desc, wo, wi, use_prime, eta_outer) * pdf_scale
    f = _guarded(dielectric_f, ~matched, desc, wo, wi, use_prime, eta_outer)
    flags = torch.where(do_reflect, flags, flags | TRANSMISSIVE)

    # index-matched pass-through (dielectricbrdf.cpp:89-94)
    wi = torch.where(matched[..., None], -wo, wi)
    pdf = torch.where(matched, 0.0, pdf)
    f = torch.where(matched[..., None], desc.tau, f)
    flags = torch.where(matched, prev_flags | TRANSMISSIVE, flags)
    return f, wi, pdf, flags, alpha


def specular_sample(desc, wo, eta_outer):
    """specularbrdf.cpp:14-29."""
    wi = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]],
                     dim=-1).detach()
    pdf = torch.ones(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    fr = fresnel(eta_outer, desc.eta, wi[..., 2])
    f = desc.rho_s * _safe_div(fr, wi[..., 2].abs())[..., None]
    f = torch.where((wi[..., 2] == 0.0)[..., None], 1.0, f)
    flags = torch.full(pdf.shape, SPECULAR, dtype=torch.int64, device=wo.device)
    return f, wi, pdf, flags, torch.zeros_like(pdf)


def specdiel_sample(desc, wo, u2, eta_outer, prev_flags):
    """speculardielectricbrdf.cpp:15-82.  Lobe choice uses sample.x."""
    matched = eta_outer == desc.eta
    eta_o, eta_i = _oriented_etas(desc, wo, eta_outer)
    fr = fresnel(eta_o, eta_i, wo[..., 2].abs())

    choose_reflect = u2[..., 0] < fr
    wi_refl = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    f_refl = desc.rho_s * _safe_div(fr, wi_refl[..., 2].abs())[..., None]
    f_refl = torch.where((wi_refl[..., 2] == 0.0)[..., None], 1.0, f_refl)

    cos_o = wo[..., 2]
    sin_o = _safe_sqrt(1.0 - cos_o * cos_o)
    sin_i = _safe_div(eta_o, eta_i) * sin_o
    tir = sin_i >= 1.0
    n = torch.zeros_like(wo)  # the normal, made on the device (as x_axis)
    n[..., 2].fill_(1.0)
    b = n * cos_o[..., None]
    a = wo - b
    c = -a * _safe_div(eta_o, eta_i)[..., None]
    dvec = -n * _safe_sqrt(1.0 - torch.clamp(sin_i, max=1.0) ** 2)[..., None]
    dvec = torch.where((cos_o < 0.0)[..., None], -dvec, dvec)
    wi_refr = _normalize(c + dvec)
    ratio2 = _safe_div(eta_o, eta_i) ** 2
    f_refr = desc.tau * _safe_div(ratio2 * (1.0 - fr),
                                  wi_refr[..., 2].abs())[..., None]
    f_tir = desc.rho_s  # TIR: vec3(1)*rho_s (speculardielectricbrdf.cpp:61-64)

    refl_or_tir = choose_reflect | tir
    wi = torch.where(refl_or_tir[..., None], wi_refl, wi_refr)
    f = torch.where(choose_reflect[..., None], f_refl,
                    torch.where(tir[..., None], f_tir, f_refr))
    pdf = torch.where(choose_reflect, fr, 1.0 - fr)
    spec = torch.full_like(prev_flags, SPECULAR)
    flags = torch.where(refl_or_tir, spec, spec | TRANSMISSIVE)

    # index-matched pass-through (speculardielectricbrdf.cpp:23-28)
    wi = torch.where(matched[..., None], -wo, wi).detach()
    pdf = torch.where(matched, 0.0, pdf)
    f = torch.where(matched[..., None], desc.tau, f)
    flags = torch.where(matched, prev_flags | TRANSMISSIVE, flags)
    return f, wi, pdf, flags, torch.zeros_like(pdf)


# ---------------------------------------------------------------------------
# Per-lobe dispatch (masked select over the 5 lobe families)
# ---------------------------------------------------------------------------


def _lobe_f(desc, code, wo, wi, use_prime, eta_outer):
    """Each microfacet lobe on the lanes of its code (_guard)."""
    f = torch.where((code == L_LAMBERT)[..., None], lambert_f(desc), 0.0)
    for k, fn in ((L_TS, ts_f), (L_DIELECTRIC, dielectric_f)):
        m = code == k
        f = torch.where(m[..., None], _guarded(fn, m, desc, wo, wi, use_prime,
                                               eta_outer), f)
    return f  # specular lobes: f == 0


def _lobe_pdf(desc, code, wo, wi, use_prime, eta_outer):
    pdf = torch.where(code == L_LAMBERT, lambert_pdf(wi), 0.0)
    pdf = torch.where(code == L_TS,
                      ts_pdf(desc, wo, wi, use_prime, eta_outer), pdf)
    pdf = torch.where(code == L_DIELECTRIC,
                      dielectric_pdf(desc, wo, wi, use_prime, eta_outer), pdf)
    return pdf


def _lobe_sample(desc, code, wo, u1, u2, use_prime, eta_outer, prev_flags):
    """Each lobe's sample on the lanes of its code, its inputs guarded
    (_guard); the specular dielectric's on every other lane."""
    codes = (L_LAMBERT, L_TS, L_DIELECTRIC, L_SPECULAR)
    specdiel = ~((code == L_LAMBERT) | (code == L_TS)
                 | (code == L_DIELECTRIC) | (code == L_SPECULAR))
    d1, wo1, eo1 = _guard(code == L_TS, desc, wo, eta_outer)
    d2, wo2, eo2 = _guard(code == L_DIELECTRIC, desc, wo, eta_outer)
    d3, wo3, eo3 = _guard(code == L_SPECULAR, desc, wo, eta_outer)
    d4, wo4, eo4 = _guard(specdiel, desc, wo, eta_outer)
    outs = [
        lambert_sample(desc, u2),
        ts_sample(d1, wo1, u2, use_prime, eo1),
        dielectric_sample(d2, wo2, u1, u2, use_prime, eo2, prev_flags),
        specular_sample(d3, wo3, eo3),
        specdiel_sample(d4, wo4, u2, eo4, prev_flags),
    ]

    def sel(k):
        val = outs[4][k]
        for i in reversed(range(4)):
            m = code == codes[i]
            a = outs[i][k]
            val = torch.where(m[..., None] if a.dim() > m.dim() else m, a, val)
        return val

    return tuple(sel(k) for k in range(5))


# ---------------------------------------------------------------------------
# BSDF aggregate ops (bxdf.cpp:47-111)
# ---------------------------------------------------------------------------


def bsdf_f(desc: BsdfDesc, wo, wi, use_prime, eta_outer):
    """Sum of lobes (BSDF::f)."""
    f = _lobe_f(desc, desc.lobe[..., 0], wo, wi, use_prime, eta_outer)
    f2 = _lobe_f(desc, desc.lobe[..., 1], wo, wi, use_prime, eta_outer)
    return f + torch.where((desc.n_lobes >= 2)[..., None], f2, 0.0)


def bsdf_pdf(desc: BsdfDesc, wo, wi, use_prime, eta_outer):
    """Average of lobe pdfs (BSDF::Pdf) — raw sums, parity."""
    p = _lobe_pdf(desc, desc.lobe[..., 0], wo, wi, use_prime, eta_outer)
    p2 = _lobe_pdf(desc, desc.lobe[..., 1], wo, wi, use_prime, eta_outer)
    p = p + torch.where(desc.n_lobes >= 2, p2, 0.0)
    return p / desc.n_lobes.to(torch.float32)


def bsdf_sample_eta(desc: BsdfDesc, u1):
    """BSDF::Sample_eta (bxdf.cpp:94-100)."""
    idx = (u1 * desc.n_lobes.to(torch.float32)).to(torch.int64).clamp(0, 1)
    code = torch.where(idx == 0, desc.lobe[..., 0], desc.lobe[..., 1])
    return lobe_eta(desc, code)


def bsdf_sample_f(desc: BsdfDesc, wo, u1, u2, use_prime, eta_outer,
                  prev_flags):
    """One-sample lobe selection + mixing (BSDF::Sample_f, bxdf.cpp:56-92).
    Returns (f, wi, pdf, flags, alpha_i, eta_sampled)."""
    n_f = desc.n_lobes.to(torch.float32)
    idx = (u1 * n_f).to(torch.int64).clamp(0, 1)
    u1r = u1 * n_f - torch.floor(u1 * n_f)  # glm::fract remap
    code = torch.where(idx == 0, desc.lobe[..., 0], desc.lobe[..., 1])

    f, wi, pdf, flags, alpha_i = _lobe_sample(
        desc, code, wo, u1r, u2, use_prime, eta_outer, prev_flags)
    eta_sampled = lobe_eta(desc, code)

    # mix in the other lobe when the sampled flags are not SPECULAR
    other_code = torch.where(idx == 1, desc.lobe[..., 0], desc.lobe[..., 1])
    non_spec = (flags & SPECULAR) == 0
    mix = non_spec & (desc.n_lobes >= 2) & ~lobe_static_specular(other_code)
    p_other = _lobe_pdf(desc, other_code, wo, wi, use_prime, eta_outer)
    f_other = _lobe_f(desc, other_code, wo, wi, use_prime, eta_outer)
    add = mix & (p_other > 0.0)
    pdf = pdf + torch.where(add, p_other, 0.0)
    f = f + torch.where(add[..., None], f_other, 0.0)
    # pdf /= numBxDFs only on the non-specular path (parity quirk)
    pdf = torch.where(non_spec, pdf / n_f, pdf)
    return f, wi, pdf, flags, alpha_i, eta_sampled

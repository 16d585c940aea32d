"""Wavefront path integrator with MIS, nested dielectrics, roughening, RR.

Counterpart of ``nart_tpu/integrators/path.py`` (reference
src/integrators/pathintegrator.cpp), balanced work-queue mode: every round
runs [light pass -> closest-hit query -> material resolve -> MIS direct
lighting (both strategies, one batched any-hit shadow query) -> scatter ->
nested-dielectric list update -> Russian roulette] on the whole wavefront
with masked lanes, then lanes whose path ended pull the next (pixel,
sample) work item.  The round loop is a Python loop; the per-item radiance
is written with ``index_add_``.  ``trace`` is the lockstep wavefront (one
bounce per round, no respawn), ``trace_regen`` the per-pixel sample
regeneration of the "regen" mode.

Gradients: ``make_bounce(differentiable=True)`` is the detached-sampling
estimator, and ``trace_balanced_loss`` differentiates the work queue by
path replay: rounds run forward without a graph, each round's carry and
traversal outputs are kept, and the backward pass re-runs the rounds in
reverse with the two queries answered from what was kept, so it never
traverses.

RNG: each work item owns an independent Xorshift32 stream seeded from its
global (sample, pixel) id (``_path_stream_seed``); draws happen at the
reference's sites and order, advanced only on lanes whose branch draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import bxdf, camera, rng
from ..bvh import intersect_bvh
from ..cluster_accel import (
    intersect_clusters,
    intersect_clusters_any,
    resolve_accel_kind,
)
from ..geometry import Hit, intersect_brute, pack_surface_rows, surface_at_packed
from ..lights import (
    area_pack_eval,
    area_pack_nearest,
    area_pack_sample,
    light_eval,
    light_sample,
    pack_area_lights,
)
from ..materials import make_bsdf, pack_tex_half
from ..scene import map_tensors

SHADOW_BIAS = float(np.float32(0.001))  # pathintegrator.h:36
INF = math.inf
STACK_K = 8  # nested-dielectric stack slots per lane
# parking spot for culled rays: far outside any scene box, so every slab
# test rejects them at once
_FAR_POINT = 1e8
_ONE_MINUS_EPS = float(np.float32(1.0) - np.float32(1.1920929e-07))
_RR_SCALE = float(np.float32(0.33333))

# nested-dielectric entries are packed: (stamp << 22) | (prio << 14) | mesh,
# 0 = empty (stamps start at 1)
_MESH_BITS = 14
_PRIO_BITS = 8
_MESH_MASK = (1 << _MESH_BITS) - 1
_PRIO_MASK = (1 << _PRIO_BITS) - 1


@dataclass
class IsectList:
    packed: torch.Tensor  # (N, K) int64, 0 = empty
    eta: torch.Tensor  # (N, K) float32
    next_stamp: torch.Tensor  # (N,) int64


def isect_list_init(n, device):
    return IsectList(
        packed=torch.zeros((n, STACK_K), dtype=torch.int64, device=device),
        eta=torch.ones((n, STACK_K), device=device),
        next_stamp=torch.ones(n, dtype=torch.int64, device=device),
    )


def _unpack(packed):
    occupied = packed != 0
    stamp = packed >> (_MESH_BITS + _PRIO_BITS)
    prio = (packed >> _MESH_BITS) & _PRIO_MASK
    mesh = packed & _MESH_MASK
    return occupied, stamp, prio, mesh


def _pick(table, idx):
    """table[r, idx[r]] per row."""
    return table.gather(1, idx[:, None])[:, 0]


def _put(table, idx, val, mask):
    """table with table[r, idx[r]] = val[r] on rows where mask."""
    oh = (idx[:, None] == torch.arange(table.shape[1], device=table.device))
    oh = oh & mask[:, None]
    return torch.where(oh, val[:, None].to(table.dtype), table)


def isect_list_query(lst: IsectList, mesh_id, priority):
    """IsectIsValid (pathintegrator.cpp:7-36): returns (valid, eta_outer)."""
    occupied, stamp, prio, mesh = _unpack(lst.packed)
    count = occupied.sum(-1)
    # newest and second-newest entries (stamp 0 for empty slots); argmax
    # returns the first maximum
    last = torch.argmax(stamp, dim=-1)
    everywhere = torch.ones_like(count, dtype=torch.bool)
    stamp2 = _put(stamp, last, torch.zeros_like(last), everywhere)
    penult = torch.argmax(stamp2, dim=-1)
    last_mesh = _pick(mesh, last)
    last_eta = _pick(lst.eta, last)
    penult_eta = _pick(lst.eta, penult)
    eta_outer = torch.where(
        count == 0, 1.0,
        torch.where(last_mesh != mesh_id, last_eta,
                    torch.where(count >= 2, penult_eta, 1.0)),
    )
    valid = ~torch.any(occupied & (priority[:, None] < prio), dim=-1)
    return valid, eta_outer


def isect_list_apply(lst: IsectList, mesh_id, priority, eta_sampled,
                     do_update):
    """UpdateIsectList (pathintegrator.cpp:123-142), masked by do_update:
    erase the newest slot matching mesh_id if present, else insert
    (mesh_id, priority, eta_sampled) into the first free slot."""
    occupied, stamp, _, mesh = _unpack(lst.packed)
    match = occupied & (mesh == mesh_id[:, None])
    has_match = match.any(-1)
    erase_slot = torch.argmax(torch.where(match, stamp, -1), dim=-1)
    packed = _put(lst.packed, erase_slot, torch.zeros_like(erase_slot),
                  do_update & has_match)
    free = packed == 0
    ins_slot = torch.argmax(free.to(torch.int32), dim=-1)
    do_insert = do_update & ~has_match & free.any(-1)
    new_entry = ((lst.next_stamp << (_MESH_BITS + _PRIO_BITS))
                 | (priority << _MESH_BITS) | mesh_id)
    packed = _put(packed, ins_slot, new_entry, do_insert)
    eta = _put(lst.eta, ins_slot, eta_sampled, do_insert)
    return IsectList(packed=packed, eta=eta,
                     next_stamp=lst.next_stamp + do_insert.to(torch.int64))


def _isect_list_reset(lst: IsectList, mask):
    m = mask[:, None]
    return IsectList(
        packed=torch.where(m, 0, lst.packed),
        eta=torch.where(m, 1.0, lst.eta),
        next_stamp=torch.where(mask, 1, lst.next_stamp),
    )


@dataclass
class Paths:
    """Wavefront state carried from round to round."""

    o: torch.Tensor  # (N, 3) ray origin
    d: torch.Tensor  # (N, 3) ray direction
    state: torch.Tensor  # (N,) int64 RNG state (uint32 value)
    beta: torch.Tensor  # (N, 3) throughput
    l: torch.Tensor  # (N, 3) radiance
    alpha: torch.Tensor  # (N,)
    alive: torch.Tensor  # (N,) bool
    flags: torch.Tensor  # (N,) int64 running BSDF flags
    eta_sampled: torch.Tensor  # (N,)
    alpha_tweak: torch.Tensor  # (N,)
    t_lim: torch.Tensor  # (N,) carried isect.tMax
    rays: torch.Tensor  # () int64 — rays traced (main + shadow)
    lst: IsectList


def _flip_sign(z):
    return torch.where(z > 0.0, 1.0, -1.0)


def _light_partition(lights, device):
    """(pack, rest_idx, row_of_light): packed area lights + the rest;
    row_of_light maps light index -> pack row (0 when unpacked)."""
    pack, rest = pack_area_lights(lights)
    row = torch.zeros(max(len(lights), 1), dtype=torch.int64, device=device)
    if pack is not None:
        for r, i in enumerate(pack.index):
            row[i] = r
    return pack, rest, row


def _nearest_light(lights, part, o, d, t_lim):
    """The per-bounce light pass (pathintegrator.cpp:167-182): (le, t,
    hit) of the nearest light closer than t_lim."""
    pack, rest, _ = part
    le = torch.zeros_like(o)
    t_best = t_lim
    hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    if pack is not None:
        p_le, p_t, p_hit = area_pack_nearest(pack, o, d, t_lim)
        le = torch.where(p_hit[:, None], p_le, le)
        t_best = torch.where(p_hit, p_t, t_best)
        hit = hit | p_hit
    for j in rest:
        ev = light_eval(lights[j], o, d)
        closer = ev.t < t_best
        le = torch.where(closer[:, None], ev.le, le)
        t_best = torch.where(closer, ev.t, t_best)
        hit = hit | closer
    return le, t_best, hit


def _in_pack(index, members):
    m = torch.zeros_like(index, dtype=torch.bool)
    for i in members:
        m = m | (index == i)
    return m


def _select_light_eval(lights, part, index, p, wi):
    """Evaluate light[index] per lane (packed disk/ring lights in one
    evaluation, env/distant lights one by one)."""
    pack, rest, row = part
    n = p.shape[0]
    le = torch.zeros_like(p)
    pdf = torch.zeros(n, device=p.device)
    t = torch.full((n,), INF, device=p.device)
    if pack is not None:
        in_pack = _in_pack(index, pack.index)
        ev = area_pack_eval(pack, row[index.clamp(0, len(lights) - 1)], p, wi)
        le = torch.where(in_pack[:, None], ev.le, le)
        pdf = torch.where(in_pack, ev.pdf, pdf)
        t = torch.where(in_pack, ev.t, t)
    for j in rest:
        ev = light_eval(lights[j], p, wi)
        m = index == j
        le = torch.where(m[:, None], ev.le, le)
        pdf = torch.where(m, ev.pdf, pdf)
        t = torch.where(m, ev.t, t)
    return le, pdf, t


def _select_light_sample(lights, part, index, p, u2):
    pack, rest, row = part
    n = p.shape[0]
    le = torch.zeros_like(p)
    wi = torch.zeros_like(p)
    pdf = torch.zeros(n, device=p.device)
    t = torch.full((n,), INF, device=p.device)
    if pack is not None:
        in_pack = _in_pack(index, pack.index)
        s_le, s_wi, s_pdf, s_t = area_pack_sample(
            pack, row[index.clamp(0, len(lights) - 1)], p, u2)
        le = torch.where(in_pack[:, None], s_le, le)
        wi = torch.where(in_pack[:, None], s_wi, wi)
        pdf = torch.where(in_pack, s_pdf, pdf)
        t = torch.where(in_pack, s_t, t)
    for j in rest:
        s_le, s_wi, s_pdf, s_t, _ = light_sample(lights[j], p, u2)
        m = index == j
        le = torch.where(m[:, None], s_le, le)
        wi = torch.where(m[:, None], s_wi, wi)
        pdf = torch.where(m, s_pdf, pdf)
        t = torch.where(m, s_t, t)
    return le, wi, pdf, t


def _expand8(v):
    """Spread 8 bits over 24 (every third position)."""
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _sort_key(scene_lo, scene_inv_extent, o, d, alive):
    """Ray-coherence sort key: direction octant + origin Morton cell; dead
    lanes sort last."""
    oct_ = ((d[:, 0] > 0).long() * 4 + (d[:, 1] > 0).long() * 2
            + (d[:, 2] > 0).long())
    u = torch.clamp((o - scene_lo) * scene_inv_extent, 0.0, 1.0)
    q = (u * 255.0).to(torch.int64)
    morton = ((_expand8(q[:, 0]) << 2) | (_expand8(q[:, 1]) << 1)
              | _expand8(q[:, 2]))
    key = (oct_ << 24) | (morton >> 3)
    return torch.where(alive, key, 0xFFFFFFFF)


def _sorted_query(query, key, o, d, t_min, t_max):
    """Run query on rays gathered in key order; scatter results back."""
    perm = torch.argsort(key, stable=True)
    out = query(o[perm], d[perm], t_min[perm], t_max[perm])
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    if isinstance(out, Hit):
        return Hit(*(x[inv] for x in out))
    return out[inv]


def _make_queries(scene, accel, params):
    """(isect, occluded) for the resolved accel kind."""
    kind = resolve_accel_kind(params.accel)
    if kind in ("brute", "bvh"):
        tri_v = scene.tri_v

        def isect(o, d, t_min, t_max):
            if kind == "bvh":
                return intersect_bvh(o, d, t_min, t_max, accel)
            return intersect_brute(o, d, t_min, t_max, tri_v, chunk=256)

        # no any-hit walk of its own: occlusion is the closest hit's
        # validity, as in the JAX package
        def occluded(o, d, t_min, t_max):
            return isect(o, d, t_min, t_max).valid

        return isect, occluded

    def closest(o, d, t_min, t_max):
        return intersect_clusters(o, d, t_min, t_max, accel)

    def anyhit(o, d, t_min, t_max):
        return intersect_clusters_any(o, d, t_min, t_max, accel)

    sort = params.sort_rays
    if sort is None:
        # coherence sorting pays only when rays see many clusters
        sort = accel.n_clusters > 64
    if not sort:
        return closest, anyhit
    tv = scene.tri_v.reshape(-1, 3)
    lo = tv.min(0).values
    inv_ext = 1.0 / torch.clamp(tv.max(0).values - lo, min=1e-12)

    def isect(o, d, t_min, t_max):
        key = _sort_key(lo, inv_ext, o, d, t_max > 0.0)
        return _sorted_query(closest, key, o, d, t_min, t_max)

    def occluded(o, d, t_min, t_max):
        key = _sort_key(lo, inv_ext, o, d, t_max > 0.0)
        return _sorted_query(anyhit, key, o, d, t_min, t_max)

    return isect, occluded


def make_bounce(scene, accel, params, differentiable=False, queries=None):
    """The per-round wavefront step: bounce_body(bounce (N,), paths) ->
    Paths.  Mirrors nart_tpu's _make_bounce step for step.

    differentiable=True gives the detached-sampling estimator: every
    sampling decision (sampled directions, the pdfs they are divided by,
    the Russian-roulette probability) is detached where the JAX package
    calls stop_gradient, so grad E[f/p] = E[grad f / p] with the sample
    fixed.  The forward values are the same bits either way (textures:
    where the texels are half floats, as the reference's are).  queries, an
    (isect, occluded) pair, replaces the scene's traversal queries (the
    path replay answers them from stored outputs)."""
    n_lights = len(scene.lights)
    gamma = float(np.float32(params.roughening_factor ** 2))
    surf_rows = pack_surface_rows(scene.tri_v, scene.tri_n, scene.tri_uv,
                                  scene.tri_mesh)
    light_part = _light_partition(scene.lights, scene.tri_v.device)
    # packed half textures on the render path (the reference's in-memory
    # textures are half, so its scenes read the same values); gradients
    # read the float32 table, as the JAX package's do
    tex_half = None
    if scene.tex_slots and not differentiable:
        tex_half = pack_tex_half(scene.tex_data)
    mesh_priority = scene.mesh_priority.long()
    isect, occluded = queries or _make_queries(scene, accel, params)
    lights = scene.lights

    def det(x):
        return x.detach() if differentiable else x

    def bounce_body(bounce, p: Paths) -> Paths:
        n = p.o.shape[0]
        dev = p.o.device
        zeros = torch.zeros(n, device=dev)
        # ---- light pass -------------------------------------------------
        le_cam, t_after_lights, light_hit = _nearest_light(
            lights, light_part, p.o, p.d, p.t_lim)
        light_hit = light_hit & p.alive
        alpha = torch.where(light_hit, 1.0, p.alpha)

        # ---- scene intersect (dead lanes parked far away, t_max = 0) -----
        o_main = torch.where(p.alive[:, None], p.o, _FAR_POINT)
        hit = isect(o_main, p.d, zeros,
                    torch.where(p.alive, t_after_lights, 0.0))
        surf = surface_at_packed(hit, surf_rows)

        # miss handling (pathintegrator.cpp:252-257)
        miss = p.alive & ~hit.valid
        l_out = torch.where((miss & (bounce == 0) & light_hit)[:, None],
                            le_cam, p.l)
        alive = p.alive & hit.valid

        # ---- material resolve ------------------------------------------
        frame, desc = make_bsdf(scene, surf.mesh, surf.st, surf.sn, surf.dpds,
                                p.alpha_tweak, tex_half=tex_half)
        prio = mesh_priority[surf.mesh.clamp(0, mesh_priority.shape[0] - 1)]
        valid, eta_outer = isect_list_query(p.lst, surf.mesh, prio)
        m_valid = alive & valid
        m_invalid = alive & ~valid
        alpha = torch.where(m_valid & (bounce == 0), 1.0, alpha)
        wo = bxdf.to_local(frame, -p.d)
        ones_b = torch.ones(n, dtype=torch.bool, device=dev)

        # ===== EstimateDirect (pathintegrator.cpp:38-121) ================
        # draw site 1: light pick
        u_pick, st8 = rng.masked_next_float(p.state, m_valid)
        light_idx = (torch.clamp(u_pick, max=_ONE_MINUS_EPS)
                     * float(n_lights)).to(torch.int64)
        # draw sites 2-4: strategy A scatter sample + lobe pick
        ua_x, st8 = rng.masked_next_float(st8, m_valid)
        ua_y, st8 = rng.masked_next_float(st8, m_valid)
        ua_l, st8 = rng.masked_next_float(st8, m_valid)
        fA, wiA, pdfA, dflags, _, _ = bxdf.bsdf_sample_f(
            desc, wo, ua_l, torch.stack([ua_x, ua_y], -1), ones_b, eta_outer,
            torch.zeros(n, dtype=torch.int64, device=dev))
        wiA, pdfA = det(wiA), det(pdfA)
        wiA_world = det(bxdf.to_world(frame, wiA))
        liA, light_pdf_A, tA = _select_light_eval(
            lights, light_part, light_idx, surf.p, wiA_world)
        light_pdf_A = det(light_pdf_A)
        # draw sites 5-6: strategy B light sample
        ub_x, st8 = rng.masked_next_float(st8, m_valid)
        ub_y, st8 = rng.masked_next_float(st8, m_valid)
        liB, wiB_world, light_pdf_B, tB = _select_light_sample(
            lights, light_part, light_idx, surf.p,
            torch.stack([ub_x, ub_y], -1))
        wiB_world, light_pdf_B = det(wiB_world), det(light_pdf_B)
        wiB = det(bxdf.to_local(frame, wiB_world))
        # strategy B's bsdf terms do not depend on occlusion: evaluated
        # before the shadow query so provably-zero lanes never trace
        pdfB = det(bxdf.bsdf_pdf(desc, wo, wiB, ones_b, eta_outer))
        fB = bxdf.bsdf_f(desc, wo, wiB, ones_b, eta_outer)

        # one batched shadow query for both strategies; lanes that cannot
        # contribute are parked with t_max = 0
        useA = (m_valid & (pdfA > 0.0)
                & ((light_pdf_A > 0.0) | (liA > 0.0).any(-1)))
        useB = (m_valid & (light_pdf_B > 0.0)
                & ((pdfB > 0.0) | (fB > 0.0).any(-1)))
        oA = surf.p + surf.gn * (SHADOW_BIAS * _flip_sign(wiA[..., 2]))[:, None]
        oB = surf.p + surf.gn * (SHADOW_BIAS * _flip_sign(wiB[..., 2]))[:, None]
        sh_o = torch.cat([torch.where(useA[:, None], oA, _FAR_POINT),
                          torch.where(useB[:, None], oB, _FAR_POINT)])
        sh_d = torch.cat([wiA_world, wiB_world])
        sh_t = torch.cat([torch.where(useA, tA, 0.0),
                          torch.where(useB, tB, 0.0)])
        occ = occluded(sh_o, sh_d, torch.zeros(2 * n, device=dev), sh_t)
        occA, occB = occ[:n], occ[n:]

        # strategy A contribution (BSDF sampling)
        wA_spec = (dflags & bxdf.SPECULAR) != 0
        misA = (pdfA * pdfA) / torch.clamp(
            pdfA * pdfA + light_pdf_A * light_pdf_A, min=1e-30)
        weightA = torch.where(wA_spec, 1.0, misA)
        addA = (m_valid & (pdfA > 0.0) & ~occA
                & (wA_spec | (light_pdf_A > 0.0)))
        if not params.mis_bsdf:
            addA = addA & False
        if not params.mis_light:
            weightA = torch.ones_like(weightA)
        contribA = fA * liA * (
            wiA[..., 2].abs() * weightA / torch.where(pdfA > 0, pdfA, 1.0)
        )[:, None]
        l_direct = torch.where(addA[:, None], contribA, 0.0)

        # strategy B contribution (light sampling)
        misB = (light_pdf_B * light_pdf_B) / torch.clamp(
            pdfB * pdfB + light_pdf_B * light_pdf_B, min=1e-30)
        addB = m_valid & ~occB & (light_pdf_B > 0.0) & (pdfB > 0.0)
        if not params.mis_light:
            addB = addB & False
        if not params.mis_bsdf:
            misB = torch.ones_like(misB)
        contribB = fB * liB * (
            wiB[..., 2].abs() * misB
            / torch.where(light_pdf_B > 0, light_pdf_B, 1.0)
        )[:, None]
        l_direct = l_direct + torch.where(addB[:, None], contribB, 0.0)
        l_out = l_out + torch.where(
            m_valid[:, None], l_direct * float(n_lights) * p.beta, 0.0)

        # ===== scatter (pathintegrator.cpp:199-220) ======================
        us_x, st8 = rng.masked_next_float(st8, m_valid)
        us_y, st8 = rng.masked_next_float(st8, m_valid)
        us_l, st8 = rng.masked_next_float(st8, m_valid)
        fS, wiS, pdfS, new_flags, alpha_i, eta_smp = bxdf.bsdf_sample_f(
            desc, wo, us_l, torch.stack([us_x, us_y], -1), ~ones_b,
            eta_outer, p.flags)
        wiS, pdfS = det(wiS), det(pdfS)
        pdf_ok = pdfS > 0.0
        go = m_valid & pdf_ok
        alpha_tweak = torch.where(go, (1.0 - gamma * alpha_i) * p.alpha_tweak,
                                  p.alpha_tweak)
        beta = torch.where(
            go[:, None],
            p.beta * fS * (wiS[..., 2].abs()
                           / torch.where(pdf_ok, pdfS, 1.0))[:, None],
            p.beta,
        )
        wiS_world = det(bxdf.to_world(frame, wiS))
        new_o = torch.where(
            go[:, None],
            surf.p + surf.gn * (SHADOW_BIAS * _flip_sign(wiS[..., 2]))[:, None],
            p.o,
        )
        new_d = torch.where(go[:, None], wiS_world, p.d)
        flags = torch.where(m_valid, new_flags, p.flags)
        eta_sampled = torch.where(m_valid, eta_smp, p.eta_sampled)

        # invalid (priority-skipped) branch (pathintegrator.cpp:223-229)
        u_eta, st8 = rng.masked_next_float(st8, m_invalid)
        eta_inv = bxdf.bsdf_sample_eta(desc, u_eta)
        new_o = torch.where(m_invalid[:, None], surf.p + p.d * SHADOW_BIAS,
                            new_o)
        new_d = torch.where(m_invalid[:, None], p.d, new_d)
        flags = torch.where(m_invalid, bxdf.TRANSMISSIVE, flags)
        eta_sampled = torch.where(m_invalid, eta_inv, eta_sampled)

        # lanes breaking on pdf <= 0 exit before the list update and RR
        no_break = torch.where(m_valid, pdf_ok, True)
        do_update = alive & no_break & ((flags & bxdf.TRANSMISSIVE) != 0)
        lst = isect_list_apply(p.lst, surf.mesh, prio, eta_sampled, do_update)

        # Russian roulette (pathintegrator.cpp:237-246): bounce > 3 only
        rr_mask = alive & no_break & (bounce > 3)
        u_rr, st8 = rng.masked_next_float(st8, rr_mask)
        # the survival probability is a sampling decision
        q = det(torch.clamp(beta.sum(-1) * _RR_SCALE, min=0.0))
        rr_live = q >= u_rr
        beta = torch.where((rr_mask & rr_live)[:, None],
                           beta / torch.where(q > 0, q, 1.0)[:, None], beta)
        alive = alive & no_break & ~(rr_mask & ~rr_live)

        return Paths(
            o=new_o, d=new_d, state=st8, beta=beta, l=l_out, alpha=alpha,
            alive=alive, flags=flags, eta_sampled=eta_sampled,
            alpha_tweak=alpha_tweak,
            t_lim=torch.where(alive, INF, p.t_lim),  # isect reset when live
            # algorithmic ray count: one camera/bounce ray per live lane +
            # the two EstimateDirect shadow rays per valid hit
            rays=p.rays + p.alive.sum() + 2 * m_valid.sum(),
            lst=lst,
        )

    return bounce_body


def _paths_init(o, d, state):
    n = o.shape[0]
    dev = o.device
    return Paths(
        o=o, d=d, state=state,
        beta=torch.ones((n, 3), device=dev),
        l=torch.zeros((n, 3), device=dev),
        alpha=torch.zeros(n, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        flags=torch.zeros(n, dtype=torch.int64, device=dev),
        eta_sampled=torch.ones(n, device=dev),
        alpha_tweak=torch.ones(n, device=dev),
        t_lim=torch.full((n,), INF, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        lst=isect_list_init(n, dev),
    )


def trace(scene, accel, o, d, state, params, differentiable=False):
    """Trace one wavefront of camera rays to radiance, all lanes in
    lockstep (one bounce per round, no respawn).

    Args:
      o, d: (N, 3) camera rays.
      state: (N,) int64 RNG states (already past the Latin-square draws).
      differentiable: detached-sampling estimator (see make_bounce); the
        result then carries the graph to the scene's tensors that require
        grad.  The graph holds every bounce's intermediates (the traversal
        queries have no backward, so a backward pass runs none): this is
        the route of small renders and the oracle of the gradient tests;
        trace_balanced_loss is the one whose memory stays O(lanes).
    Returns (L (N, 3), alpha (N,), state, rays (int, algorithmic count)).
    """
    bounce_body = make_bounce(scene, accel, params, differentiable)
    paths = _paths_init(o, d, state)
    bounce = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for _ in range(params.bounces):
        if not bool(paths.alive.any()):
            break
        paths = bounce_body(bounce, paths)
        bounce = bounce + 1
    return paths.l, paths.alpha, paths.state, int(paths.rays)


def _respawn(p: Paths, respawn, o, d, state):
    """Lanes in `respawn` start a fresh path on (o, d) with `state`."""
    rm = respawn[:, None]
    return Paths(
        o=torch.where(rm, o, p.o),
        d=torch.where(rm, d, p.d),
        state=state,
        beta=torch.where(rm, 1.0, p.beta),
        l=torch.where(rm, 0.0, p.l),
        alpha=torch.where(respawn, 0.0, p.alpha),
        alive=p.alive | respawn,
        flags=torch.where(respawn, 0, p.flags),
        eta_sampled=torch.where(respawn, 1.0, p.eta_sampled),
        alpha_tweak=torch.where(respawn, 1.0, p.alpha_tweak),
        t_lim=torch.where(respawn, INF, p.t_lim),
        rays=p.rays,
        lst=_isect_list_reset(p.lst, respawn),
    )


def trace_regen(scene, accel, px, py, samples, state, params):
    """Sample regeneration: every lane owns a pixel and runs the chunk's
    samples back to back on the pixel's own stream; when sample s ends its
    radiance goes to slot (s, lane) and the lane starts sample s + 1 in the
    same round.  The draws happen in the sequential renderer's per-pixel
    order (Latin square first, drawn by the caller; then each sample's path
    draws), so each sample's radiance is the same bits as trace()'s in the
    per-sample loop.

    Args:
      px, py: (N,) lane pixel coords.
      samples: (spp_chunk, N, 2) Latin-square jitters of this chunk.
      state: (N,) int64 RNG states, past the Latin-square draws.
    Returns (la (spp_chunk, N, 4), state, rays).  Splatting la sample by
    sample (film.splat_grid) gives the per-sample loop's film.
    """
    n, spp_chunk = px.shape[0], samples.shape[0]
    dev = px.device
    bounce_body = make_bounce(scene, accel, params)
    lane = torch.arange(n, dtype=torch.int64, device=dev)

    def cast(jit):
        return camera.cast_rays(scene.cam_to_world, scene.fov,
                                params.image_width, params.image_height,
                                px, py, jit)

    paths = _paths_init(*cast(samples[0]), state)
    bounce = torch.zeros(n, dtype=torch.int64, device=dev)
    samp = torch.zeros(n, dtype=torch.int64, device=dev)
    # rows past spp_chunk * n take the other lanes' zeros
    la_out = torch.zeros(((spp_chunk + 1) * n, 4), device=dev)
    while bool(paths.alive.any()):
        was_alive = paths.alive
        p = bounce_body(bounce, paths)
        # the reference's `for bounce < bounces` ends a sample after its
        # params.bounces'th iteration
        bounce_next = torch.where(was_alive, bounce + 1, bounce)
        alive = p.alive & (bounce_next < params.bounces)
        dying = was_alive & ~alive
        la = torch.cat([p.l, p.alpha[:, None]], dim=-1)
        slot = torch.where(dying, samp * n, spp_chunk * n) + lane
        la_out.index_add_(0, slot, torch.where(dying[:, None], la, 0.0))
        # the pixel's next sample, on the same stream
        nxt = samp + 1
        respawn = dying & (nxt < spp_chunk)
        samp = torch.where(dying, nxt, samp)
        o_new, d_new = cast(samples[nxt.clamp(max=spp_chunk - 1), lane])
        paths = _respawn(replace(p, alive=alive), respawn, o_new, d_new,
                         p.state)
        bounce = torch.where(respawn, 0, bounce_next)
    return (la_out[:spp_chunk * n].reshape(spp_chunk, n, 4), paths.state,
            int(paths.rays))


def _next_pow2(v):
    return 1 << int(np.ceil(np.log2(max(int(v), 1))))


def _path_stream_seed(item):
    """Independent RNG stream per (pixel, sample) work item: murmur3
    finalizer of the global item id (uint32), then rng.seed's offset."""
    h = item.to(torch.int64) & rng.MASK32
    h = h ^ (h >> 16)
    h = rng.mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = rng.mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return rng.seed(h)


def auto_lanes(total):
    """Work slots for `total` items: ~12 sqrt(total) rounded up to a power
    of two, at least 2^16, at most 2^19 and next_pow2(total)."""
    target = 12.0 * float(total) ** 0.5
    n = 1 << max(16, int(np.ceil(np.log2(max(target, 1.0)))))
    return min(n, 1 << 19, _next_pow2(total))


def item_pixels(render_w, pix_offset=0, row_map=None):
    """lp -> (px, py, global pixel id) for the local pixel index lp of a
    shard's items (the sharding arguments of the work-queue machines).

    Local items cover the pixels from global id pix_offset on, or, with
    row_map ((local_rows,) int64 tensor), local row r is global image row
    row_map[r] and pix_offset is ignored.  The defaults map lp to itself."""
    def pixels(lp):
        if row_map is None:
            pix = lp + pix_offset
            return pix % render_w, pix // render_w, pix
        px = lp % render_w
        py = row_map[lp // render_w]
        return px, py, py * render_w + px

    return pixels


def _balanced_machine(scene, accel, samples, params, render_w, render_h,
                      chunk_base, n_lanes, differentiable=False, queries=None,
                      pix_offset=0, n_pix_total=None, row_map=None):
    """Work-queue machinery: returns (core0, step) where step(core) ->
    (core', dying, la, item_before).  differentiable and queries go to
    make_bounce; pix_offset, n_pix_total and row_map place a shard's items
    in the global grid (item_pixels): an item's stream is seeded by its
    global id (chunk_base + s) * n_pix_total + pix, so the result does not
    depend on how the items are split."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    n = n_lanes or auto_lanes(total)
    n_pix_total = n_pix if n_pix_total is None else n_pix_total
    dev = samples.device
    bounce_body = make_bounce(scene, accel, params, differentiable, queries)
    samples_flat = samples.reshape(total, 2)
    pixels = item_pixels(render_w, pix_offset, row_map)

    def spawn(item):
        it = item.clamp(0, total - 1)
        jit = samples_flat[it]
        s = it // n_pix
        px, py, pix = pixels(it % n_pix)
        o, d = camera.cast_rays(scene.cam_to_world, scene.fov,
                                params.image_width, params.image_height,
                                px, py, jit)
        gid = ((chunk_base + s) * n_pix_total + pix) & rng.MASK32
        return o, d, _path_stream_seed(gid)

    item0 = torch.arange(n, dtype=torch.int64, device=dev)
    o0, d0, st0 = spawn(item0)
    paths0 = replace(_paths_init(o0, d0, st0), alive=item0 < total)
    core0 = (paths0, torch.zeros(n, dtype=torch.int64, device=dev), item0,
             torch.tensor(min(n, total), dtype=torch.int64, device=dev))

    def step(core):
        paths, bounce, item, head = core
        was_alive = paths.alive
        p = bounce_body(bounce, paths)
        bounce_next = torch.where(was_alive, bounce + 1, bounce)
        alive = p.alive & ~(p.alive & (bounce_next >= params.bounces))
        dying = was_alive & ~alive
        la = torch.cat([p.l, p.alpha[:, None]], dim=-1)
        item_before = item

        # pull the next queue items (prefix sum over this round's deaths)
        dy = dying.to(torch.int64)
        new_item = head + torch.cumsum(dy, 0) - dy
        respawn = dying & (new_item < total)
        head = head + dy.sum()
        item = torch.where(dying, new_item, item)

        o_new, d_new, st_new = spawn(new_item)
        paths = _respawn(replace(p, alive=alive), respawn, o_new, d_new,
                         torch.where(respawn, st_new, p.state))
        bounce = torch.where(respawn, 0, bounce_next)
        return (paths, bounce, item, head), dying, la, item_before

    return core0, step


def trace_balanced(scene, accel, samples, params, render_w, render_h,
                   chunk_base=0, n_lanes=0, pix_offset=0, n_pix_total=None,
                   row_map=None):
    """Work-queue wavefront: lanes pull (pixel, sample) items on death.

    Args:
      samples: (spp_chunk, P, 2) per-pixel Latin-square jitters, P =
        render_w * render_h (row-major pixel grid), or a shard's P pixels.
      chunk_base: first global sample index of this chunk.
      n_lanes: work slots; 0 = auto_lanes(spp_chunk * P).
      pix_offset, n_pix_total, row_map: a shard's place in the global grid
        of n_pix_total pixels (see item_pixels); the defaults are the whole
        grid.
    Returns (la (spp_chunk, P, 4) per-sample RGBA radiance, rays, rounds):
    rays is the algorithmic ray count (int), rounds the round count.
    """
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    core, step = _balanced_machine(scene, accel, samples, params, render_w,
                                   render_h, chunk_base, n_lanes,
                                   pix_offset=pix_offset,
                                   n_pix_total=n_pix_total, row_map=row_map)
    n = core[1].shape[0]
    # finished items add their radiance once; other lanes add zeros to
    # distinct rows past the end, so no per-round host sync is needed
    la_out = torch.zeros((total + n, 4), device=samples.device)
    lane = torch.arange(n, device=samples.device)
    rounds = 0
    while bool(core[0].alive.any()):
        core, dying, la, item = step(core)
        tgt = torch.where(dying, item, total + lane)
        la_out.index_add_(0, tgt, torch.where(dying[:, None], la, 0.0))
        rounds += 1
    return (la_out[:total].reshape(spp_chunk, n_pix, 4),
            int(core[0].rays), rounds)


class _QueryTape:
    """The two traversal queries of a round: run and remembered on the way
    forward, answered from what was remembered when ``replaying``."""

    def __init__(self, isect=None, occluded=None):
        self._isect, self._occluded = isect, occluded
        self.hit = self.occ = None
        self.replaying = isect is None

    def isect(self, *rays):
        if not self.replaying:
            self.hit = self._isect(*rays)
        return self.hit

    def occluded(self, *rays):
        if not self.replaying:
            self.occ = self._occluded(*rays)
        return self.occ


# the float leaves of the carry that can depend on a trainable parameter.
# Origins, directions and t_lim come from geometry and detached samples,
# alpha from constants: their adjoints are never needed.
_ADJOINT_FIELDS = ("beta", "l", "eta_sampled", "alpha_tweak")


def _adjoint_leaves(p: Paths):
    return [getattr(p, f) for f in _ADJOINT_FIELDS] + [p.lst.eta]


def _with_adjoint_leaves(p: Paths, vals):
    return replace(p, **dict(zip(_ADJOINT_FIELDS, vals)),
                   lst=replace(p.lst, eta=vals[-1]))


def scene_leaves(scene):
    """The scene's distinct tensors that require grad, in field order."""
    seen = {}
    map_tensors(scene, lambda t: seen.setdefault(id(t), t)
                if t.requires_grad else t)
    return list(seen.values())


class _BalancedReplay:
    """Path replay over the work queue: sum(cot * la) and its gradient
    with respect to the scene's tensors that require grad."""

    def __init__(self, scene, accel, samples, cot, params, render_w,
                 render_h, chunk_base, n_lanes, shard):
        self.scene, self.accel, self.samples = scene, accel, samples
        self.machine_args = (params, render_w, render_h, chunk_base, n_lanes)
        self.shard = shard  # pix_offset, n_pix_total, row_map
        self.total = samples.shape[0] * samples.shape[1]
        self.cot_flat = cot.reshape(self.total, 4)
        self.params = params
        self.leaves = scene_leaves(scene)
        self.saved = []  # per round: (incoming carry, Hit, occ)
        self.rays = 0

    def _contribution(self, dying, la, item):
        c = self.cot_flat[item.clamp(0, self.total - 1)]
        return ((c * la).sum(-1) * dying.to(la.dtype)).sum()

    def forward(self):
        """Run the rounds without a graph, keeping each round's incoming
        carry and traversal outputs; returns the loss (a detached scalar)."""
        with torch.no_grad():
            tape = _QueryTape(*_make_queries(self.scene, self.accel,
                                             self.params))
            core, step = _balanced_machine(
                self.scene, self.accel, self.samples, *self.machine_args,
                differentiable=True, queries=(tape.isect, tape.occluded),
                **self.shard)
            loss = torch.zeros((), device=self.samples.device)
            while bool(core[0].alive.any()):
                core_in = core
                core, dying, la, item = step(core)
                self.saved.append((core_in, tape.hit, tape.occ))
                loss = loss + self._contribution(dying, la, item)
            self.rays = int(core[0].rays)
        return loss

    def backward(self, g):
        """g * d loss / d leaf for every leaf (None where the loss does not
        depend on it): walks the rounds backwards, re-runs each with the
        graph on and the two queries answered from the record, and pushes
        the carry's adjoint through it.  No traversal query runs."""
        tape = _QueryTape()
        with torch.enable_grad():
            proxies = [x.detach().requires_grad_() for x in self.leaves]
            swap = {id(x): p for x, p in zip(self.leaves, proxies)}
            scene = map_tensors(self.scene, lambda t: swap.get(id(t), t))
            _, step = _balanced_machine(
                scene, self.accel, self.samples, *self.machine_args,
                differentiable=True, queries=(tape.isect, tape.occluded),
                **self.shard)
            grads = [None] * len(proxies)
            adjoint = None  # of the carry after the round at hand
            for core_in, hit, occ in reversed(self.saved):
                tape.hit, tape.occ = hit, occ
                carry = [x.detach().requires_grad_()
                         for x in _adjoint_leaves(core_in[0])]
                core_out, dying, la, item = step(
                    (_with_adjoint_leaves(core_in[0], carry),) + core_in[1:])
                outs, outs_grad = [self._contribution(dying, la, item)], [g]
                if adjoint is not None:
                    for y, a in zip(_adjoint_leaves(core_out[0]), adjoint):
                        if a is not None and y.requires_grad:
                            outs.append(y)
                            outs_grad.append(a)
                # retain_graph: the rounds share the tables make_bounce
                # derived from the proxies; each round's own graph goes
                # when its tensors do
                res = torch.autograd.grad(outs, carry + proxies, outs_grad,
                                          allow_unused=True,
                                          retain_graph=True)
                adjoint = res[:len(carry)]
                for i, r in enumerate(res[len(carry):]):
                    if r is not None:
                        grads[i] = r if grads[i] is None else grads[i] + r
        self.saved = []
        return grads


class ReplayLoss(torch.autograd.Function):
    """A replay (an object with forward() -> loss and backward(g) -> the
    leaves' gradients) as one differentiable function of the scene's
    leaves."""

    @staticmethod
    def forward(ctx, replay, *leaves):
        ctx.replay = replay
        return replay.forward()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None, *ctx.replay.backward(g))


def trace_balanced_loss(scene, accel, samples, cot, params, render_w,
                        render_h, n_rounds=None, chunk_base=0, n_lanes=0,
                        pix_offset=0, n_pix_total=None, row_map=None):
    """Differentiable balanced wavefront: scalar loss = sum(cot * la),
    with gradients by path replay.

    The loss is a function of the scene's tensors that require grad
    (``loss.backward()`` or ``torch.autograd.grad`` reach them).  The
    forward pass runs the work queue without a graph and keeps, per round,
    the incoming carry and the outputs of the two traversal queries
    (O(lanes) per round); the backward pass walks the rounds in reverse,
    re-runs each round's shading with the graph on and the queries answered
    from what was kept, and pushes the carry's adjoint through it: one
    extra forward of shading per round and **no traversal** in the backward
    pass.  For an arbitrary image loss, linearise first (the splat is
    linear in la) and pass d loss / d la as ``cot``.

    Args:
      cot: (spp_chunk, P, 4) cotangent of the per-sample radiance.
      n_rounds: accepted and ignored.  The JAX package needs a static trip
        count for reverse mode; here the loop ends when no lane is alive.
      pix_offset, n_pix_total, row_map: a shard's place in the global grid,
        as for trace_balanced.
    Returns (loss, rays, unfinished, rounds): unfinished is always 0, rays
    is one forward's algorithmic count, rounds the measured round count.
    """
    replay = _BalancedReplay(scene, accel, samples, cot, params, render_w,
                             render_h, chunk_base, n_lanes,
                             dict(pix_offset=pix_offset,
                                  n_pix_total=n_pix_total, row_map=row_map))
    loss = ReplayLoss.apply(replay, *replay.leaves)
    return loss, replay.rays, 0, len(replay.saved)

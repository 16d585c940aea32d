"""Tiny programmatic scenes for tests and smoke runs.

Counterpart of ``nart_tpu/testing.py``; scenes are built on the CPU (move
them with ``.to(device)``).
"""

import dataclasses

import numpy as np
import torch

from . import bxdf
from .scene import (
    LIGHT_DISK,
    LIGHT_DISTANT,
    LIGHT_ENV,
    MAT_GLASS,
    MAT_GLOSSY,
    MAT_LAMBERT,
    MAT_PLASTIC,
    LightData,
    MediumData,
    SceneData,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def env_scene(materials=("lambert",), tex_h=4, tex_w=8, intensity=2.0, **kw):
    """simple_scene lit by an environment light with a small Le texture and
    no importance distribution (uniform-sphere sampling, pattern Pdf()=1)."""
    base = simple_scene(materials, **kw)
    v = np.linspace(0.3, 1.2, tex_h * tex_w, dtype=np.float32)
    le_tex = np.stack([v, v * 0.8, v * 0.5], -1).reshape(tex_h, tex_w, 3)
    env = LightData(
        kind=LIGHT_ENV, xf=_t(np.eye(4, dtype=np.float32)), radius=0.0,
        inner_radius=0.0, intensity=torch.tensor(intensity, dtype=torch.float32),
        le_const=torch.zeros(3), le_tex=_t(le_tex), env2d=None,
    )
    return dataclasses.replace(base, lights=[env])


def medium_scene(sigma_a, sigma_s, le=(0.0, 0.0, 0.0), density=None,
                 env=1.0):
    """simple_scene(("lambert",)) in a medium filling [-1, 1]^3 (density
    (4, 4, 4) ones unless given, majorant max density * (sigma_a +
    sigma_s)), lit by a constant environment light of intensity env."""
    dens = (np.ones((4, 4, 4), np.float32) if density is None
            else np.asarray(density, np.float32))
    medium = MediumData(
        bounds_min=torch.full((3,), -1.0), bounds_max=torch.full((3,), 1.0),
        sigma_a=torch.tensor(sigma_a, dtype=torch.float32),
        sigma_s=torch.tensor(sigma_s, dtype=torch.float32),
        le=torch.tensor(le, dtype=torch.float32), density=_t(dens),
        sigma_maj=float(dens.max()) * (sigma_a + sigma_s))
    env_light = LightData(
        kind=LIGHT_ENV, xf=_t(np.eye(4, dtype=np.float32)), radius=0.0,
        inner_radius=0.0, intensity=torch.tensor(env, dtype=torch.float32),
        le_const=torch.ones(3), le_tex=None, env2d=None)
    return dataclasses.replace(simple_scene(("lambert",)), lights=[env_light],
                               medium=medium)


def quad(center, size, axis=2, flip=False):
    """Two triangles forming a square perpendicular to `axis` (numpy)."""
    c = np.asarray(center, np.float32)
    a0, a1 = [(1, 2), (0, 2), (0, 1)][axis]
    corners = []
    for du, dv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
        p = c.copy()
        p[a0] += du * size
        p[a1] += dv * size
        corners.append(p)
    c0, c1, c2, c3 = corners
    tris = np.array([[c0, c1, c2], [c0, c2, c3]], np.float32)
    n = np.zeros(3, np.float32)
    n[axis] = -1.0 if flip else 1.0
    nrm = np.tile(n, (2, 3, 1)).astype(np.float32)
    uv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                  np.float32)
    return tris, nrm, uv


def simple_scene(materials=("lambert",), light_z=3.0, light_r=0.8,
                 intensity=20.0, eta=1.5, roughness=0.4, priorities=None):
    """Stacked horizontal quads (one per material) + a disk light above.

    Quad k sits at z = -k (camera looks down -z from z=5).
    """
    tri_v, tri_n, tri_uv, tri_mesh = [], [], [], []
    mat_codes = {"lambert": MAT_LAMBERT, "glossy": MAT_GLOSSY,
                 "glass": MAT_GLASS, "plastic": MAT_PLASTIC}
    mtypes = []
    for k, m in enumerate(materials):
        v, n, uv = quad([0, 0, -float(k)], 2.0 - 0.3 * k, axis=2)
        tri_v.append(v)
        tri_n.append(n)
        tri_uv.append(uv)
        tri_mesh.append(np.full(2, k, np.int32))
        mtypes.append(mat_codes[m])
    m = len(materials)
    xf = np.eye(4, dtype=np.float32)
    xf[2, 3] = light_z  # light at z, facing -z (down)
    light = LightData(
        kind=LIGHT_DISK, xf=_t(xf), radius=light_r, inner_radius=0.0,
        intensity=torch.tensor(intensity, dtype=torch.float32),
        le_const=torch.ones(3), le_tex=None, env2d=None,
    )
    cam = np.eye(4, dtype=np.float32)
    cam[2, 3] = 5.0  # camera at z=5 looking down -z
    return SceneData(
        tri_v=_t(np.concatenate(tri_v)),
        tri_n=_t(np.concatenate(tri_n)),
        tri_uv=_t(np.concatenate(tri_uv)),
        tri_mesh=_t(np.concatenate(tri_mesh)),
        mesh_priority=_t(np.asarray(priorities or [0] * m, np.int32)),
        mat_type=_t(np.asarray(mtypes, np.int32)),
        rho_d_const=_t(np.tile(np.float32([0.6, 0.4, 0.2]), (m, 1))),
        rho_d_tex=_t(np.full(m, -1, np.int32)),
        rho_s_const=_t(np.ones((m, 3), np.float32)),
        rho_s_tex=_t(np.full(m, -1, np.int32)),
        tau_const=_t(np.ones((m, 3), np.float32)),
        tau_tex=_t(np.full(m, -1, np.int32)),
        eta_const=_t(np.full(m, eta, np.float32)),
        eta_tex=_t(np.full(m, -1, np.int32)),
        alpha_const=_t(np.full(m, roughness * roughness, np.float32)),
        alpha_tex=_t(np.full(m, -1, np.int32)),
        has_normal=_t(np.zeros(m, bool)),
        normal_const=_t(np.zeros((m, 3), np.float32)),
        normal_tex=_t(np.full(m, -1, np.int32)),
        tex_data=_t(np.zeros((1, 3), np.float32)),
        tex_off=_t(np.zeros(1, np.int32)),
        tex_w=_t(np.ones(1, np.int32)),
        tex_h=_t(np.ones(1, np.int32)),
        lights=[light],
        cam_to_world=_t(cam),
        fov=30.0,
        medium=None,
        n_meshes=m,
        n_tris=2 * m,
    )


def distant_scene(materials=("lambert", "glass")):
    """simple_scene lit by a distant light (shining down -z) as well."""
    base = simple_scene(materials)
    sun = LightData(kind=LIGHT_DISTANT, xf=torch.eye(4), radius=0.0,
                    inner_radius=0.0, intensity=torch.tensor(1.0),
                    le_const=torch.ones(3), le_tex=None, env2d=None)
    return dataclasses.replace(base, lights=base.lights + [sun])


# (lobe 0, lobe 1, n_lobes) of the materials' lobe mixes: all five lobe
# codes, plastic's two mixes and mirror (tests/test_torch_shading.py's
# LOBES)
BSDF_LOBES = {
    "lambert": (bxdf.L_LAMBERT, -1, 1),
    "plastic": (bxdf.L_LAMBERT, bxdf.L_TS, 2),
    "plastic_spec": (bxdf.L_LAMBERT, bxdf.L_SPECULAR, 2),
    "glossy": (bxdf.L_TS, -1, 1),
    "glass_rough": (bxdf.L_DIELECTRIC, -1, 1),
    "glass_delta": (bxdf.L_SPECDIEL, -1, 1),
    "mirror": (bxdf.L_SPECULAR, -1, 1),
}


def bsdf_lane_set(kind, n, seed, device="cpu"):
    """n lanes of one BSDF_LOBES kind from a numpy seed, drawn as
    tests/test_torch_shading.py draws them: a BsdfDesc and a sample call's
    and an eval call's inputs (directions in the upper hemisphere but for
    glass; eta_outer the lane's eta on a fifth of the lanes), and random
    cotangents of f, alpha_i and eta_sampled.  Returns a dict of tensors
    on `device` (desc, wo, wi, use_prime, eta_outer, u1, u2, prev_flags,
    g_f, g_alpha_i, g_eta_sampled)."""
    l0, l1, n_lobes = BSDF_LOBES[kind]
    g = np.random.default_rng(seed)
    alpha = g.uniform(0.01, 0.8, n).astype(np.float32)
    eta = g.uniform(1.2, 2.0, n).astype(np.float32)
    upper = not kind.startswith("glass")

    def dirs():
        w = g.normal(size=(n, 3)).astype(np.float32)
        if upper:
            w[:, 2] = np.abs(w[:, 2]) + 0.05
        return w / np.linalg.norm(w, axis=-1, keepdims=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    desc = bxdf.BsdfDesc(
        n_lobes=t(np.full(n, n_lobes, np.int64)),
        lobe=t(np.tile(np.array([l0, l1], np.int64), (n, 1))),
        rho_d=t(g.random((n, 3), dtype=np.float32)),
        rho_s=t(g.random((n, 3), dtype=np.float32)),
        tau=t(g.random((n, 3), dtype=np.float32)), eta=t(eta),
        alpha0=t(np.maximum(alpha, np.float32(1e-4))),
        alpha_prime=t((alpha * g.uniform(0.5, 1.5, n)).astype(np.float32)))
    return dict(
        desc=desc, wo=t(dirs()), wi=t(dirs()),
        use_prime=t(g.random(n) < 0.5),
        eta_outer=t(np.where(g.random(n) < 0.2, eta, 1.0).astype(
            np.float32)),
        u1=t(g.random(n, dtype=np.float32)),
        u2=t(g.random((n, 2), dtype=np.float32)),
        prev_flags=t(g.integers(0, 16, n).astype(np.int64)),
        g_f=t(g.normal(size=(n, 3)).astype(np.float32)),
        g_alpha_i=t(g.normal(size=n).astype(np.float32)),
        g_eta_sampled=t(g.normal(size=n).astype(np.float32)))


def bit_share(got, want):
    """The share of the float32 values in the tensors got that have the
    bits of the tensors want, paired in order (X3 against its first
    design)."""
    return (sum(int((a.view(torch.int32) == b.view(torch.int32)).sum())
                for a, b in zip(got, want))
            / sum(a.numel() for a in got))


def mid_trace_bsdf(make_session, rounds=8):
    """The inputs of a path round's two BSDF calls (strategy A's sample
    with strategy B's eval, the scatter's sample) mid-trace: of the first
    `rounds` rounds of a per-round render (make_session() -> a
    RenderSession with per_round=True, stopped there by
    round_ops.stop_after if it runs longer), the one with the most live
    lanes in their second or later bounce (the first rounds of a chunk
    trace its first rows' camera rays: macbeth's are sky).
    Returns (that round, those lanes, {"sample A + eval B": {...},
    "scatter": {...}}: each call's tensors, copied; split_sample_eval
    gives the first's sample and eval calls)."""
    from . import bsdf_ops, round_ops
    from .integrators import path

    per_round = []  # (lanes past their first bounce, [calls])
    real = (bsdf_ops.sample_f, bsdf_ops.sample_eval_f)
    sample = ("desc", "wo", "u1", "u2", "use_prime", "eta_outer",
              "prev_flags")

    def copy(t):
        return t.detach().clone(memory_format=torch.contiguous_format)

    def keep(fn, names, args):
        per_round[-1][1].append({
            k: bxdf.BsdfDesc(*map(copy, v)) if k == "desc" else copy(v)
            for k, v in zip(names, args)})
        return fn(*args)

    def new_round(bounce, p, *tables):
        per_round.append((int((p.alive & (bounce >= 1)).sum()), []))

    bsdf_ops.sample_f = lambda *a: keep(real[0], sample, a)
    bsdf_ops.sample_eval_f = lambda *a: keep(real[1], sample + ("wi_b",), a)
    make_bounce = round_ops.stop_after(path, "make_bounce", rounds,
                                       {"rounds": 0}, new_round)
    try:
        make_session().render()  # a render of fewer rounds ends itself
    except round_ops.Done:
        pass
    finally:
        bsdf_ops.sample_f, bsdf_ops.sample_eval_f = real
        path.make_bounce = make_bounce
    best = max(range(len(per_round)), key=lambda r: per_round[r][0])
    lanes, calls = per_round[best]
    return best + 1, lanes, dict(zip(("sample A + eval B", "scatter"),
                                     calls))


def split_sample_eval(s):
    """A sample_eval_f call's inputs s (mid_trace_bsdf's "sample A + eval
    B") as its sample call's and its eval call's: (sample_f's inputs,
    eval_f_pdf's, wi the eval direction wi_b), dicts sharing s's tensors."""
    sample = {k: v for k, v in s.items() if k != "wi_b"}
    evaluate = {k: s[k] for k in ("desc", "wo", "use_prime", "eta_outer")}
    evaluate["wi"] = s["wi_b"]
    return sample, evaluate


def tiled(s, times):
    """A lane set's tensors (a BsdfDesc's too) repeated `times` times
    along the lanes, contiguous."""
    def tile(t):
        return torch.cat([t] * times).contiguous()
    return {k: bxdf.BsdfDesc(*map(tile, v)) if k == "desc" else tile(v)
            for k, v in s.items()}


# vol_lane_set's medium: an 8^3 grid in an asymmetric box, its corner
# block of 5^3 points at the majorant (p_absorb 0.25 and p_scatter 0.75
# there, so p_null rounds to 0 or about it), the opposite block of 3^3 at
# NEAR_MAJORANT of it (p_null 1e-3), the rest in [0.1, 0.9]
VOL_BOUNDS = ((-1.0, -0.5, -2.0), (1.0, 1.5, 0.5))
VOL_SIGMA = (2.5, 7.5)
NEAR_MAJORANT = 0.999


def vol_medium(device="cpu", seed=0):
    """vol_lane_set's medium (MediumData on device) and its density grid
    (numpy, (Z, Y, X))."""
    g = np.random.default_rng(seed)
    dens = g.uniform(0.1, 0.9, (8, 8, 8)).astype(np.float32)
    dens[:5, :5, :5] = 1.0
    dens[5:, 5:, 5:] = NEAR_MAJORANT
    sa, ss = VOL_SIGMA
    medium = MediumData(
        bounds_min=_t(np.float32(VOL_BOUNDS[0])).to(device),
        bounds_max=_t(np.float32(VOL_BOUNDS[1])).to(device),
        sigma_a=torch.tensor(sa, dtype=torch.float32, device=device),
        sigma_s=torch.tensor(ss, dtype=torch.float32, device=device),
        le=torch.tensor([0.4, 0.3, 0.2], device=device),
        density=_t(dens).to(device),
        sigma_maj=float(dens.max()) * (sa + ss))
    return medium, dens


def vol_lane_set(n, seed, device="cpu", bounces=2):
    """n lanes of the volume's walk state from a numpy seed, each of a
    kind that makes a flight step take one of its branches: dead lanes,
    segments starting inside the box (some along an axis: d == 0 on one or
    two axes), from outside it toward it and away from it (a missed box),
    lanes in flight (t_exit from the box, or just past t_cur: the segment
    is left, or far past the box: the medium is left), lanes in flight in
    the block at the majorant (p_null rounds to 0 or about it), lanes
    standing on the box's lower corner (d = 0, so p is that grid point:
    the density there is the majorant's exactly) with u_mode 1 (the null
    event at p_null = 0 in their first step), lanes in flight in the block
    at NEAR_MAJORANT with u_mode above it (the null event at p_null
    1e-3, whose float32 value is off by ~1e-4 of itself), bounce counts
    around the limit `bounces`.
    Returns a dict: vs (a vol_ops.VolState), medium, cells
    (media.pack_density_cells), sigma_maj (a () tensor), bounces, g_beta
    and g_l (random cotangents (n, 3)), kind (n,) int (the lane's kind, an
    index into VOL_KINDS), all on `device`."""
    from .media import clip_to_aabb, pack_density_cells
    from .vol_ops import VolState

    g = np.random.default_rng(seed)
    medium, _ = vol_medium("cpu", seed)
    lo, hi = (np.float32(b) for b in VOL_BOUNDS)
    kind = g.integers(0, len(VOL_KINDS), n)

    def unit(m):
        w = g.normal(size=(m, 3)).astype(np.float32)
        return (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(
            np.float32)

    o = g.uniform(lo + 0.05, hi - 0.05, (n, 3)).astype(np.float32)
    d = unit(n)
    k = VOL_KINDS.index
    axis = kind == k("axis")
    d[axis] = np.float32([0.0, 0.0, 1.0])
    two = axis & (g.random(n) < 0.5)
    d[two] = np.float32([0.6, 0.0, 0.8])
    # from outside: toward the box's centre, or away from it
    out = (kind == k("outside")) | (kind == k("missed"))
    c = (lo + hi) / 2
    o[out] = c + 3.0 * unit(int(out.sum()))
    toward = c - o[out]
    toward /= np.linalg.norm(toward, axis=-1, keepdims=True)
    d[out] = np.where((kind[out] == k("outside"))[:, None], toward,
                      -toward).astype(np.float32)
    # in the majorant block (cells 0 and 1 on each axis)
    maj = kind == k("majorant")
    span = (hi - lo) * np.float32(4.0 / 7.0)
    o[maj] = (lo + g.uniform(0.1, 0.9, (int(maj.sum()), 3)).astype(
        np.float32) * span).astype(np.float32)
    d = d.astype(np.float32)
    o = o.astype(np.float32)
    _, t0, t1 = clip_to_aabb(_t(o), _t(d), medium.bounds_min,
                             medium.bounds_max)
    t_cur = np.zeros(n, np.float32)
    t_exit = t1.numpy().copy()
    flight = ~np.isin(kind, [k("segment"), k("axis"), k("outside"),
                             k("missed"), k("dead")])
    t_cur[flight] = (g.uniform(0.0, 0.3, n) * np.maximum(t_exit, 0.0))[
        flight].astype(np.float32)
    short = kind == k("leave_segment")
    t_exit[short] = t_cur[short] + np.float32(1e-3)
    far = kind == k("leave_medium")
    t_exit[far] = 50.0
    t_cur[maj] = 0.0
    near = kind == k("near_majorant")
    o[near] = (hi - g.uniform(0.1, 0.9, (int(near.sum()), 3)).astype(
        np.float32) * ((hi - lo) * np.float32(2.0 / 7.0))).astype(np.float32)
    corner = kind == k("null_at_majorant")
    o[corner] = lo
    d[corner] = 0.0
    t_cur[corner] = 0.0
    t_exit[corner] = 50.0
    u_mode = g.random(n, dtype=np.float32)
    u_mode[corner] = 1.0
    u_mode[near] = g.uniform(NEAR_MAJORANT + 2e-4, 1.0 - 1e-5,
                             int(near.sum())).astype(np.float32)
    alive = kind != k("dead")
    new_ray = np.isin(kind, [k("segment"), k("axis"), k("outside"),
                             k("missed")])
    bounce = g.integers(0, bounces + 2, n).astype(np.int64)
    state = g.integers(1, 2 ** 32, n).astype(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    vs = VolState(
        alive=t(alive), new_ray=t(new_ray), bounce=t(bounce),
        u_mode=t(u_mode), t_cur=t(t_cur), t_exit=t(t_exit), o=t(o), d=t(d),
        state=t(state),
        beta=t(g.uniform(0.5, 1.5, (n, 3)).astype(np.float32)),
        l_out=t(g.uniform(0.0, 1.0, (n, 3)).astype(np.float32)))
    medium = medium.to(device)
    return dict(vs=vs, medium=medium,
                cells=pack_density_cells(medium.density),
                sigma_maj=torch.tensor(float(np.float32(medium.sigma_maj)),
                                       device=device),
                bounces=bounces, kind=t(kind),
                g_beta=t(g.normal(size=(n, 3)).astype(np.float32)),
                g_l=t(g.normal(size=(n, 3)).astype(np.float32)))


VOL_KINDS = ("dead", "segment", "axis", "outside", "missed", "flight",
             "leave_segment", "leave_medium", "majorant", "null_at_majorant",
             "near_majorant")


def vol_round_states(make_session, rounds):
    """The arguments of the volume machine's flight_steps calls in the
    rounds `rounds` (1-based) of a render (make_session() -> a
    RenderSession, per_round=True), copied: {round: (vs, k, cells, medium,
    sigma_maj, bounces)}.  The render stops after the last."""
    from . import round_ops, vol_ops
    from .integrators import volume

    real = vol_ops.flight_steps
    seen = {"rounds": 0}
    out = {}

    def copy(t):
        return t.detach().clone(memory_format=torch.contiguous_format)

    def keep(vs, k, cells, medium, sigma_maj, bounces, seg=None):
        if seen["rounds"] in rounds:
            out[seen["rounds"]] = (
                vol_ops.VolState(*[copy(getattr(vs, f))
                                   for f in vol_ops.FIELDS]),
                k, copy(cells), medium, copy(sigma_maj), bounces)
        return real(vs, k, cells, medium, sigma_maj, bounces, seg)

    vol_ops.flight_steps = keep
    maker = round_ops.stop_after(volume, "_make_vol_step", max(rounds), seen)
    try:
        make_session().render()
    except round_ops.Done:
        pass
    finally:
        vol_ops.flight_steps = real
        volume._make_vol_step = maker
    return out

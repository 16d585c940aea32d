"""Tiny programmatic scenes for tests and smoke runs.

Counterpart of ``nart_tpu/testing.py``; scenes are built on the CPU (move
them with ``.to(device)``).
"""

import dataclasses

import numpy as np
import torch

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

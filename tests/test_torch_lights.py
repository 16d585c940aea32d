"""nart_tpu_torch lights vs nart_tpu on random inputs.

Disk, ring, env (with and without its 2D CDF) and distant lights, the
packed area-light tables and the integrator's per-lane light selection:
the same numpy inputs through both packages, compared as in
test_torch_shading.py (_close: rtol 1e-5 / atol 1e-6 on >= 99.5% of the
lanes, 1e-3 on all, integers exactly).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import lights as jl
from nart_tpu import scene as jscene
from nart_tpu.integrators import path as jpath
from nart_tpu_torch import lights as tl
from nart_tpu_torch import scene as tscene
from tests.test_torch_shading import _close, _dirs
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")


def _lights():
    """(name, JAX LightData) pairs: disk, ring, macbeth's env map with its
    2D CDF, a texture env without CDF, and a distant light."""
    def xf_at(z, tilt=0.3):
        c, s = np.cos(tilt), np.sin(tilt)
        xf = np.eye(4, dtype=np.float32)
        xf[:3, :3] = [[1, 0, 0], [0, c, -s], [0, s, c]]
        xf[2, 3] = z
        return xf

    def light(kind, **kw):
        base = dict(kind=kind, xf=xf_at(2.0), radius=1.0, inner_radius=0.0,
                    intensity=np.float32(2.0),
                    le_const=np.array([1.0, 0.8, 0.5], np.float32),
                    le_tex=None, env2d=None)
        base.update(kw)
        return jscene.LightData(**base)

    js = jscene.load_scene(os.path.join(FIX, "macbeth.json"), asset_root=FIX)
    tex = np.random.default_rng(1).random((4, 8, 3), dtype=np.float32)
    return [
        ("disk", light(jscene.LIGHT_DISK)),
        ("ring", light(jscene.LIGHT_RING, radius=1.5, inner_radius=0.5)),
        ("env_cdf", js.lights[0]),
        ("env_tex", light(jscene.LIGHT_ENV, xf=np.eye(4, dtype=np.float32),
                          le_tex=tex)),
        ("distant", light(jscene.LIGHT_DISTANT)),
    ]


@pytest.mark.parametrize("name,jlight", _lights(), ids=lambda x: str(x)[:8])
def test_light_eval_and_sample_match(name, jlight):
    tlight = tscene.light_from_numpy(dataclasses.asdict(jlight))
    g = np.random.default_rng(len(name))
    n = 1024
    p = (g.normal(size=(n, 3)) * 0.5).astype(np.float32)
    wi = _dirs(n, g)
    if name in ("disk", "ring"):  # aim half the directions at the light
        wi[: n // 2] = _dirs(n // 2, g, upper=True)
    u2 = g.random((n, 2), dtype=np.float32)
    ej = jl.light_eval(jlight, jnp.asarray(p), jnp.asarray(wi))
    et = tl.light_eval(tlight, torch.from_numpy(p), torch.from_numpy(wi))
    for k in ("le", "pdf", "t"):
        _close(getattr(et, k), getattr(ej, k), k)
    sj = jl.light_sample(jlight, jnp.asarray(p), jnp.asarray(u2))
    st = tl.light_sample(tlight, torch.from_numpy(p), torch.from_numpy(u2))
    for k, a, b in zip(("le", "wi", "pdf", "t", "st"), st, sj):
        _close(a, b, k)
    if name == "env_cdf":
        uvj, pj = jl.env2d_sample(jlight.env2d, jnp.asarray(u2))
        uvt, pt = tl.env2d_sample(tlight.env2d, torch.from_numpy(u2))
        _close(uvt, uvj, "uv")
        _close(pt, pj, "pdf")


def test_packed_area_lights_match():
    """Selected-light eval/sample and the nearest-light pass over a pack of
    disk and ring lights (the integrator's light paths)."""
    named = dict(_lights())
    jlights = [named["disk"], named["ring"], named["env_cdf"],
               dataclasses.replace(named["disk"], radius=0.4)]
    tlights = [tscene.light_from_numpy(dataclasses.asdict(li))
               for li in jlights]
    pj, rest_j = jl.pack_area_lights(jlights)
    pt, rest_t = tl.pack_area_lights(tlights)
    assert pj.index == pt.index and rest_j == rest_t
    g = np.random.default_rng(5)
    n = 1024
    p = (g.normal(size=(n, 3)) * 0.5).astype(np.float32)
    wi = _dirs(n, g, upper=True)
    u2 = g.random((n, 2), dtype=np.float32)
    sel = g.integers(0, len(pj.index), n).astype(np.int32)
    J = [jnp.asarray(x) for x in (sel, p, wi, u2)]
    T = [torch.from_numpy(x) for x in (sel, p, wi, u2)]
    T[0] = T[0].long()
    ej = jl.area_pack_eval(pj, J[0], J[1], J[2])
    et = tl.area_pack_eval(pt, T[0], T[1], T[2])
    for k in ("le", "pdf", "t"):
        _close(getattr(et, k), getattr(ej, k), k)
    for k, a, b in zip(("le", "wi", "pdf", "t"),
                       tl.area_pack_sample(pt, T[0], T[1], T[3]),
                       jl.area_pack_sample(pj, J[0], J[1], J[3])):
        _close(a, b, k)
    t_lim = np.where(g.random(n) < 0.5, np.inf, 1.5).astype(np.float32)
    for k, a, b in zip(("le", "t", "hit"),
                       tl.area_pack_nearest(pt, T[1], T[2],
                                            torch.from_numpy(t_lim)),
                       jl.area_pack_nearest(pj, J[1], J[2],
                                            jnp.asarray(t_lim))):
        _close(a, b, k)


def test_light_selection_matches_integrator():
    """The integrator's per-lane selected-light eval/sample over a mixed
    list (packed area lights + env)."""
    from nart_tpu_torch.integrators import path as tpath

    named = dict(_lights())
    jlights = [named["disk"], named["env_cdf"], named["ring"]]
    tlights = [tscene.light_from_numpy(dataclasses.asdict(li))
               for li in jlights]
    part_j = jpath._light_partition(jlights)
    part_t = tpath._light_partition(tlights, "cpu")
    g = np.random.default_rng(6)
    n = 1024
    p = (g.normal(size=(n, 3)) * 0.5).astype(np.float32)
    wi = _dirs(n, g)
    u2 = g.random((n, 2), dtype=np.float32)
    idx = g.integers(0, 3, n).astype(np.int32)
    out_j = jpath._select_light_eval(jlights, jnp.asarray(idx), jnp.asarray(p),
                                     jnp.asarray(wi), part=part_j)
    out_t = tpath._select_light_eval(tlights, part_t,
                                     torch.from_numpy(idx).long(),
                                     torch.from_numpy(p), torch.from_numpy(wi))
    for a, b in zip(out_t, out_j):
        _close(a, b)
    out_j = jpath._select_light_sample(jlights, jnp.asarray(idx),
                                       jnp.asarray(p), jnp.asarray(u2),
                                       part=part_j)
    out_t = tpath._select_light_sample(tlights, part_t,
                                       torch.from_numpy(idx).long(),
                                       torch.from_numpy(p),
                                       torch.from_numpy(u2))
    for a, b in zip(out_t, out_j):
        _close(a, b)

"""nart_tpu_torch bxdf / materials vs nart_tpu on random inputs.

Same numpy inputs through both packages; continuous outputs agree to
rtol 1e-5 (atol 1e-6: transcendental functions differ in the last bit
between the libraries) on >= 99.5% of the lanes and to 1e-3 on all (see
_close), discrete ones (flags, lobe codes) exactly.  The lights are in
test_torch_lights.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import bxdf as jb
from nart_tpu import materials as jm
from nart_tpu import scene as jscene
from nart_tpu_torch import bxdf as tb
from nart_tpu_torch import materials as tm
from nart_tpu_torch import scene as tscene
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "macbeth")
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, name=""):
    """Integers equal; floats to RTOL/ATOL on >= 99.5% of the elements and
    to 1e-3 on all: near-grazing microfacet terms (tan^2 / alpha^2 as
    cos -> 0) amplify last-bit differences of the two libraries' sqrt,
    division and summation order on a few lanes."""
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64),
                                      err_msg=name)
        return
    assert t.shape == j.shape, name
    ok = np.isclose(t, j, rtol=RTOL, atol=ATOL, equal_nan=True)
    assert ok.mean() >= 0.995, (name, ok.mean())
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5, err_msg=name)


def _dirs(n, g, upper=None):
    w = g.normal(size=(n, 3)).astype(np.float32)
    if upper is not None:
        w[:, 2] = np.abs(w[:, 2]) + 0.05 if upper else w[:, 2]
    return w / np.linalg.norm(w, axis=-1, keepdims=True)


# (lobe0, lobe1, n_lobes) configurations of the five materials
LOBES = {
    "lambert": (jb.L_LAMBERT, -1, 1),
    "plastic": (jb.L_LAMBERT, jb.L_TS, 2),
    "plastic_spec": (jb.L_LAMBERT, jb.L_SPECULAR, 2),
    "glossy": (jb.L_TS, -1, 1),
    "glass_rough": (jb.L_DIELECTRIC, -1, 1),
    "glass_delta": (jb.L_SPECDIEL, -1, 1),
    "mirror": (jb.L_SPECULAR, -1, 1),
}


def _desc_inputs(kind, n, g):
    l0, l1, nl = LOBES[kind]
    alpha = g.uniform(0.01, 0.8, n).astype(np.float32)
    return dict(
        n_lobes=np.full(n, nl, np.int32),
        lobe=np.tile(np.array([l0, l1], np.int32), (n, 1)),
        rho_d=g.random((n, 3), dtype=np.float32),
        rho_s=g.random((n, 3), dtype=np.float32),
        tau=g.random((n, 3), dtype=np.float32),
        eta=g.uniform(1.2, 2.0, n).astype(np.float32),
        alpha0=np.maximum(alpha, np.float32(1e-4)),
        alpha_prime=(alpha * g.uniform(0.5, 1.5, n)).astype(np.float32),
    )


def _both_desc(d):
    dj = jb.BsdfDesc(**{k: jnp.asarray(v) for k, v in d.items()})
    dt = tb.BsdfDesc(**{k: torch.from_numpy(v).long() if v.dtype == np.int32
                        else torch.from_numpy(v) for k, v in d.items()})
    return dj, dt


@pytest.mark.parametrize("kind", sorted(LOBES))
def test_bsdf_eval_and_sample_match(kind):
    n = 1024
    g = np.random.default_rng(len(kind))
    dj, dt = _both_desc(_desc_inputs(kind, n, g))
    two_sided = kind.startswith("glass")
    wo = _dirs(n, g, upper=None if two_sided else True)
    wi = _dirs(n, g, upper=None if two_sided else True)
    use_prime = g.random(n) < 0.5
    eta_outer = np.where(g.random(n) < 0.2, dj.eta, 1.0).astype(np.float32)
    u1 = g.random(n, dtype=np.float32)
    u2 = g.random((n, 2), dtype=np.float32)
    flags0 = g.integers(0, 16, n).astype(np.int32)
    J = [jnp.asarray(x) for x in (wo, wi, use_prime, eta_outer)]
    T = [torch.from_numpy(x) for x in (wo, wi, use_prime, eta_outer)]
    _close(tb.bsdf_f(dt, *T), jb.bsdf_f(dj, *J), "f")
    _close(tb.bsdf_pdf(dt, *T), jb.bsdf_pdf(dj, *J), "pdf")
    out_j = jb.bsdf_sample_f(dj, J[0], jnp.asarray(u1), jnp.asarray(u2), J[2],
                             J[3], jnp.asarray(flags0))
    out_t = tb.bsdf_sample_f(dt, T[0], torch.from_numpy(u1),
                             torch.from_numpy(u2), T[2], T[3],
                             torch.from_numpy(flags0).long())
    for name, a, b in zip(("f", "wi", "pdf", "flags", "alpha_i", "eta"),
                          out_t, out_j):
        _close(a, b, name)
    _close(tb.bsdf_sample_eta(dt, torch.from_numpy(u1)),
           jb.bsdf_sample_eta(dj, jnp.asarray(u1)), "sample_eta")


def test_frame_to_local_to_world_match():
    g = np.random.default_rng(9)
    n = 1024
    sn = g.normal(size=(n, 3)).astype(np.float32)
    dpds = g.normal(size=(n, 3)).astype(np.float32)
    nn = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    v = _dirs(n, g)
    for mapped in (None, nn):
        fj = jb.build_frame(jnp.asarray(sn), jnp.asarray(dpds),
                            None if mapped is None else jnp.asarray(mapped))
        ft = tb.build_frame(torch.from_numpy(sn), torch.from_numpy(dpds),
                            None if mapped is None else torch.from_numpy(mapped))
        for k in ("t", "b", "n"):
            np.testing.assert_allclose(getattr(ft, k).numpy(),
                                       np.asarray(getattr(fj, k)),
                                       rtol=1e-5, atol=1e-5)
        _close(tb.to_local(ft, torch.from_numpy(v)),
               jb.to_local(fj, jnp.asarray(v)))
        _close(tb.to_world(ft, torch.from_numpy(v)),
               jb.to_world(fj, jnp.asarray(v)))


@pytest.mark.parametrize("half", [False, True])
def test_make_bsdf_matches_on_textured_scene(half):
    """macbeth: textured rho_d (plastic plane), glossy and plastic spheres;
    with the half texture table (the render path) and the f32 one."""
    js = jscene.load_scene(os.path.join(FIX, "macbeth.json"), asset_root=FIX)
    ts = tscene.from_numpy(dataclasses.asdict(js))
    sj = jax.tree_util.tree_map(jnp.asarray, js)
    g = np.random.default_rng(half)
    n = 1024
    mesh = g.integers(0, js.n_meshes, n).astype(np.int32)
    st = g.uniform(-0.1, 1.1, (n, 2)).astype(np.float32)
    sn = g.normal(size=(n, 3)).astype(np.float32)
    dpds = g.normal(size=(n, 3)).astype(np.float32)
    tweak = g.uniform(0.2, 1.0, n).astype(np.float32)
    tex_j = jm.pack_tex_half(sj.tex_data) if half else None
    tex_t = tm.pack_tex_half(ts.tex_data) if half else None
    fj, dj = jm.make_bsdf(sj, jnp.asarray(mesh), jnp.asarray(st),
                          jnp.asarray(sn), jnp.asarray(dpds),
                          jnp.asarray(tweak), tex_p2=tex_j)
    ft, dt = tm.make_bsdf(ts, torch.from_numpy(mesh).long(),
                          torch.from_numpy(st), torch.from_numpy(sn),
                          torch.from_numpy(dpds), torch.from_numpy(tweak),
                          tex_half=tex_t)
    for k in dj._fields:
        _close(getattr(dt, k), getattr(dj, k), k)
    for k in ("t", "b", "n"):
        _close(getattr(ft, k), getattr(fj, k), k)

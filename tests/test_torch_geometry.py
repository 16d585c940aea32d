"""nart_tpu_torch geometry + camera vs nart_tpu.

The watertight test, the brute-force intersector, the packed surface fetch
and camera rays are held against the JAX package on the same numpy inputs:
hit triangles equal, t/u/v to rtol 1e-5 (float rounding of the dot products
may differ in the last bit between the two libraries' kernels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import camera as jcam
from nart_tpu import geometry as jgeo
from nart_tpu_torch import camera as tcam
from nart_tpu_torch import geometry as tgeo
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401


def _random_tris(n, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    base = g.uniform(-2, 2, (n, 1, 3))
    return (base + g.uniform(-scale, scale, (n, 3, 3))).astype(np.float32)


def _random_rays(n, seed=1):
    g = np.random.default_rng(seed)
    o = g.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _brute_both(o, d, t_min, t_max, tris):
    hj = jgeo.intersect_brute(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_min), jnp.asarray(t_max),
                              jnp.asarray(tris))
    ht = tgeo.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t_min), torch.from_numpy(t_max),
                              torch.from_numpy(tris))
    return hj, ht


def test_edge_fn_and_ray_shear_match():
    g = np.random.default_rng(4)
    a = g.normal(size=(4, 1000)).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.edge_fn(*torch.from_numpy(a)).numpy(),
        np.asarray(jgeo.edge_fn(*jnp.asarray(a))))
    # axis ties exercise the C++ tie-break
    d = np.concatenate([g.normal(size=(500, 3)),
                        [[1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1]]])
    d = d.astype(np.float32)
    sj = jgeo.ray_shear(jnp.asarray(d))
    st = tgeo.ray_shear(torch.from_numpy(d))
    np.testing.assert_array_equal(st.perm.numpy(), np.asarray(sj.perm))
    for k in ("sx", "sy", "sz"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(sj, k)))


@pytest.mark.parametrize("n_tris,seed", [(1, 0), (300, 5), (700, 9)])
def test_intersect_brute_matches(n_tris, seed):
    tris = _random_tris(n_tris, seed=seed, scale=0.5)
    o, d = _random_rays(512, seed=seed + 1)
    t_min = np.zeros(512, np.float32)
    t_max = np.where(np.arange(512) % 3 == 0, 3.0, np.inf).astype(np.float32)
    hj, ht = _brute_both(o, d, t_min, t_max, tris)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    hit = np.asarray(hj.tri) >= 0
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ht, k).numpy()[hit],
                                   np.asarray(getattr(hj, k))[hit],
                                   rtol=1e-5, atol=1e-6)
    assert np.isinf(ht.t.numpy()[~hit]).all()


def test_tmin_tmax_respected():
    tri = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0, -1.0]])
    t3 = torch.from_numpy(tri)
    hit = tgeo.intersect_brute(o, d, torch.zeros(1), torch.tensor([0.5]), t3)
    assert not bool(hit.valid[0])
    hit = tgeo.intersect_brute(o, d, torch.tensor([1.5]),
                               torch.tensor([np.inf]), t3)
    assert not bool(hit.valid[0])
    hit = tgeo.intersect_brute(o, d, torch.zeros(1), torch.tensor([np.inf]), t3)
    assert bool(hit.valid[0]) and abs(float(hit.t[0]) - 1.0) < 1e-6


def test_watertight_shared_edge():
    quad = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]],
                     [[0, 0, 0], [1, 1, 0], [0, 1, 0]]], np.float32)
    xs = np.random.default_rng(3).uniform(0.01, 0.99, 256).astype(np.float32)
    o = np.stack([xs, xs, np.ones_like(xs)], -1)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (256, 1))
    hit = tgeo.intersect_brute(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(256), torch.full((256,), np.inf),
                               torch.from_numpy(quad))
    assert bool(hit.valid.all()), "watertightness violated along shared edge"


def test_surface_at_packed_matches():
    g = np.random.default_rng(2)
    tris = _random_tris(64, seed=2, scale=0.7)
    nrm = g.normal(size=(64, 3, 3)).astype(np.float32)
    uv = g.random((64, 3, 2), dtype=np.float32)
    mesh = g.integers(0, 5, 64).astype(np.int32)
    o, d = _random_rays(1024, seed=3)
    t_min = np.zeros(1024, np.float32)
    t_max = np.full(1024, np.inf, np.float32)
    hj, ht = _brute_both(o, d, t_min, t_max, tris)
    sj = jgeo.surface_at_packed(
        hj, jgeo.pack_surface_rows(jnp.asarray(tris), jnp.asarray(nrm),
                                   jnp.asarray(uv), jnp.asarray(mesh)))
    st = tgeo.surface_at_packed(
        ht, tgeo.pack_surface_rows(torch.from_numpy(tris),
                                   torch.from_numpy(nrm), torch.from_numpy(uv),
                                   torch.from_numpy(mesh)))
    hit = np.asarray(hj.tri) >= 0
    assert hit.sum() > 50
    np.testing.assert_array_equal(st.mesh.numpy()[hit], np.asarray(sj.mesh)[hit])
    for k in ("p", "gn", "sn", "st", "dpds", "dpdt"):
        np.testing.assert_allclose(getattr(st, k).numpy()[hit],
                                   np.asarray(getattr(sj, k))[hit],
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_cast_rays_matches():
    g = np.random.default_rng(0)
    xf = np.eye(4, dtype=np.float32)
    xf[:3, :3] = np.linalg.qr(g.normal(size=(3, 3)))[0]
    xf[:3, 3] = [1.0, -2.0, 3.0]
    px = g.integers(0, 40, 600).astype(np.int32)
    py = g.integers(0, 30, 600).astype(np.int32)
    jit = g.random((600, 2), dtype=np.float32)
    oj, dj = jcam.cast_rays(jnp.asarray(xf), 11.5, 40, 30, jnp.asarray(px),
                            jnp.asarray(py), jnp.asarray(jit))
    ot, dt = tcam.cast_rays(torch.from_numpy(xf), 11.5, 40, 30,
                            torch.from_numpy(px), torch.from_numpy(py),
                            torch.from_numpy(jit))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-6)

"""nart_tpu_torch.media vs nart_tpu.media on the same numpy inputs.

Random points and rays from a seeded numpy generator, points on the box's
faces and corners, axis-parallel rays (d == 0 on one or two axes) and
grids of shape (4, 4, 4) and (3, 5, 7).  The slab clip, the cell table and
the nested-lerp lookup are the same float32 operations in the same order:
exact.  The packed-cell lookup sums 8 products left to right; it is held to
rtol 1e-6 against the JAX package's reduction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import media as jmedia
from nart_tpu.scene import MediumData as JMedium
from nart_tpu_torch import media as tmedia
from nart_tpu_torch import scene as tscene
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

SHAPES = [(4, 4, 4), (3, 5, 7)]


def _medium(shape, seed):
    g = np.random.default_rng(seed)
    dens = g.uniform(0.0, 2.0, shape).astype(np.float32)
    jm = JMedium(bounds_min=np.float32([-1.0, -0.5, -2.0]),
                 bounds_max=np.float32([1.0, 1.5, 0.5]),
                 sigma_a=np.float32(0.7), sigma_s=np.float32(1.3),
                 le=np.float32([0.4, 0.3, 0.2]), density=dens,
                 sigma_maj=float(dens.max()) * 2.0)
    return jm, tscene.from_numpy({**_scene_stub(), "medium":
                                  dataclasses.asdict(jm)}).medium


def _scene_stub():
    """The smallest dict from_numpy accepts (it only needs the medium)."""
    from nart_tpu_torch import testing

    sc = testing.simple_scene(("lambert",))
    d = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    d = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in d.items()}
    d["lights"] = []
    return d


def _points(jm, n, seed):
    """Random points around the box (inside and out), the 8 corners and
    points on each face."""
    g = np.random.default_rng(seed)
    lo, hi = jm.bounds_min, jm.bounds_max
    pts = [g.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)]
    corners = np.array([[(lo, hi)[k >> a & 1][a] for a in range(3)]
                        for k in range(8)], np.float32)
    pts.append(corners)
    for axis in range(3):
        for face in (lo, hi):
            p = g.uniform(lo, hi, (16, 3)).astype(np.float32)
            p[:, axis] = face[axis]
            pts.append(p)
    return np.concatenate(pts)


def _rays(jm, n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-parallel rays: one or two zero components, some from inside
    for k in range(n // 4):
        d[k, k % 3] = 0.0
        if k % 2:
            d[k, (k + 1) % 3] = 0.0
    d[: n // 4] /= np.linalg.norm(d[: n // 4], axis=-1, keepdims=True)
    o[: n // 8] = g.uniform(jm.bounds_min, jm.bounds_max,
                            (n // 8, 3)).astype(np.float32)
    return o, d


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_density_cells_exact(shape):
    jm, tm = _medium(shape, 1)
    _eq(tmedia.pack_density_cells(tm.density),
        jmedia.pack_density_cells(jm.density))


@pytest.mark.parametrize("shape", SHAPES)
def test_density_lookups(shape):
    """Nested lerps exact; the packed-cell sum to rtol 1e-6 (and within 2
    ulps of the nested lerps on the port's own side)."""
    jm, tm = _medium(shape, 2)
    g = np.random.default_rng(3)
    # unit points, the clip range's ends and exact cell corners included
    p = np.concatenate([
        g.uniform(-0.1, 1.1, (512, 3)),
        np.array([[0, 0, 0], [0.999, 0.999, 0.999], [1, 1, 1], [0.5, 0, 1]]),
        np.stack(np.meshgrid(*[np.arange(r) / max(r - 1, 1) for r in shape],
                             indexing="ij"), -1).reshape(-1, 3),
    ]).astype(np.float32)
    nested_t = tmedia.density_lookup(tm.density, torch.from_numpy(p))
    _eq(nested_t, jmedia.density_lookup(jnp.asarray(jm.density),
                                        jnp.asarray(p)))
    cells_t = tmedia.pack_density_cells(tm.density)
    cells_j = jmedia.pack_density_cells(jm.density)
    got = tmedia.density_lookup_cells(cells_t, shape, torch.from_numpy(p))
    want = jmedia.density_lookup_cells(cells_j, shape, jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(got.numpy(), nested_t.numpy(), rtol=3e-7,
                               atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_medium_properties(shape):
    """medium_properties exact; medium_properties_cells: the inside mask
    exact, the density-scaled coefficients to rtol 1e-6."""
    jm, tm = _medium(shape, 4)
    p = _points(jm, 512, 5)
    jt = jmedia.medium_properties(jm, jnp.asarray(p))
    tt = tmedia.medium_properties(tm, torch.from_numpy(p))
    for a, b in zip(tt, jt):
        _eq(a, b)
    cj = jmedia.pack_density_cells(jm.density)
    ct = tmedia.pack_density_cells(tm.density)
    jc = jmedia.medium_properties_cells(jm, cj, jnp.asarray(p))
    tc = tmedia.medium_properties_cells(tm, ct, torch.from_numpy(p))
    _eq(tc[0], jc[0])
    assert bool(tc[0].any()) and not bool(tc[0].all())
    for a, b in zip(tc[1:], jc[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_clip_to_aabb_exact(shape):
    """The slab clip, axis-parallel rays (the d == 0 -> 1e-30 guard) and
    origins inside the box included: hit, t_min and t_max exact."""
    jm, tm = _medium(shape, 6)
    o, d = _rays(jm, 1024, 7)
    jt = jmedia.clip_to_aabb(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(jm.bounds_min),
                             jnp.asarray(jm.bounds_max))
    tt = tmedia.clip_to_aabb(torch.from_numpy(o), torch.from_numpy(d),
                             tm.bounds_min, tm.bounds_max)
    for a, b in zip(tt, jt):
        _eq(a, b)
    hit, t0, t1 = tt
    zero = torch.from_numpy((d == 0).any(-1))
    assert bool((hit & zero).any()) and bool((~hit & zero).any())
    assert bool(torch.isfinite(t0[hit]).all())
    inside = torch.from_numpy(np.all((o >= jm.bounds_min)
                                     & (o <= jm.bounds_max), -1))
    assert bool((t0[inside] < 0).all()) and bool(hit[inside].all())

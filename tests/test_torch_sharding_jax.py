"""nart_tpu_torch.sharding's films against the JAX package's
``sharding.render_sharded`` on the same mesh shapes (the 8 virtual CPU
devices of tests/conftest.py), on the CPU.

The port's films are its virtual ranks summed (render_shard over every rank
of the Layout that mirrors the mesh: ``make_mesh(n)`` is ``Layout(n, 1)``,
``make_mesh2(a, b)`` is ``Layout(a, b)``).  The criterion is the existing
port-vs-JAX test's of that mode: "balanced" films per pixel to rtol 1e-4 /
atol 1e-5 on >= 99.5% of the pixels with the mean within 1e-4
(tests/test_torch_render.py's per-item test; the JAX side traces with its
brute-force intersector), "spp"/"regen" raw films to atol 1e-5
(tests/test_torch_modes.py).  Lambert simple_scene at 10x6, 2 spp, 3
bounces.
"""

import dataclasses

import numpy as np
import pytest

from nart_tpu import render as jrender
from nart_tpu import sharding as jsharding
from nart_tpu import testing as jtesting
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from nart_tpu_torch import sharding as tsharding
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_sharding import _params, _summed


@pytest.mark.parametrize("mode,mesh", [
    ("balanced", (8,)), ("balanced", (2, 2)), ("spp", (2,)), ("regen", (2,)),
], ids=["balanced-8", "balanced-2x2", "spp-2", "regen-2"])
def test_sharded_film_matches_jax(mode, mesh):
    js = jtesting.simple_scene(("lambert",))
    jp = _params(jrender, 2, wavefront=mode, accel="brute")
    jsess = jrender.RenderSession(js, jp)
    jmesh = (jsharding.make_mesh(mesh[0]) if len(mesh) == 1
             else jsharding.make_mesh2(*mesh))
    film_j = np.asarray(jsharding.render_sharded(
        js, jsess.bvh, jp, jmesh, jsess.render_w, jsess.render_h,
        jsess.total_w, jsess.total_h, jsess.filter_bounds))
    sess = trender.RenderSession(tscene.from_numpy(dataclasses.asdict(js)),
                                 _params(trender, 2, wavefront=mode), "cpu")
    film_t = _summed(sess, tsharding.Layout(*mesh))[0].numpy()
    assert film_t[..., 4].sum() > 0
    if mode != "balanced":
        np.testing.assert_allclose(film_t, film_j, rtol=0, atol=1e-5)
        return
    close = np.isclose(film_t, film_j, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.995, close.mean()
    m_j, m_t = film_j[..., :3].mean(), film_t[..., :3].mean()
    assert abs(m_t - m_j) <= 1e-4 * max(abs(m_j), 1e-6), (m_j, m_t)

"""The render modes of nart_tpu_torch.render ("spp", "regen", and
"balanced" for the volume integrator) vs nart_tpu's, on the CPU.

"spp" and "regen" trace on the reference's per-pixel streams; a lane's
computation does not depend on the other lanes, so the port's "regen" film
is the same bits as its "spp" film.  Against the JAX package the raw films
(the filter-weighted sums) are held per pixel to atol 1e-5: both packages
trace the same paths, and sin/cos/log differ by an ulp between the
libraries.  Lambert simple_scene at 16x16, 2 spp; the volume at 8x8, 4 spp.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nart_tpu import render as jrender
from nart_tpu import testing as jtesting
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_volume import _env_scene


def _films(js, mode, **kw):
    """(the port's raw film and stats, the JAX package's raw film)."""
    jp = jrender.RenderParams(wavefront=mode, accel="brute", **kw)
    film_j = np.asarray(jrender.RenderSession(js, jp).render())
    sess = trender.RenderSession(tscene.from_numpy(dataclasses.asdict(js)),
                                 trender.RenderParams(wavefront=mode, **kw),
                                 "cpu")
    return sess.render(), sess.stats, film_j


def _close(film_t, film_j):
    np.testing.assert_allclose(film_t.numpy(), film_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["spp", "regen"])
def test_path_modes_match_jax(mode):
    """Each mode's film against the JAX package's film of the same mode;
    "regen" (chunks of 1 and of 2 samples) equals "spp" bit for bit."""
    kw = dict(image_width=16, image_height=16, spp=2, bounces=4)
    js = jtesting.simple_scene(("lambert",))
    film_t, stats, film_j = _films(js, mode, **kw)
    _close(film_t, film_j)
    assert film_t[..., 3].sum() > 0 and stats["rays"] > 16 * 16 * 2
    ts = tscene.from_numpy(dataclasses.asdict(js))
    other = "spp" if mode == "regen" else "regen"
    for chunk in (1, 2):
        p = trender.RenderParams(wavefront=other, spp_chunk=chunk, **kw)
        sess = trender.RenderSession(ts, p, "cpu")
        assert torch.equal(sess.render(), film_t), chunk
        assert sess.stats["rays"] == stats["rays"]


@pytest.mark.parametrize("mode", ["spp", "balanced"])
def test_volume_modes_match_jax(mode):
    """The volume integrator's lockstep and static-assignment films against
    the JAX package's."""
    js = _env_scene(sigma_a=0.4, sigma_s=0.8, med_le=(0.5, 0.5, 0.5))
    film_t, stats, film_j = _films(js, mode, image_width=8, image_height=8,
                                   spp=4, bounces=16, integrator="volume")
    _close(film_t, film_j)
    assert stats["rays"] > 10 * 10 * 4 and film_t[..., 0].sum() > 0

"""nart_tpu_torch.grad.loss_and_grad (image loss through the lockstep
render_lanes) vs nart_tpu.grad.loss_and_grad, on the CPU.

Same scenes, size and tolerances as tests/test_torch_grad.py: per-pixel RNG
streams are seeded alike in both packages, so both trace the same paths;
the loss is held to rtol 1e-4 and every gradient leaf to rtol 1e-3 /
atol 1e-5 (float32 sums in another order).  The image loss is a weighted
sum with weights made from a numpy seed, so that every pixel and channel
pulls differently.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nart_tpu import grad as jgrad
from nart_tpu import render as jrender
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import scene as tscene
from tests.test_torch_grad import SCENES, H, SPP, W, _assert_grads_match, _params
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("name", ["lambert", "glossy", "env"])
def test_loss_and_grad_matches_jax(name):
    js = SCENES[name]()
    weights = np.random.default_rng(7).random((H, W, 3), dtype=np.float32)
    loss_j, grads_j = jgrad.loss_and_grad(
        js, _params(jrender, accel="brute"), W, H, SPP,
        lambda img: jnp.sum(img * weights))
    ts = tscene.from_numpy(dataclasses.asdict(js))
    wt = torch.from_numpy(weights)
    loss_t, grads_t = tgrad.loss_and_grad(
        ts, _params(trender), W, H, SPP, lambda img: (img * wt).sum(),
        device="cpu")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    _assert_grads_match(grads_t, {k: (v if isinstance(v, list) else
                                      np.asarray(v))
                                  for k, v in grads_j.items()})


def test_render_lanes_shape_and_aux():
    """render_lanes alone: finite per-pixel radiance, positive under the
    light, with the aux record, and no graph when no leaf asks for one."""
    from nart_tpu_torch import cluster_accel as tca, testing as ttesting

    sc = ttesting.simple_scene(("lambert",))
    acc = tca.build_clusters(sc.tri_v.numpy())
    lanes, aux = tgrad.render_lanes(sc, acc, _params(trender), W, H, SPP,
                                    return_aux=True)
    assert lanes.shape == (W * H, 3) and aux == {"unfinished": 0}
    assert torch.isfinite(lanes).all() and float(lanes.mean()) > 0
    assert not lanes.requires_grad  # no leaf of the scene asks for one

"""Inverse rendering of a light's radiance with the port's gradients.

After tests/test_inverse.py::test_inverse_light_intensity_recovers_target:
render a target whose disk light is 1.5x the scene's, start from 0.4x the
target's radiance, and run Adam (torch.optim.Adam, lr 0.25, 80 steps) on the
path-replay gradients of the balanced work queue
(grad.radiance_weighted_loss_and_grad).  The sample set is fixed, so the
run is deterministic.  CPU, 12x12 at 4 spp; the albedo case is in
tests/test_torch_inverse.py (a file of its own each, so that xdist places
them side by side).
"""

import numpy as np
import torch

from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import testing
from nart_tpu_torch.integrators import path as tpath
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

W = H = 12
SPP = 4


def test_inverse_light_intensity_recovers_target():
    """The loss drops at least 10x and Le lands within 4% of the
    target's."""
    scene = testing.simple_scene(("lambert",))
    params = trender.RenderParams(image_width=W, image_height=H, spp=SPP,
                                  bounces=3, filter_width=1.0)
    acc = tca.build_clusters(scene.tri_v.numpy())
    n = W * H
    samples = trender.image_samples(
        W, H, W + 2 * int(np.ceil(params.filter_width)), SPP, "cpu")

    def image(theta):
        la, _, _ = tpath.trace_balanced(tgrad.put_params(scene, theta), acc,
                                        samples, params, W, H)
        return la[..., :3].mean(0)  # (n, 3)

    theta_star = tgrad.get_params(scene)
    le_star = [le * 1.5 for le in theta_star["light_le"]]
    theta_star = dict(theta_star, light_le=le_star)
    target = image(theta_star)

    le = le_star[0] * 0.4
    opt = torch.optim.Adam([le], lr=0.25)
    losses = []
    for _ in range(80):
        theta = dict(theta_star, light_le=[le.detach()])
        diff = image(theta) - target
        losses.append(float((diff * diff).mean()))
        # exact linearisation: the loss is quadratic in the per-sample mean
        cot_img = 2.0 * diff / diff.numel()
        cot = torch.cat([(cot_img / SPP).expand(SPP, n, 3),
                         torch.zeros(SPP, n, 1)], -1)
        _, grads, _, _ = tgrad.radiance_weighted_loss_and_grad(
            scene, theta, acc, samples, cot, params, W, H, device="cpu")
        le.grad = grads["light_le"][0]
        opt.step()
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    np.testing.assert_allclose(le.detach().numpy(), le_star[0].numpy(),
                               rtol=0.04)

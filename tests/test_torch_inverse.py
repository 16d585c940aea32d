"""Inverse rendering with the port's gradients: they optimise, not just
match finite differences.

After tests/test_inverse.py::test_inverse_albedo_recovers_target: render a
target with a known albedo, start from another, and run Adam
(torch.optim.Adam) on the path-replay gradients of the balanced work queue.
The sample set is fixed (the same RNG streams every step), so the run is
deterministic.  CPU, 12x12 at 4 spp.
"""

import numpy as np
import torch

from nart_tpu_torch import cluster_accel as tca
from nart_tpu_torch import grad as tgrad
from nart_tpu_torch import render as trender
from nart_tpu_torch import testing
from nart_tpu_torch.integrators import path as tpath

W = H = 12
SPP = 4


def test_inverse_albedo_recovers_target():
    """The loss drops at least 10x and the albedo lands within 2% of the
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
    theta_star["rho_d_const"] = torch.full_like(
        theta_star["rho_d_const"], 0.7)
    target = image(theta_star)

    albedo = torch.full_like(theta_star["rho_d_const"], 0.25)
    opt = torch.optim.Adam([albedo], lr=0.05)
    losses = []
    for _ in range(50):
        theta = dict(theta_star, rho_d_const=albedo.detach())
        diff = image(theta) - target
        losses.append(float((diff * diff).mean()))
        # exact linearisation: the loss is quadratic in the per-sample mean
        cot_img = 2.0 * diff / diff.numel()
        cot = torch.cat([(cot_img / SPP).expand(SPP, n, 3),
                         torch.zeros(SPP, n, 1)], -1)
        _, grads, _, _ = tgrad.radiance_weighted_loss_and_grad(
            scene, theta, acc, samples, cot, params, W, H, device="cpu")
        albedo.grad = grads["rho_d_const"]
        opt.step()
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    np.testing.assert_allclose(albedo[0].numpy(), 0.7, atol=0.02)

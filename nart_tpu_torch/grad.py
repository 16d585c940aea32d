"""Differentiable rendering: gradients w.r.t. scene/material/light params.

Counterpart of ``nart_tpu/grad.py``:

  * every sampling *decision* (directions, lobe/light choices, RR) is
    detached -- the detached-sampling estimator: grad E[f/p] = E[grad f / p]
    with p and the sample fixed (path.make_bounce, differentiable=True);
  * the work-queue route (radiance_weighted_loss_and_grad) is a path
    replay: the forward pass keeps each round's carry and traversal
    outputs, the backward pass re-runs each round's shading and never
    traverses (path.trace_balanced_loss);
  * the volume integrator's events carry p / detach(p) ratios, so the
    medium's sigma_a, sigma_s, Le and density get gradients; its work-queue
    route is the replay volume.trace_vol_static_loss;
  * geometry (hit positions, the traversal kernels) carries no gradient.

Trainable parameters are a dict of tensors extracted from SceneData, with
the JAX package's keys.  Entry points run on the card unless the caller
names a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import camera, render, resolve_device, rng, sampling
from .cluster_accel import build_accel
from .integrators import path as path_integrator
from .integrators import volume as volume_integrator
from .scene import SceneData

TRAINABLE_FIELDS = (
    "rho_d_const",
    "rho_s_const",
    "tau_const",
    "alpha_const",
    "eta_const",
    "tex_data",
)


MEDIUM_FIELDS = ("sigma_a", "sigma_s", "le", "density")


def get_params(scene: SceneData):
    """The trainable parameter dict of a scene: the six material tables,
    per light the constant Le, the Le texture (None for constant lights)
    and the scalar intensity, and, where the camera carries a medium,
    ``medium``: its sigma_a, sigma_s, le and density (the majorant stays a
    detached bound: keep the density under it when optimising).  An env
    light's importance distribution is built at scene load and not rebuilt
    from a trained texture: sampling pdfs are detached decisions, so the
    estimator stays unbiased."""
    theta = {f: getattr(scene, f) for f in TRAINABLE_FIELDS}
    theta["light_le"] = [li.le_const for li in scene.lights]
    theta["light_le_tex"] = [li.le_tex for li in scene.lights]
    theta["light_intensity"] = [li.intensity for li in scene.lights]
    if scene.medium is not None:
        theta["medium"] = {f: getattr(scene.medium, f) for f in MEDIUM_FIELDS}
    return theta


def put_params(scene: SceneData, theta):
    """A scene with its trainable parameters replaced by theta."""
    lights = [
        dataclasses.replace(li, le_const=le, le_tex=le_tex, intensity=inten)
        for li, le, le_tex, inten in zip(
            scene.lights, theta["light_le"], theta["light_le_tex"],
            theta["light_intensity"])
    ]
    medium = scene.medium
    if medium is not None and "medium" in theta:
        medium = dataclasses.replace(medium, **theta["medium"])
    return dataclasses.replace(
        scene, lights=lights, medium=medium,
        **{f: theta[f] for f in TRAINABLE_FIELDS})


def _map_params(fn, theta):
    """theta with fn applied to every tensor (None entries stay), in a
    fixed order: keys as given, lists and the medium's dict inside."""
    def conv(v):
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return None if v is None else fn(v)

    return {k: conv(v) for k, v in theta.items()}


def _param_list(theta):
    out = []
    _map_params(out.append, theta)
    return out


def flatten_leaves(theta):
    """Every tensor of a parameter (or gradient) dict, flattened and
    concatenated in _map_params's order into one 1-D tensor."""
    return torch.cat([x.reshape(-1) for x in _param_list(theta)])


def unflatten_like(flat, theta):
    """flatten_leaves's inverse: flat cut into a dict of theta's layout
    (views of flat)."""
    leaves = _param_list(theta)
    parts = iter(flat.split([x.numel() for x in leaves]))
    return _map_params(lambda x: next(parts).view_as(x), theta)


def params_from_numpy(theta):
    """The port's parameter dict from one of numpy arrays with the same
    keys (for example the JAX package's ``get_params`` result)."""
    return _map_params(
        lambda a: torch.from_numpy(np.array(a, np.float32)), theta)


def _grads_of(loss, theta):
    """d loss / d theta in theta's layout (zeros where loss ignores a
    leaf)."""
    leaves = _param_list(theta)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    filled = iter([torch.zeros_like(x) if g is None else g
                   for x, g in zip(leaves, grads)])
    return _map_params(lambda _: next(filled), theta)


def _as_leaves(theta, device):
    return _map_params(
        lambda x: x.detach().to(device).requires_grad_(), theta)


def render_lanes(scene, accel, params, width, height, spp, seed_base=0,
                 return_aux=False):
    """Differentiable per-pixel radiance (no film filter): (N, 3).

    Averages spp samples per pixel with the RNG stream discipline of the
    forward renderer (seeds are y * totalWidth + x where totalWidth
    includes the filter border), all lanes in lockstep (path.trace, or
    volume.trace_diff with its bound of 512 flight steps).  Runs on the
    device of the scene's tensors.  With return_aux=True also returns
    {"unfinished": walks the volume's step bound cut short, over all
    samples} (0 for the path integrator)."""
    dev = scene.cam_to_world.device
    n = width * height
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    px, py = idx % width, idx // width
    total_w = width + 2 * int(np.ceil(params.filter_width))
    state = rng.seed(py * total_w + px + seed_base)
    samples, state = sampling.latin_square(state, spp)  # (N, spp, 2)
    acc = torch.zeros((n, 3), device=dev)
    unfinished = 0
    for i in range(spp):
        o, d = camera.cast_rays(scene.cam_to_world, scene.fov, width, height,
                                px, py, samples[:, i])
        if params.integrator == "volume":
            l, _, state, _, unf = volume_integrator.trace_diff(
                scene, accel, o, d, state, params)
            unfinished += unf
        else:
            l, _, state, _ = path_integrator.trace(
                scene, accel, o, d, state, params, differentiable=True)
        acc = acc + l
    out = acc / float(np.float32(spp))
    if return_aux:
        return out, {"unfinished": unfinished}
    return out


def _balanced_loss_fn(params):
    if params.integrator == "volume":
        # the replay of the render route's static assignment
        return volume_integrator.trace_vol_static_loss
    return path_integrator.trace_balanced_loss


def radiance_weighted_loss_and_grad(scene, theta, accel, samples, cot,
                                    params, width, height, chunk_base=0,
                                    lanes=0, n_rounds=None, device=None,
                                    pix_offset=0, n_pix_total=None,
                                    row_map=None):
    """Value and gradient of sum(cot * per-sample radiance) over the
    balanced work queue, by path replay (path.trace_balanced_loss, or
    volume.trace_vol_static_loss for the volume integrator).

    Any image loss linearises to this form: the film splat is linear in
    the per-sample radiance, so cot = d loss / d la comes from a forward
    render.  ``n_rounds`` is accepted and ignored: the JAX package measures
    and caches a static round count for its compiled loop, this loop ends
    when no lane is alive.  Everything is moved to ``device`` (the card
    unless one is named).  pix_offset, n_pix_total and row_map place a
    shard's items in the global grid of the replays (path.item_pixels):
    samples and cot then cover the shard's pixels only.

    Returns (loss, grads, rays, n_rounds): grads has theta's layout, rays
    is one forward's algorithmic count, n_rounds the measured round count.
    """
    dev = resolve_device(device)
    theta = _as_leaves(theta, dev)
    scn = put_params(scene.to(dev), theta)
    accel = None if accel is None else accel.to(dev)
    if row_map is not None:
        row_map = row_map.to(dev)
    loss, rays, _, rounds = _balanced_loss_fn(params)(
        scn, accel, samples.to(dev), cot.to(dev), params, width, height,
        chunk_base=chunk_base, n_lanes=lanes, pix_offset=pix_offset,
        n_pix_total=n_pix_total, row_map=row_map)
    return loss.detach(), _grads_of(loss, theta), rays, rounds


def loss_and_grad(scene, params, width, height, spp, loss_fn, device=None,
                  volume_grad="balanced"):
    """Value and gradient of loss_fn(image (H, W, 3)) w.r.t. the trainable
    parameters, on ``device`` (the card unless one is named).

    The path integrator goes through render_lanes (lockstep wavefront,
    per-pixel RNG streams).  The volume integrator takes the balanced
    replay by default (volume_grad="balanced"): one forward of the static
    machine gives the per-sample radiance la, the image is its spp-mean, so
    cot = (d loss / d image) / spp linearises the loss exactly, and
    radiance_weighted_loss_and_grad replays the same per-item decisions.
    volume_grad="lockstep" goes through render_lanes (volume.trace_diff, the
    reference's per-pixel streams) and raises where its step bound cut a
    walk short.

    Returns (loss, grads_dict)."""
    dev = resolve_device(device)
    if params.integrator == "volume" and volume_grad == "balanced":
        return _volume_loss_and_grad_balanced(scene, params, width, height,
                                              spp, loss_fn, dev)
    accel = None
    if params.integrator == "path":
        accel = build_accel(scene.tri_v.cpu().numpy(), params.accel)
        accel = None if accel is None else accel.to(dev)
    theta = _as_leaves(get_params(scene), dev)
    lanes, aux = render_lanes(put_params(scene.to(dev), theta), accel,
                              params, width, height, spp, return_aux=True)
    if aux["unfinished"]:
        raise AssertionError(
            f"volume trace_diff truncated: {aux['unfinished']} walks "
            "exceeded the static step bound; radiance and gradients lost "
            "tail terms")
    loss = loss_fn(lanes.reshape(height, width, 3))
    return loss.detach(), _grads_of(loss, theta)


def _volume_loss_and_grad_balanced(scene, params, width, height, spp,
                                   loss_fn, dev):
    """Image-loss volume gradients through the balanced replay: the image
    is the spp-mean of the static machine's per-sample radiance (render_lanes'
    no-filter image on per-item streams), linearised exactly by
    cot = (d loss / d image) / spp."""
    n = width * height
    total_w = width + 2 * int(np.ceil(params.filter_width))
    samples = render.image_samples(width, height, total_w, spp, dev)
    scn = scene.to(dev)
    with torch.no_grad():
        la, _, _ = volume_integrator.trace_vol_static(
            scn, None, samples, params, width, height, n_lanes=params.lanes)
    image = la[..., :3].mean(0).reshape(height, width, 3).requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(image)
        (g_img,) = torch.autograd.grad(loss, image)
    g = (g_img.reshape(1, n, 3) / float(np.float32(spp))).expand(spp, n, 3)
    cot = torch.cat([g, torch.zeros((spp, n, 1), device=dev)], dim=-1)
    _, grads, _, _ = radiance_weighted_loss_and_grad(
        scn, get_params(scn), None, samples, cot, params, width, height,
        lanes=params.lanes, device=dev)
    return loss.detach(), grads

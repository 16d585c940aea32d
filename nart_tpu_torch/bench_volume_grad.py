"""Volume gradient throughput on the card: the balanced replay against the
lockstep trace_diff route.  Counterpart of tools/bench_volume_grad.py.

    python -m nart_tpu_torch.bench_volume_grad

volume_blob (tests/golden/volume_blob.json, its medium read from this
checkout, see bench_configs.scene_doc) at 128x128, 8 spp, 64 bounces,
filter width 1.  Each route is timed after a warm call, between
synchronizes, with its peak device memory:
  * lockstep: grad.loss_and_grad(..., volume_grad="lockstep") of the
    image's sum: render_lanes over volume.trace_diff, every flight step
    held in the autograd graph;
  * balanced: grad.radiance_weighted_loss_and_grad on the image's
    Latin-square samples (render.image_samples), cot 1 on RGB and 0 on
    alpha: the replay of the static assignment.
The JAX tool calls loss_and_grad without naming the route, whose default is
the balanced replay, and traces zero samples in its balanced half; here the
lockstep route is named and the balanced one traces the image's samples.

Prints a "#" line per route and one JSON line: both seconds, both peaks and
lockstep / balanced.  Where the lockstep route runs out of device memory,
the run raises.
"""

import json
import os
import sys

import numpy as np

from . import bench, grad, render, resolve_device
from .bench_configs import REPO, load_scene_doc

SCENE = os.path.join(REPO, "tests", "golden", "volume_blob.json")
SIZE, SPP = 128, 8


def volume_blob():
    """The volume_blob scene, its medium loaded from this checkout."""
    scene = load_scene_doc(SCENE, os.path.dirname(SCENE))
    if scene.medium is None:
        raise RuntimeError("blob.vol was not loaded: no medium")
    return scene


def volume_params(size, spp):
    return render.RenderParams(
        image_width=size, image_height=size, spp=spp, bounces=64,
        integrator="volume", filter_width=1.0)


def _route(dev, fn):
    """fn() -> (loss, grads, ...) once warm, once timed (bench.timed)."""
    (seconds,), out, peak, _ = bench.timed(dev, fn, 1)
    return {"s": seconds, "peak_mib": peak, "loss": float(out[0]),
            "grads": out[1]}


def lockstep(scene, size, spp, dev):
    """The lockstep route, named: loss_and_grad of the image's sum."""
    return _route(dev, lambda: grad.loss_and_grad(
        scene, volume_params(size, spp), size, size, spp,
        lambda img: img.sum(), device=dev, volume_grad="lockstep"))


def balanced(scene, size, spp, dev):
    """The balanced replay on the image's Latin squares, cot 1 on RGB; its
    machines kept across the warm and the timed call."""
    params = volume_params(size, spp)
    samples = render.image_samples(
        size, size, size + 2 * int(np.ceil(params.filter_width)), spp, dev)
    cot = bench.rgb_cot(spp, size * size, dev)
    theta = grad.get_params(scene)
    machines = {}
    return _route(dev, lambda: grad.radiance_weighted_loss_and_grad(
        scene, theta, None, samples, cot, params, size, size, device=dev,
        machines=machines))


def run(size=SIZE, spp=SPP, device=None):
    """Both routes on volume_blob at size x size, spp: {route: {"s",
    "peak_mib", "loss", "grads"}}."""
    dev = resolve_device(device)
    scene = volume_blob()
    return {"lockstep": lockstep(scene, size, spp, dev),
            "balanced": balanced(scene, size, spp, dev)}


def main():
    dev = resolve_device(None)
    res = run(SIZE, SPP, dev)
    for route, r in res.items():
        print(f"# {route}: {r['s']} s, peak {r['peak_mib']} MiB, loss "
              f"{r['loss']}", file=sys.stderr, flush=True)
    lock, bal = res["lockstep"], res["balanced"]
    print(json.dumps({
        "size": SIZE, "spp": SPP, "lockstep_s": lock["s"],
        "balanced_s": bal["s"], "lockstep_peak_mib": lock["peak_mib"],
        "balanced_peak_mib": bal["peak_mib"],
        "lockstep_over_balanced": lock["s"] / bal["s"],
        "device": bench.device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()

"""The reference's answers to a cell's traffic: the configuration's plain
reference (configs/<name>.json's "reference", a module of this folder)
works each kept answer out again from the scene's files, the seed's
factors (params.Draws, the same the program was given), the session and
the samples.

  * render_image: the finalized image of one unit of a render cell;
  * train_steps: the loss and gradients of the train steps whose chunks
    start at the given samples, each worked out on its own.

Paths run in blocks of BLOCK items, so the reference fits beside what
is left on the card; a train step's gradients are summed over them.
``carry_dtype`` is the control's (control.py)."""

import importlib

import numpy as np
import torch

from .. import params as params_mod
from ..cells import session_json

BLOCK = 1 << 20


def _module(cfg):
    return importlib.import_module(f"{__package__}.{cfg['reference']}")


def grid(s):
    """The pixel grid a render traces: whole buckets, cut to the bordered
    film (render.cpp 162-173)."""
    w, h, bs = s["imageWidth"], s["imageHeight"], s["bucketSize"]
    fb = int(np.ceil(float(s["filterWidth"])))
    return (min(-(-w // bs) * bs, w + 2 * fb),
            min(-(-h // bs) * bs, h + 2 * fb))


def _setup(cfg, scene_file, device, size, spp, grid_wh=None):
    ref = _module(cfg)
    scene = ref.Scene(scene_file, device)
    s = session_json(cfg, size)
    w, h = s["imageWidth"], s["imageHeight"]
    gw, gh = grid_wh(s) if grid_wh else (w, h)
    fb = int(np.ceil(float(s["filterWidth"])))
    samples = ref.latin_square(gw, gh, w + 2 * fb, spp, device)
    return ref, scene, s, (gw, gh), (w, h), samples


def render_image(cfg, traffic, factors, scene_file, device, size=None,
                 carry_dtype=None):
    """The (H, W, 4) image of one render unit, on the host."""
    spp = traffic["spp_per_unit"]
    with torch.no_grad():
        ref, scene, s, (gw, gh), (w, h), samples = _setup(
            cfg, scene_file, device, size, spp, grid)
        th = scene.theta(factors)
        tex = th["tex_data"].half().float()  # images read half texels
        fw = float(s["filterWidth"])
        fb = int(np.ceil(fw))
        film = torch.zeros((h + 2 * fb, w + 2 * fb, 5), device=device)
        table = ref.filter_table(device)
        n = spp * gw * gh
        la = torch.empty((n, 4), device=device)
        for lo in range(0, n, BLOCK):
            hi = min(n, lo + BLOCK)
            la[lo:hi, :3] = ref.item_paths(
                scene, th, samples, 0, (gw, gh), (w, h), s["bounces"],
                s["rougheningFactor"], tex, lo, hi, carry_dtype)
        la[:, 3] = 1.0  # every camera ray meets the environment
        la = la.reshape(spp, gw * gh, 4)
        for i in range(spp):  # sample by sample, as the film takes them
            ref.splat(film, samples[i], la[i], gw, gh, fw, table)
        return ref.finalize(film, w, h, fw).cpu()


def train_steps(cfg, traffic, factors, scene_file, bases, device, size=None,
                carry_dtype=None):
    """[(loss, {leaf path: gradient})] of the train steps whose chunks
    start at the samples `bases`, on the host: the loss is the sum of
    every sample's RGB radiance (the cotangent 1 on RGB, 0 on alpha)."""
    k = traffic["spp_per_unit"]
    ref, scene, s, _, (w, h), samples = _setup(cfg, scene_file, device,
                                               size, cfg["session"]["spp"])
    out = []
    for base in bases:
        th = scene.theta(factors)
        leaves = [x.requires_grad_() for _, x in params_mod.leaves(th)]
        chunk = samples[base:base + k]
        n = k * w * h
        loss = 0.0
        for lo in range(0, n, BLOCK // 4):
            hi = min(n, lo + BLOCK // 4)
            part = ref.item_paths(
                scene, th, chunk, base, (w, h), (w, h), s["bounces"],
                s["rougheningFactor"], th["tex_data"], lo, hi,
                carry_dtype).sum()
            part.backward()
            loss += float(part.detach())
        grads = {p: (x.grad if x.grad is not None else torch.zeros_like(x))
                 .detach().cpu()
                 for (p, _), x in zip(params_mod.leaves(th), leaves)}
        out.append((loss, grads))
    return out

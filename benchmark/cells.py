"""A cell's traffic driven through the program's public entries.

``Program(cell, seed, device)`` loads the cell's scene (assets.py) with
the program's loader, scales its trainable leaves by the seed's factors
(params.Draws, over the leaves the configuration lists) and builds what
the traffic mix calls:

  * "render": a RenderSession of spp_per_unit samples at the session's
    size; a unit is ``session.render()`` then ``film.finalize``,
    synchronised (a preview image);
  * "train": a RenderSession of the session's own spp, whose samples
    (render.image_samples) are the sequence the steps walk; a unit is one
    ``grad.radiance_weighted_loss_and_grad`` call on spp_per_unit samples
    with the cotangent 1 on RGB and 0 on alpha, synchronised; step i takes
    chunk (first + i) mod n_chunks, chunk_base at its first sample, on the
    session's kept machines, the parameters held between steps.

``set_up()`` runs the traffic's set-up units through the same call (they
capture the machines' CUDA graphs); a train cell keeps their answers (the
loss and gradients), and ``keep_last()``, called when the window closes,
the window's last step's.  A render cell keeps the image of the unit the
seed drew (params.DRAWN_UNITS), or the last.
"""

import gc

import torch

from . import assets
from . import params as params_mod
from . import trace


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def session_json(config, size=None):
    """The session the configuration runs; size (width, height) replaces
    its resolution (the CPU tests' small runs)."""
    s = dict(config["session"])
    if size is not None:
        s["imageWidth"], s["imageHeight"] = size
    return s


def rgb_cot(n_samples, n_pix, device):
    """Cotangents 1 on RGB, 0 on alpha: (n_samples, n_pix, 4)."""
    cot = torch.ones((n_samples, n_pix, 4), device=device)
    cot[..., 3] = 0.0
    return cot


def n_chunks(config, traffic):
    return config["session"]["spp"] // traffic["spp_per_unit"]


def draws(cell, seed):
    """What the seed draws for a cell (params.Draws)."""
    return params_mod.Draws(seed, cell.config["leaves"],
                            n_chunks(cell.config, cell.traffic))


class Program:
    """The program under test, set up for one cell and seed."""

    def __init__(self, cell, seed, device, size=None):
        from nart_tpu_torch import grad, render
        from nart_tpu_torch.integrators import path
        from nart_tpu_torch.scene import load_scene

        cfg, tr = cell.config, cell.traffic
        self.device = device
        self.mode = tr["mode"]
        self.k = tr["spp_per_unit"]
        self.scene_file = assets.scene_file(cfg)
        scene = load_scene(self.scene_file)
        self.draws = draws(cell, seed)
        scene = grad.put_params(scene,
                                self.draws.scaled(grad.get_params(scene)))
        sj = session_json(cfg, size)
        spp = self.k if self.mode == "render" else sj["spp"]
        self.params = render.resolve_params(sj, {"spp": spp})
        p = self.params
        self.sess = render.RenderSession(scene, p, device)
        # the parameters held on the card between steps, as training
        # holds them
        self.theta = grad.get_params(self.sess.scene)
        self.spans = trace.Spans()
        self.width, self.height = p.image_width, p.image_height
        self.samples_per_unit = self.width * self.height * self.k
        if self.mode == "render":
            total = self.k * self.sess.render_w * self.sess.render_h
        else:
            total = self.samples_per_unit
            self.samples = render.image_samples(
                self.width, self.height, self.sess.total_w, p.spp, device)
            self.cot = rgb_cot(self.k, self.width * self.height, device)
            self.n_chunks = n_chunks(cfg, tr)
        self.lanes = p.lanes or path.auto_lanes(total)
        self.step = 0
        self.kept = []  # the answers the comparison reads

    def chunk(self, i):
        """The first sample of train step i's chunk."""
        return (self.draws.first_chunk + i) % self.n_chunks * self.k

    def unit(self):
        """One unit of the traffic, synchronised; returns the rounds the
        program reported for it and leaves its answer in self.last."""
        from nart_tpu_torch import film, grad

        if self.mode == "render":
            with self.spans("bench.entry"):
                buf = self.sess.render()
            with self.spans("bench.finalize"):
                img = film.finalize(buf, self.width, self.height,
                                    self.sess.filter_bounds)
            with self.spans("bench.sync"):
                sync(self.device)
            self.last = img
            rounds = self.sess.stats["rounds"]
            if self.step == self.draws.kept_unit:
                self.kept = [img.detach().clone()]
        else:
            with self.spans("bench.samples"):
                base = self.chunk(self.step)
                smp = self.samples[base:base + self.k]
            with self.spans("bench.entry"):
                loss, g, _, rounds = grad.radiance_weighted_loss_and_grad(
                    self.sess.scene, self.theta, self.sess.accel, smp,
                    self.cot, self.params, self.width, self.height,
                    chunk_base=base, device=self.device,
                    machines=self.sess.machines)
            with self.spans("bench.sync"):
                sync(self.device)
            self.last = (base, loss, g)
        self.step += 1
        return int(rounds)

    def _keep(self):
        base, loss, g = self.last
        self.kept.append((base, float(loss), {
            p: x.detach().cpu().clone() for p, x in params_mod.leaves(g)}))

    def set_up(self, n):
        """The traffic's n set-up units; a train cell keeps each one's
        answer: (its chunk's first sample, loss, {leaf path: gradient})."""
        for _ in range(n):
            self.unit()
            if self.mode == "train":
                self._keep()
        if self.mode == "render":
            self.step = 0  # the window's units are counted from 0

    def keep_last(self):
        """Keep the window's last train step for the comparison (call when
        the window has closed, before any other unit runs)."""
        if self.mode == "train" and self.step > len(self.kept):
            self._keep()

    def answers(self):
        """What the comparison reads, on the host: the train cell's kept
        steps, or the render cell's kept image (the last, where the window
        ended before the drawn unit)."""
        if self.mode == "train":
            return self.kept
        img = self.kept[0] if self.kept else self.last
        return [img.detach().cpu()]

    def close(self):
        """Free the program's state on the card."""
        for name in ("sess", "samples", "cot", "last", "kept", "theta"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

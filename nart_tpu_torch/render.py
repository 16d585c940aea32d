"""Render sessions: parameter resolution, the chunked spp loop, EXR output.

Counterpart of ``nart_tpu/render.py`` (reference src/core/render.cpp:
RenderSession, LoadSessions, ParseRenderParamArguments).  Parameter
precedence: overrides > per-session JSON > defaults (64x64, bucket 16,
spp 1, bounces 10, filterWidth 1, rougheningFactor 0 clamped to [0,1]).

The reference renders whole buckets clamped to totalWidth, so when the
image size is not bucket-divisible, pixels in [W, min(ceil(W/bs)*bs, W+2*fb))
are rendered and splat into the film (render.cpp:162-173) — reproduced via
render_w/render_h.

Wavefront modes (``RenderParams.wavefront``), as in the JAX package:
  * "balanced" -- the work queue over (pixel, sample) items with per-item
    RNG streams (path.trace_balanced; for the volume integrator its static
    assignment, volume.trace_vol_static);
  * "regen" -- per-pixel sample regeneration on the reference's per-pixel
    streams (path.trace_regen): the same film bits as "spp".  The volume
    integrator has no per-pixel regeneration machine: there "regen" runs the
    "spp" loop;
  * "spp" -- one lockstep wavefront per sample (path.trace, volume.trace).
The per-pixel RNG states after the Latin square carry across chunks and
passes; with the film they are the checkpoint (checkpoint.py) from which a
render resumes bit for bit.  ``RenderSession.trace_chunk`` runs the mode's
tracer on one chunk of samples of any set of whole rows: the session's
grid, or a shard's strips (sharding.py).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import checkpoint, exr, film, resolve_device, rng, sampling
from .cluster_accel import build_accel, resolve_accel_kind
from .integrators import path as path_integrator
from .integrators import volume as volume_integrator
from .scene import SceneData, load_scene


@dataclass(frozen=True)
class RenderParams:
    integrator: str = "path"  # "path" | "volume"
    image_width: int = 64
    image_height: int = 64
    bucket_size: int = 16
    spp: int = 1
    bounces: int = 10
    filter_width: float = 1.0
    roughening_factor: float = 0.0
    # extensions (not part of the reference's JSON schema)
    # "auto" (= "cluster") | "cluster" | "brute" | "bvh"; "pallas" is the JAX
    # package's name of "cluster" (cluster_accel.resolve_accel_kind)
    accel: str = "auto"
    # MIS strategy toggles (reference compile-time BSDF_SAMPLING /
    # LIGHT_SAMPLING, pathintegrator.cpp:3-4)
    mis_bsdf: bool = True
    mis_light: bool = True
    wavefront: str = "balanced"  # "balanced" | "regen" | "spp"
    # samples per chunk of "balanced" and "regen"; 0 = min(spp, 32)
    spp_chunk: int = 0
    # work slots of "balanced"; 0 = auto (path.auto_lanes, volume.vol_lanes)
    lanes: int = 0
    # coherence-sort rays inside each traversal query; None = auto (on
    # above 64 clusters)
    sort_rays: object = None


_DEFAULTS = RenderParams()
_KEYS = {
    "integrator": "integrator",
    "imageWidth": "image_width",
    "imageHeight": "image_height",
    "bucketSize": "bucket_size",
    "spp": "spp",
    "bounces": "bounces",
    "filterWidth": "filter_width",
    "rougheningFactor": "roughening_factor",
    "accel": "accel",
    "wavefront": "wavefront",
    "lanes": "lanes",
    "sppChunk": "spp_chunk",
    "sortRays": "sort_rays",
}


def resolve_params(session_json: dict, overrides: dict) -> RenderParams:
    """overrides > JSON > defaults, rougheningFactor clamped to [0,1]."""
    vals = {}
    for jkey, name in _KEYS.items():
        if overrides.get(name) is not None:
            vals[name] = overrides[name]
        elif session_json.get(jkey) is not None:
            vals[name] = session_json[jkey]
        else:
            vals[name] = getattr(_DEFAULTS, name)
    vals["roughening_factor"] = min(max(float(vals["roughening_factor"]), 0.0),
                                    1.0)
    for k in ("image_width", "image_height", "bucket_size", "spp", "bounces",
              "lanes", "spp_chunk"):
        vals[k] = int(vals[k])
    vals["filter_width"] = float(vals["filter_width"])
    if vals["sort_rays"] is not None:
        vals["sort_rays"] = bool(vals["sort_rays"])
    return RenderParams(**vals)


def load_sessions(scene_path: str, overrides: Optional[dict] = None):
    """LoadSessions parity: one RenderParams per renderSessions entry."""
    with open(scene_path) as f:
        doc = json.load(f)
    overrides = overrides or {}
    return [resolve_params(s, overrides) for s in doc.get("renderSessions", [])]


def pixel_streams(width, height, total_w, spp, device):
    """The Latin-square image samples of a width x height pixel grid,
    (spp, width * height, 2), and each pixel's RNG state after drawing them.
    Per-pixel streams are seeded y * total_w + x, total_w being the image
    width with its filter border (render.cpp:81-82)."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    state = rng.seed((idx // width) * total_w + idx % width)
    samples, state = sampling.latin_square(state, spp)
    return samples.transpose(0, 1).contiguous(), state


def image_samples(width, height, total_w, spp, device):
    """pixel_streams' samples alone."""
    return pixel_streams(width, height, total_w, spp, device)[0]


def trace_mode(params):
    """The tracing loop a session runs: the wavefront mode, except that
    "regen" with the volume integrator runs the "spp" loop (there is no
    per-pixel regeneration machine for volumes)."""
    if params.wavefront == "regen" and params.integrator == "volume":
        return "spp"
    return params.wavefront


def chunk_size(params, checkpoint_every=0):
    """Samples per chunk of RenderSession.render: 1 in the "spp" loop; else
    the checkpoint granularity wins (chunk boundaries must meet the saves
    for a bit-identical resume), then spp_chunk, then min(spp, 32)."""
    if trace_mode(params) == "spp":
        return 1
    if checkpoint_every:
        return min(checkpoint_every, params.spp)
    if params.spp_chunk:
        return min(params.spp_chunk, params.spp)
    return min(params.spp, 32)


class RenderSession:
    """One render: scene + params on a device (the card unless one is
    named, see resolve_device) -> film -> EXR.

    ``machines`` keeps the mode's machine of each chunk shape: the
    "balanced" work queue (path.trace_balanced, volume.trace_vol_static),
    the "regen" machine (path.trace_regen) and the "spp" lockstep machines
    (path.trace_lockstep, volume.trace_lockstep), the counterparts of the
    JAX package's jit cache of _trace_balanced_jit, _trace_regen_jit and
    _spp_step_jit: on the card each machine's k-round CUDA graph is
    captured once, and every chunk of that shape, of a render or of a
    shard's rows, replays it with its own samples, chunk_base, pixels and
    states copied in.  The graphs and their memory go with the session.
    per_round=True runs the per-round loop instead (one round per host
    check, no graph): the reference of the graphed route's checks.
    ``state`` holds the per-pixel RNG states after the last render (what a
    checkpoint saves)."""

    def __init__(self, scene: SceneData, params: RenderParams, device=None,
                 per_round=False):
        if params.integrator not in ("path", "volume"):
            raise ValueError(f"unknown integrator {params.integrator!r}")
        if params.wavefront not in ("balanced", "regen", "spp"):
            raise ValueError(f"unknown wavefront {params.wavefront!r}")
        self.device = resolve_device(device)
        self.params = params
        self.filter_bounds = int(np.ceil(params.filter_width))
        self.total_w = params.image_width + 2 * self.filter_bounds
        self.total_h = params.image_height + 2 * self.filter_bounds
        nbx = -(-params.image_width // params.bucket_size)
        nby = -(-params.image_height // params.bucket_size)
        self.render_w = min(nbx * params.bucket_size, self.total_w)
        self.render_h = min(nby * params.bucket_size, self.total_h)
        self.scene = scene.to(self.device)
        self.accel = None  # the volume walk reads no triangles
        if params.integrator == "path":
            accel = build_accel(scene.tri_v.cpu().numpy(),
                                resolve_accel_kind(params.accel))
            self.accel = None if accel is None else accel.to(self.device)
        self.per_round = per_round
        self.machines = {}
        self.stats = {}
        self.state = None

    def render(self, progress=False, checkpoint_path=None, checkpoint_every=0,
               resume=False):
        """The raw film (totalH, totalW, 5) on the session's device.

        Per-pixel streams are seeded y * totalWidth + x (render.cpp:81-82)
        and draw the Latin-square image samples.  "balanced" and "regen"
        trace one chunk of samples at a time (chunk_size) and splat it
        sample by sample; "spp" (and "regen" with the volume integrator)
        traces and splats one sample at a time.  ``self.stats`` gets the
        algorithmic ray count and the round count (the volume integrator
        counts walk segments; rounds are the machine's rounds in
        "balanced", else 0) of the samples traced by this call.

        progress prints the percentage done to stderr after each chunk
        (the reference's logger, render.cpp:138-149).  With checkpoint_path
        and checkpoint_every, the film and the per-pixel RNG states are
        saved after every checkpoint_every samples (not after the last);
        resume=True starts from the saved state when the file exists, and
        the finished film is the same bits as an uninterrupted render's."""
        p = self.params
        dev = self.device
        n = self.render_w * self.render_h
        samples, state = pixel_streams(self.render_w, self.render_h,
                                       self.total_w, p.spp, dev)
        pix = torch.arange(n, dtype=torch.int64, device=dev)
        px, py = pix % self.render_w, pix // self.render_w
        buf = torch.zeros((self.total_h, self.total_w, 5), device=dev)
        start = 0
        if resume and checkpoint_path and os.path.exists(
                checkpoint.file_of(checkpoint_path)):
            f0, s0, start = checkpoint.load(checkpoint_path, p)
            buf = torch.from_numpy(f0).to(dev)
            state = torch.from_numpy(s0.astype(np.int64)).to(dev)
        table = film.filter_table(dev)
        every = checkpoint_every if checkpoint_path else 0
        chunk = chunk_size(p, every)
        rays = rounds = 0
        for i in range(start, p.spp, chunk):
            j = min(i + chunk, p.spp)
            la, state, r, k = self.trace_chunk(samples[i:j], state, i, px, py)
            film.splat_grid(buf, samples[i:j], la, p.filter_width, table,
                            self.render_w, self.render_h, self.filter_bounds)
            rays += r
            rounds += k
            if progress:
                print(f"\r{int(j * 100 / p.spp)}%", end="", file=sys.stderr,
                      flush=True)
            if every and j % every == 0 and j < p.spp:
                checkpoint.save(checkpoint_path, buf, state, j, p)
        if progress:
            print("\r100%", file=sys.stderr, flush=True)
        self.stats = {"rays": rays, "rounds": rounds}
        self.state = state
        return buf

    def trace_chunk(self, samples, state, chunk_base, px, py, row_map=None,
                    drain=None):
        """Trace a chunk of samples (S, N, 2) of the lanes px, py (N,) --
        whole rows, row-major: the render grid, or the rows of row_map (a
        shard's strips, whose items keep their global ids) -- with the
        tracer of the session's mode; chunk_base is the chunk's first
        sample and S is 1 in the "spp" loop.  state: the lanes' per-pixel
        RNG states past the Latin square, which "regen" and "spp" advance.
        drain: a () int64 tensor on the session's device that the path
        work queue ("balanced") adds its drain-tail rounds to
        (path.trace_balanced); no other tracer takes one.
        Returns (la (S, N, 4), state, rays, rounds)."""
        p = self.params
        mode = trace_mode(p)
        volume = p.integrator == "volume"
        if drain is not None and (mode != "balanced" or volume):
            raise ValueError("only the path work queue counts drain rounds")
        if mode == "balanced":
            tracer = (volume_integrator.trace_vol_static if volume
                      else path_integrator.trace_balanced)
            extra = {} if drain is None else {"drain": drain}
            la, r, k = tracer(self.scene, self.accel, samples, p,
                              self.render_w, px.shape[0] // self.render_w,
                              chunk_base=chunk_base, n_lanes=p.lanes,
                              n_pix_total=self.render_w * self.render_h,
                              row_map=row_map, machines=self.machines,
                              per_round=self.per_round, **extra)
            return la, state, r, k
        tracer = (path_integrator.trace_regen if mode == "regen" else
                  volume_integrator.trace_lockstep if volume else
                  path_integrator.trace_lockstep)
        la, state, r = tracer(self.scene, self.accel, px, py, samples, state,
                              p, machines=self.machines,
                              per_round=self.per_round)
        return la, state, r, 0

    def image(self):
        """Final normalised RGBA image (H, W, 4) tensor."""
        return film.finalize(self.render(), self.params.image_width,
                             self.params.image_height, self.filter_bounds)

    def write_exr(self, out_path: str, img=None):
        """Render (unless ``img`` is given) and write a half RGBA EXR."""
        if img is None:
            img = self.image()
        if not out_path.endswith(".exr"):
            out_path = out_path + ".exr"
        exr.write(out_path, img.detach().cpu().numpy())
        return out_path


def render_scene_file(scene_path: str, overrides: Optional[dict] = None,
                      *, device=None, asset_root: Optional[str] = None):
    """Load a scene and its sessions; yields (params, RenderSession) per
    renderSessions entry, on ``device`` (the card unless one is named)."""
    scn = load_scene(scene_path, asset_root=asset_root)
    for params in load_sessions(scene_path, overrides):
        yield params, RenderSession(scn, params, device)

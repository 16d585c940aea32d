"""Wavefront volume integrator: null-scattering delta tracking.

Counterpart of ``nart_tpu/integrators/volume.py`` (reference
src/integrators/volumeintegrator.cpp + SampleT_maj, media.h:128-181).  The
per-ray random walk (absorb / scatter / null against one global majorant)
is a wavefront loop: every step makes one free-flight attempt per live
lane.  A lane starting a segment draws the unused u and uMode and clips
the ray to the medium's box; a flight step draws the exponential distance,
on a null event redraws uMode, on a scatter draws two phase-function
samples: the reference's draw sites, in its order.  Lights count only on
escape (no next-event estimation); alpha is 1.

Gradients: every event multiplies the throughput by its probability ratio
p / detach(p), whose value is exactly 1, so values and draws are untouched
while sigma_a, sigma_s, the density and Le get gradients (detached-sampling
path replay).  The majorant is a detached constant.

Schedulers (lanes never talk to each other, so an item's result does not
depend on which lane runs it, nor when):
  * trace_lockstep / trace / trace_diff -- lockstep per-pixel walk (the
    reference's draw order): the "spp" mode of render.py on a kept
    machine, one flight step a round on the round runner; its per-round
    loop; the lockstep gradient route;
  * trace_balanced -- work queue over (pixel, sample) items: a lane whose
    walk ended pulls the next item by prefix sum;
  * trace_vol_static -- lane i owns items i, i + n, i + 2n, ...: the
    render route.  Per-item radiance is the same bits as trace_balanced's.
Both machines run FUSE_STEPS flight steps per round and the escape light
pass once per round.  trace_balanced_loss and trace_vol_static_loss
differentiate them by path replay on a kept replay.ReplayMachine, as
``path.trace_balanced_loss`` does.
No traversal query runs on any of these paths: the walk never reads the
scene's triangles.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from .. import camera, rng, vol_ops
from ..media import pack_density_cells
from ..replay import ReplayLoss, ReplayMachine, replay_loss
from ..rounds import RoundRunner
from ..scene import map_tensors
from ..vol_ops import VolState
from .path import (
    _camera,
    _chunk_base_tensor,
    _lane_buffers,
    _light_partition,
    _machine,
    _nearest_light,
    _next_pow2,
    _path_stream_seed,
    derive_light_tables,
    item_pixels,
    scene_leaves,
    scene_signature,
)

INF = math.inf
# safety cap on steps (lockstep) or rounds (machines): delta tracking ends
# with probability one, a NaN density might not
MAX_STEPS = 1_000_000
# flight steps per round of the two machines: the respawn and the escape
# light pass are paid once per round.  Any value gives the same results
# (draws are per lane, the light pass draws nothing); 4 is the JAX
# package's default.  On the card a round's steps are one launch of V1
# (vol_ops.flight_steps), which takes at most vol_ops.MAX_STEPS
FUSE_STEPS = 4


def _make_vol_step(scene, params, part, defer_light=False, cells=None):
    """The walk's flight steps: (steps, light).

    steps(vs, k, tables=None, seg=None) -> (vs', died, esc, segment
    starts): k delta-tracking steps (vol_ops.flight_steps: V1 and V2 on the
    card, the plain step on the CPU; the starts added into seg, a () int64
    accumulator, where it is given); `died` marks lanes whose walk ended
    in them (absorbed, out of scatter events, or escaped), `esc` those
    that escaped.  With defer_light=False (k = 1: the lockstep walk) the
    escape radiance is added at once; with defer_light=True escaped lanes
    only set `esc`, and the caller applies light(vs, esc_pending) once
    after a batch of steps: the light pass draws nothing and (o, d, beta)
    freeze at escape, so this changes only when the pass is paid.  cells, the
    density's packed cell table (media.pack_density_cells), replaces its
    derivation here, and steps(vs, k, tables) / light(vs, mask, tables)
    take another (light partition, cells) pair for one call (the replay
    machine's, derived in every round from its leaf tensors)."""
    medium = scene.medium
    lights = scene.lights
    dev = medium.density.device
    # a tensor on the medium's device: CUDA divides by a host scalar as a
    # product with its reciprocal, which is not the same bits
    sigma_maj = torch.tensor(float(np.float32(medium.sigma_maj)), device=dev)
    if cells is None:
        cells = pack_density_cells(medium.density)  # once per trace
    tables0 = (part, cells)

    def light(vs, mask, tables=None):
        le, _, _ = _nearest_light(lights, (tables or tables0)[0], vs.o, vs.d,
                                  torch.full_like(vs.t_cur, INF))
        return replace(vs, l_out=vs.l_out + torch.where(
            mask[:, None], le * vs.beta, 0.0))

    def steps(vs: VolState, k, tables=None, seg=None):
        tables = tables or tables0
        out, died, esc, seg = vol_ops.flight_steps(
            vs, k, tables[1], medium, sigma_maj, params.bounces, seg)
        if not defer_light:
            out = light(out, esc, tables)
        return out, died, esc, seg

    return steps, light


def derive_tables(scene, base=None):
    """The tables a flight step derives from the scene's trainable tensors:
    (the light partition, the density's packed cells); with base (an
    earlier result of the same scene) by device operations only, as the
    replay machine's rounds derive them (_VolReplayParts)."""
    return (derive_light_tables(scene, None if base is None else base[0]),
            pack_density_cells(scene.medium.density))


def _vol_state(o, d, state):
    n = o.shape[0]
    dev = o.device
    zeros = torch.zeros(n, device=dev)
    return VolState(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        new_ray=torch.ones(n, dtype=torch.bool, device=dev),
        bounce=torch.zeros(n, dtype=torch.int64, device=dev),
        u_mode=zeros, t_cur=zeros, t_exit=zeros, o=o, d=d, state=state,
        beta=torch.ones((n, 3), device=dev),
        l_out=torch.zeros((n, 3), device=dev),
    )


def _walk(scene, o, d, state, params, max_steps):
    """The lockstep walk: (VolState after it, segment starts)."""
    steps, _ = _make_vol_step(scene, params,
                              _light_partition(scene.lights, o.device))
    vs = _vol_state(o, d, state)
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for _ in range(max_steps):
        if not bool(vs.alive.any()):
            break
        vs, _, _, _ = steps(vs, 1, seg=rays)
    return vs, int(rays)


def _no_medium(scene, o, d):
    le, _, _ = _nearest_light(scene.lights,
                              _light_partition(scene.lights, o.device), o, d,
                              torch.full((o.shape[0],), INF, device=o.device))
    return le


def trace(scene, accel, o, d, state, params):
    """Lockstep per-pixel walk: every lane steps until all walks ended.

    Returns (L (N, 3), alpha (N,), state, rays): rays counts walk segments
    (camera rays and scatter redirects), the volume's analogue of the path
    integrator's ray count.  accel is not read.  This is the per-round
    loop: the "spp" mode renders on trace_lockstep's kept machine, whose
    bits it is the reference of."""
    ones = torch.ones(o.shape[0], device=o.device)
    if scene.medium is None:  # every ray escapes at once
        return _no_medium(scene, o, d), ones, state, 0
    vs, rays = _walk(scene, o, d, state, params, MAX_STEPS)
    return vs.l_out, ones, vs.state, rays


class _LockstepForward:
    """trace_lockstep's machine for one lane count, kept across calls
    (path._LockstepForward's counterpart): the jitter, px, py and state
    buffers, the segment count and the round runner, whose rounds are
    _walk's flight steps (one a round), gated by MAX_STEPS on the device
    so that the cut stays exact whatever k."""

    def __init__(self, scene, n, params, device, per_round):
        self.jit = jit = torch.zeros((n, 2), device=device)
        self.px, self.py, self.state = px, py, state = _lane_buffers(n,
                                                                    device)
        cast = _camera(scene, params, px, py)
        steps, _ = _make_vol_step(scene, params,
                                  _light_partition(scene.lights, device))
        self.rays = rays = torch.zeros((), dtype=torch.int64, device=device)

        def init():
            return (_vol_state(*cast(jit), state),)

        def round_fn(core):  # no reference to self (path._BalancedForward)
            vs, _, _, _ = steps(core[0], 1, seg=rays)
            return (vs,)

        self.init = init
        self.runner = RoundRunner(round_fn, k=1 if per_round else None,
                                  max_rounds=MAX_STEPS, graph=not per_round)

    def __call__(self, px, py, jit, state):
        self.px.copy_(px)
        self.py.copy_(py)
        self.jit.copy_(jit)
        self.state.copy_(state)
        self.rays.zero_()
        core, _ = self.runner.run(self.init())
        vs = core[0]
        la = torch.cat([vs.l_out, torch.ones_like(vs.l_out[:, :1])], dim=-1)
        return la[None], vs.state.clone(), int(self.rays)  # the end's read


def trace_lockstep(scene, accel, px, py, samples, state, params,
                   machines=None, per_round=False):
    """The "spp" mode's tracer (path.trace_lockstep's contract): one
    sample's camera rays through the lanes' pixels, walked in lockstep on
    a kept machine (_LockstepForward): trace()'s radiance, state and
    segment count, bit for bit.  samples is (1, N, 2); returns (la (1, N,
    4), state, rays).  Without a medium every ray escapes to the light
    pass at once: no loop, no machine."""
    if scene.medium is None:
        o, d = _camera(scene, params, px, py)(samples[0])
        le = _no_medium(scene, o, d)
        return (torch.cat([le, torch.ones_like(le[:, :1])], dim=-1)[None],
                state, 0)
    n = px.shape[0]
    machine = _machine(
        machines, ("volume_lockstep", n, params, per_round),
        lambda: _LockstepForward(scene, n, params, px.device, per_round))
    return machine(px, py, samples[0], state)


def trace_diff(scene, accel, o, d, state, params, n_steps=512):
    """trace with at most n_steps flight steps, for autograd through the
    walk (the graph holds every step: the route of small renders and of the
    lockstep gradient).  Returns (L, alpha, state, rays, unfinished):
    unfinished > 0 counts walks that n_steps cut short (their radiance and
    gradients then miss the tail); where it is 0 the result is trace's."""
    ones = torch.ones(o.shape[0], device=o.device)
    if scene.medium is None:
        return _no_medium(scene, o, d), ones, state, 0, 0
    vs, rays = _walk(scene, o, d, state, params, n_steps)
    return vs.l_out, ones, vs.state, rays, int(vs.alive.sum())


def vol_lanes(total):
    """Work slots for `total` items: ~12 sqrt(total) rounded up to a power
    of two, at least 2^14, at most 2^19 and next_pow2(total) (the JAX
    package's policy for the volume machines)."""
    target = 12.0 * float(total) ** 0.5
    n = 1 << max(14, int(np.ceil(np.log2(max(target, 1.0)))))
    return min(n, 1 << 19, _next_pow2(total))


def _no_medium_la(scene, samples, params, render_w, pix_offset=0,
                  n_pix_total=None, row_map=None):
    """No medium on the camera: every item escapes to the light pass.
    Returns (la (spp_chunk, P, 4), rays, rounds = 0).  The shard arguments
    place the pixels (n_pix_total goes unused: nothing draws)."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    px, py, _ = item_pixels(render_w, pix_offset, row_map)(
        torch.arange(n_pix, dtype=torch.int64, device=samples.device))
    out = []
    for jit in samples:
        o, d = camera.cast_rays(scene.cam_to_world, scene.fov,
                                params.image_width, params.image_height,
                                px, py, jit)
        le = _no_medium(scene, o, d)
        out.append(torch.cat([le, torch.ones_like(le[:, :1])], dim=-1))
    return torch.stack(out), spp_chunk * n_pix, 0


def _camera_spawn(scene, params, samples, render_w, chunk_base,
                  pix_offset=0, n_pix_total=None, row_map=None):
    """spawn(item, jitter) -> (o, d, RNG state) of (pixel, sample) items:
    the camera ray and the item's stream, seeded by its global id
    (chunk_base + s) * n_pix_total + pix, chunk_base read from a () int64
    tensor when spawn runs (_chunk_base_tensor); pix_offset, n_pix_total
    and row_map place a shard's items in the global grid
    (path.item_pixels)."""
    n_pix = samples.shape[1]
    n_pix_total = n_pix if n_pix_total is None else n_pix_total
    pixels = item_pixels(render_w, pix_offset, row_map)
    chunk_base = _chunk_base_tensor(chunk_base, samples.device)

    def spawn(item, jit):
        s = item // n_pix
        px, py, pix = pixels(item % n_pix)
        o, d = camera.cast_rays(scene.cam_to_world, scene.fov,
                                params.image_width, params.image_height,
                                px, py, jit)
        gid = ((chunk_base + s) * n_pix_total + pix) & rng.MASK32
        return o, d, _path_stream_seed(gid)

    return spawn


def _fused_round(steps, finish, vs, tables=None, seg=None):
    """FUSE_STEPS flight steps (read when called), then the escape light
    pass once: (vs', died, segment starts); tables and seg as for
    _make_vol_step's steps."""
    vs, died, esc_pending, seg = steps(vs, FUSE_STEPS, tables, seg)
    return finish(vs, esc_pending, tables), died, seg


def _respawn(vs, respawn, o, d, state):
    """Lanes in `respawn` start a fresh walk on (o, d, state)."""
    rm = respawn[:, None]
    return VolState(
        alive=vs.alive | respawn, new_ray=vs.new_ray | respawn,
        bounce=torch.where(respawn, 0, vs.bounce),
        u_mode=torch.where(respawn, 0.0, vs.u_mode),
        t_cur=torch.where(respawn, 0.0, vs.t_cur),
        t_exit=torch.where(respawn, 0.0, vs.t_exit),
        o=torch.where(rm, o, vs.o), d=torch.where(rm, d, vs.d),
        state=torch.where(respawn, state, vs.state),
        beta=torch.where(rm, 1.0, vs.beta),
        l_out=torch.where(rm, 0.0, vs.l_out),
    )


def _queue_parts(scene, samples, params, render_w, chunk_base, n_lanes,
                 tables=None, **shard):
    """The work queue (volume analogue of path._balanced_parts).

    Returns (init, step_round, n): init() -> core0, and step_round(core,
    tables=None, rays=None) -> (core', died, l, item, segment starts),
    where l is the radiance of the lanes whose walk ended this round and
    item the item each lane carried into it; the segment starts are added
    into rays (a () int64 accumulator, returned) where it is given, else
    counted into a new () tensor.  Both read samples and chunk_base (an
    int or a () int64 tensor) as they are when they run.  tables:
    derive_tables's (light partition, density cells), derived here if
    None; step_round's tables replace them for one round.  shard:
    pix_offset, n_pix_total, row_map (_camera_spawn)."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    n = n_lanes or vol_lanes(total)
    dev = samples.device
    samples_flat = samples.reshape(total, 2)
    cam = _camera_spawn(scene, params, samples, render_w, chunk_base,
                        **shard)

    def spawn(item):
        it = item.clamp(0, total - 1)
        return cam(it, samples_flat[it])

    def init():
        item0 = torch.arange(n, dtype=torch.int64, device=dev)
        vs0 = replace(_vol_state(*spawn(item0)), alive=item0 < total)
        return (vs0, item0,
                torch.full((), min(n, total), dtype=torch.int64, device=dev))

    part, cells = tables or derive_tables(scene)
    steps, finish = _make_vol_step(scene, params, part, defer_light=True,
                                   cells=cells)

    def step_round(core, tables=None, rays=None):
        vs, item, head = core
        vs, died, seg = _fused_round(steps, finish, vs, tables, rays)
        l_done = vs.l_out
        # pull the next queue items (prefix sum over this round's deaths)
        dy = died.to(torch.int64)
        new_item = head + torch.cumsum(dy, 0) - dy
        respawn = died & (new_item < total)
        vs = _respawn(vs, respawn, *spawn(new_item))
        core = (vs, torch.where(died, new_item, item), head + dy.sum())
        return core, died, l_done, item, seg

    return init, step_round, n


def _static_parts(scene, samples, params, render_w, chunk_base, n_lanes,
                  tables=None, **shard):
    """Static strided assignment: lane i owns items {i, i+n, i+2n, ...}
    (the `local`-th of them is item local * n + i).  The same interface as
    _queue_parts (init() lays the samples out by lane); an item keeps its
    global stream, so its radiance is the same bits as the queue's."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    n = n_lanes or vol_lanes(total)
    dev = samples.device
    ipl = -(-total // n)  # items per lane
    samples_ipl = torch.zeros((ipl, n, 2), device=dev)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    cam = _camera_spawn(scene, params, samples, render_w, chunk_base,
                        **shard)

    def spawn(local):
        item = local * n + lane
        o, d, st = cam(item.clamp(0, total - 1),
                       samples_ipl[local.clamp(0, ipl - 1), lane])
        return o, d, st, item < total

    def init():
        samples_ipl.view(-1, 2)[:total] = samples.reshape(total, 2)
        local0 = torch.zeros(n, dtype=torch.int64, device=dev)
        o0, d0, st0, live0 = spawn(local0)
        return (replace(_vol_state(o0, d0, st0), alive=live0), local0)

    part, cells = tables or derive_tables(scene)
    steps, finish = _make_vol_step(scene, params, part, defer_light=True,
                                   cells=cells)

    def step_round(core, tables=None, rays=None):
        vs, local = core
        vs, died, seg = _fused_round(steps, finish, vs, tables, rays)
        l_done = vs.l_out
        # advance to the lane's next item
        nxt = local + 1
        o_new, d_new, st_new, live_new = spawn(nxt)
        respawn = died & (nxt < ipl) & live_new
        vs = _respawn(vs, respawn, o_new, d_new, st_new)
        core = (vs, torch.where(died, nxt, local))
        return core, died, l_done, local * n + lane, seg

    return init, step_round, n


def _made(parts):
    """A machine with its first carry made: (core0, step_round, n)."""
    def machine(*args, **kwargs):
        init, step_round, n = parts(*args, **kwargs)
        return init(), step_round, n

    return machine


_queue_machine = _made(_queue_parts)
_static_machine = _made(_static_parts)


class _VolForward:
    """A volume machine's forward for one chunk shape, kept across calls
    (path._BalancedForward's counterpart): samples, chunk_base and row_map
    buffers, the radiance rows, the segment count and the round runner,
    whose rounds are gated by MAX_STEPS on the device."""

    def __init__(self, parts, scene, shape, params, render_w, n_lanes,
                 pix_offset, n_pix_total, row_map_shape, device, per_round):
        spp_chunk, n_pix = shape
        self.total = total = spp_chunk * n_pix
        self.samples = torch.zeros((spp_chunk, n_pix, 2), device=device)
        self.chunk_base = torch.zeros((), dtype=torch.int64, device=device)
        self.row_map = (None if row_map_shape is None else torch.zeros(
            row_map_shape, dtype=torch.int64, device=device))
        self.init, step_round, n = parts(
            scene, self.samples, params, render_w, self.chunk_base, n_lanes,
            pix_offset=pix_offset, n_pix_total=n_pix_total,
            row_map=self.row_map)
        rows = -(-total // n) * n
        # finished items add their radiance once; other lanes add zeros to
        # distinct rows past the end (no host read in a round)
        self.la_out = la_out = torch.zeros((rows + n, 3), device=device)
        self.rays = rays = torch.zeros((), dtype=torch.int64, device=device)
        lane = torch.arange(n, device=device)

        def round_fn(core):  # no reference to self (path._BalancedForward)
            core, died, l_done, item, _ = step_round(core, rays=rays)
            la_out.index_add_(0, torch.where(died, item, rows + lane),
                              torch.where(died[:, None], l_done, 0.0))
            return core

        self.runner = RoundRunner(round_fn, k=1 if per_round else None,
                                  max_rounds=MAX_STEPS,
                                  graph=not per_round)

    def __call__(self, samples, chunk_base, row_map):
        self.samples.copy_(samples)
        self.chunk_base.fill_(chunk_base)
        if row_map is not None:
            self.row_map.copy_(row_map)
        self.la_out.zero_()
        self.rays.zero_()
        _, rounds = self.runner.run(self.init())
        la = self.la_out[:self.total]
        la = torch.cat([la, torch.ones_like(la[:, :1])],
                       dim=-1)  # alpha is 1 (reference parity)
        la = la.reshape(self.samples.shape[:2] + (4,))
        return la, int(self.rays), int(rounds)  # the end's reads


def _run_machine(parts, scene, samples, params, render_w, chunk_base,
                 n_lanes, machines=None, per_round=False, **shard):
    """Forward pass of a machine: (la (spp_chunk, P, 4), rays, rounds).
    machines and per_round as for path.trace_balanced: one kept machine
    per (machine, chunk shape), captured once on the card."""
    if scene.medium is None:
        return _no_medium_la(scene, samples, params, render_w, **shard)
    row_map = shard.get("row_map")
    key = (parts.__name__, tuple(samples.shape[:2]), render_w, n_lanes,
           shard.get("pix_offset", 0), shard.get("n_pix_total"),
           None if row_map is None else tuple(row_map.shape), per_round)
    machine = _machine(machines, key, lambda: _VolForward(
        parts, scene, key[1], params, render_w, n_lanes, key[4], key[5],
        key[6], samples.device, per_round))
    return machine(samples, chunk_base, row_map)


def trace_balanced(scene, accel, samples, params, render_w, render_h,
                   chunk_base=0, n_lanes=0, pix_offset=0, n_pix_total=None,
                   row_map=None, machines=None, per_round=False):
    """Work-queue volume wavefront (path.trace_balanced's contract).

    Args:
      samples: (spp_chunk, P, 2) Latin-square jitters, P = render_w *
        render_h, or a shard's P pixels.
      chunk_base: first global sample index of this chunk.
      n_lanes: work slots; 0 = vol_lanes(spp_chunk * P).
      pix_offset, n_pix_total, row_map: a shard's place in the global grid
        (path.item_pixels).
      machines, per_round: the kept machines and the per-round loop, as for
        path.trace_balanced.
    Returns (la (spp_chunk, P, 4), rays (segment starts), rounds).  Each
    item's stream is seeded by its global (sample, pixel) id, so results do
    not depend on the chunk size or the lane count; the reference's
    per-pixel stream layout belongs to the lockstep mode."""
    return _run_machine(_queue_parts, scene, samples, params, render_w,
                        chunk_base, n_lanes, machines, per_round,
                        pix_offset=pix_offset, n_pix_total=n_pix_total,
                        row_map=row_map)


def trace_vol_static(scene, accel, samples, params, render_w, render_h,
                     chunk_base=0, n_lanes=0, pix_offset=0, n_pix_total=None,
                     row_map=None, machines=None, per_round=False):
    """Static-assignment volume wavefront: trace_balanced's contract and
    per-item results, without the queue's prefix sum.  The render route."""
    return _run_machine(_static_parts, scene, samples, params, render_w,
                        chunk_base, n_lanes, machines, per_round,
                        pix_offset=pix_offset, n_pix_total=n_pix_total,
                        row_map=row_map)


class _VolReplay:
    """The per-round path replay over a volume machine (the reference of
    the kept machine's tests, per_round=True): sum(cot * la) and its
    gradient with respect to the scene's tensors that require grad, one
    round per host check both ways, eagerly."""

    def __init__(self, machine, scene, samples, cot, params, render_w,
                 chunk_base, n_lanes, **shard):
        self.machine, self.scene = machine, scene
        self.args = (samples, params, render_w, chunk_base, n_lanes)
        self.shard = shard  # pix_offset, n_pix_total, row_map
        self.total = samples.shape[0] * samples.shape[1]
        self.cot_flat = cot.reshape(self.total, 4)
        self.leaves = scene_leaves(scene)
        self.saved = []  # per round: the incoming carry
        self.rays = 0

    def _contribution(self, died, l_done, item):
        return _contribution(self.cot_flat, died, l_done, item)

    def forward(self):
        """The rounds without a graph, keeping each round's incoming carry;
        returns the loss (a detached scalar)."""
        with torch.no_grad():
            core, step_round, _ = self.machine(self.scene, *self.args,
                                               **self.shard)
            loss = torch.zeros((), device=self.cot_flat.device)
            rays = torch.zeros((), dtype=torch.int64, device=loss.device)
            # one round, then a host check; the carries kept in a list
            while (len(self.saved) < MAX_STEPS
                   and bool(core[0].alive.any())):
                self.saved.append(core)
                core, died, l_done, item, _ = step_round(core, rays=rays)
                loss = loss + self._contribution(died, l_done, item)
            self.rays = int(rays)
        return loss

    def backward(self, g):
        """g * d loss / d leaf per leaf (None where the loss ignores it):
        re-runs the rounds in reverse with the graph on and pushes the
        adjoint of the carry's beta and l_out (the only carried floats that
        depend on a parameter) through each."""
        with torch.enable_grad():
            proxies = [x.detach().requires_grad_() for x in self.leaves]
            swap = {id(x): p for x, p in zip(self.leaves, proxies)}
            scene = map_tensors(self.scene, lambda t: swap.get(id(t), t))
            _, step_round, _ = self.machine(scene, *self.args, **self.shard)
            grads = [None] * len(proxies)
            adjoint = None  # of (beta, l_out) after the round at hand
            for core_in in reversed(self.saved):
                vs = core_in[0]
                carry = [vs.beta.detach().requires_grad_(),
                         vs.l_out.detach().requires_grad_()]
                core_out, died, l_done, item, _ = step_round(
                    (replace(vs, beta=carry[0], l_out=carry[1]),)
                    + core_in[1:])
                outs = [self._contribution(died, l_done, item)]
                outs_grad = [g]
                if adjoint is not None:
                    out_vs = core_out[0]
                    for y, a in zip((out_vs.beta, out_vs.l_out), adjoint):
                        if a is not None and y.requires_grad:
                            outs.append(y)
                            outs_grad.append(a)
                # retain_graph: the rounds share the cell table built from
                # the proxies; each round's own graph goes with its tensors
                res = torch.autograd.grad(outs, carry + proxies, outs_grad,
                                          allow_unused=True,
                                          retain_graph=True)
                adjoint = res[:2]
                for i, r in enumerate(res[2:]):
                    if r is not None:
                        grads[i] = r if grads[i] is None else grads[i] + r
        self.saved = []
        return grads


def _contribution(cot_flat, died, l_done, item):
    """The loss of the walks that ended in a round: alpha is the constant 1,
    so its cotangent adds c[:, 3] per item."""
    c = cot_flat[item.clamp(0, cot_flat.shape[0] - 1)]
    per_lane = (c[:, :3] * l_done).sum(-1) + c[:, 3]
    return (per_lane * died.to(l_done.dtype)).sum()


class _VolReplayParts:
    """A volume machine's side of a replay.ReplayMachine: the machine's
    round with its loss contribution (the light and density tables derived
    in the round from the scene's leaves), and the carry's adjoint leaves
    (beta, l_out: the only carried floats that depend on a parameter)."""

    def __init__(self, parts, params, render_w, n_lanes, pix_offset,
                 n_pix_total):
        self.parts, self.params = parts, params
        self.render_w, self.n_lanes = render_w, n_lanes
        self.shard = dict(pix_offset=pix_offset, n_pix_total=n_pix_total)

    def make(self, scene, samples, chunk_base, row_map, cot_flat,
             replaying, rays=None):
        base = derive_tables(scene)
        init, step_round, _ = self.parts(
            scene, samples, self.params, self.render_w, chunk_base,
            self.n_lanes, tables=base, row_map=row_map, **self.shard)
        # V1 adds a round's segment starts into the machine's count (the
        # backward's re-run rounds into a count no one reads): no node of
        # their own
        if rays is None:
            rays = torch.zeros((), dtype=torch.int64, device=samples.device)

        def round_(core):
            out, died, l_done, item, _ = step_round(
                core, derive_tables(scene, base), rays)
            return out, _contribution(cot_flat, died, l_done, item), None

        return init, round_, None

    @staticmethod
    def adjoint(vs):
        return [vs.beta, vs.l_out]

    @staticmethod
    def with_adjoint(vs, vals):
        return replace(vs, beta=vals[0], l_out=vals[1])


def _replay_loss(parts, forward, scene, samples, cot, params, render_w,
                 render_h, n_rounds, chunk_base, n_lanes, machines,
                 per_round, **shard):
    if scene.medium is None:
        la, rays, _ = _no_medium_la(scene, samples, params, render_w, **shard)
        return (cot * la).sum(), rays, 0, 0
    if per_round:
        replay = _VolReplay(_made(parts), scene, samples, cot, params,
                            render_w, chunk_base, n_lanes, **shard)
        loss = ReplayLoss.apply(replay, *replay.leaves)
        return loss, replay.rays, 0, len(replay.saved)
    machines = {} if machines is None else machines
    row_map = shard["row_map"]
    row_shape = None if row_map is None else tuple(row_map.shape)
    key = (parts.__name__ + "_replay", tuple(samples.shape[:2]), render_w,
           n_lanes, shard["pix_offset"], shard["n_pix_total"], row_shape,
           params, scene_signature(scene))
    leaves = scene_leaves(scene)

    def build():
        vol_parts = _VolReplayParts(parts, params, render_w, n_lanes,
                                    shard["pix_offset"], shard["n_pix_total"])
        # the forward's MAX_STEPS cut, whatever the capacity
        return ReplayMachine(vol_parts, scene, leaves, key[1], row_shape,
                             samples.device, max_rounds=MAX_STEPS)

    def measure():
        with torch.no_grad():
            return forward(scene, None, samples, params, render_w, render_h,
                           chunk_base, n_lanes, machines=machines,
                           **shard)[2]

    return replay_loss(machines, key, build, leaves, samples, cot,
                       chunk_base, row_map, n_rounds, measure)


def trace_balanced_loss(scene, accel, samples, cot, params, render_w,
                        render_h, n_rounds=None, chunk_base=0, n_lanes=0,
                        pix_offset=0, n_pix_total=None, row_map=None,
                        machines=None, per_round=False):
    """Differentiable work-queue wavefront: loss = sum(cot * la), with
    gradients by path replay (path.trace_balanced_loss's contract).

    The forward pass runs the rounds without an autograd graph and keeps
    each round's incoming carry (O(lanes) per round) in the kept replay
    machine's store; the backward pass re-runs them in reverse with the
    graph on (on the card: the forward k rounds to a host check, the
    backward one captured round graph replayed once a round).  cot:
    (spp_chunk, P, 4).  n_rounds: the store's capacity (None: the kept
    machine's, or the forward's padded count); walks that MAX_STEPS cuts
    are not unfinished.  machines, per_round: as for
    path.trace_balanced_loss.  Returns (loss, rays, unfinished, rounds).
    pix_offset, n_pix_total and row_map place a shard's items in the
    global grid (trace_balanced)."""
    return _replay_loss(_queue_parts, trace_balanced, scene, samples, cot,
                        params, render_w, render_h, n_rounds, chunk_base,
                        n_lanes, machines, per_round, pix_offset=pix_offset,
                        n_pix_total=n_pix_total, row_map=row_map)


def trace_vol_static_loss(scene, accel, samples, cot, params, render_w,
                          render_h, n_rounds=None, chunk_base=0, n_lanes=0,
                          pix_offset=0, n_pix_total=None, row_map=None,
                          machines=None, per_round=False):
    """The replay counterpart of trace_vol_static (trace_balanced_loss's
    contract): the gradient route of grad.py."""
    return _replay_loss(_static_parts, trace_vol_static, scene, samples,
                        cot, params, render_w, render_h, n_rounds,
                        chunk_base, n_lanes, machines, per_round,
                        pix_offset=pix_offset, n_pix_total=n_pix_total,
                        row_map=row_map)

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
  * trace / trace_diff -- lockstep per-pixel walk (the reference's draw
    order; the "spp" mode of render.py and the lockstep gradient route);
  * trace_balanced -- work queue over (pixel, sample) items: a lane whose
    walk ended pulls the next item by prefix sum;
  * trace_vol_static -- lane i owns items i, i + n, i + 2n, ...: the
    render route.  Per-item radiance is the same bits as trace_balanced's.
Both machines run FUSE_STEPS flight steps per round and the escape light
pass once per round.  trace_balanced_loss and trace_vol_static_loss
differentiate them by path replay, as ``path.trace_balanced_loss`` does.
No traversal query runs on any of these paths: the walk never reads the
scene's triangles.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import camera, rng
from ..media import clip_to_aabb, medium_properties_cells, pack_density_cells
from ..sampling import sample_exponential_decay, uniform_sample_sphere
from ..scene import map_tensors
from .path import (
    ReplayLoss,
    _light_partition,
    _nearest_light,
    _next_pow2,
    _path_stream_seed,
    item_pixels,
    scene_leaves,
)

INF = math.inf
# safety cap on steps (lockstep) or rounds (machines): delta tracking ends
# with probability one, a NaN density might not
MAX_STEPS = 1_000_000
# flight steps per round of the two machines: the respawn and the escape
# light pass are paid once per round.  Any value gives the same results
# (draws are per lane, the light pass draws nothing); 4 is the JAX
# package's default
FUSE_STEPS = 4
_SEGMENT_EPS = float(np.float32(1e-4))


@dataclass
class VolState:
    """Wavefront state of the walk, carried from step to step."""

    alive: torch.Tensor  # (N,) bool
    new_ray: torch.Tensor  # (N,) bool: the next step starts a segment
    bounce: torch.Tensor  # (N,) int64 scatter events so far
    u_mode: torch.Tensor  # (N,) event-choice uniform
    t_cur: torch.Tensor  # (N,) distance reached along the segment
    t_exit: torch.Tensor  # (N,) where the segment leaves the medium's box
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    state: torch.Tensor  # (N,) int64 RNG state
    beta: torch.Tensor  # (N, 3) throughput (event ratios, value 1)
    l_out: torch.Tensor  # (N, 3) radiance


def _ratio(p, mask):
    """p / detach(p) where mask, else 1: a unit-valued gradient carrier."""
    safe = torch.where(mask & (p > 0.0), p, 1.0)
    return safe / safe.detach()


def _make_vol_step(scene, params, part, defer_light=False):
    """One delta-tracking flight step: (step, finish).

    step(vs) -> (vs', died, esc): `died` marks lanes whose walk ended this
    step (absorbed, out of scatter events, or escaped).  With
    defer_light=False the escape radiance is added at once and finish is
    not needed; with defer_light=True escaped lanes only set `esc`, and the
    caller applies finish(vs, esc_pending) once after a batch of steps: the
    light pass draws nothing and (o, d, beta) freeze at escape, so this
    changes only when the pass is paid."""
    medium = scene.medium
    lights = scene.lights
    dev = medium.density.device
    # a tensor on the medium's device: CUDA divides by a host scalar as a
    # product with its reciprocal, which is not the same bits
    sigma_maj = torch.tensor(float(np.float32(medium.sigma_maj)), device=dev)
    cells = pack_density_cells(medium.density)  # once per trace

    def light(vs, mask):
        le, _, _ = _nearest_light(lights, part, vs.o, vs.d,
                                  torch.full_like(vs.t_cur, INF))
        return replace(vs, l_out=vs.l_out + torch.where(
            mask[:, None], le * vs.beta, 0.0))

    def step(vs: VolState):
        # ---- a new segment: SampleT_maj's entry (media.h:128-140)
        setup = vs.alive & vs.new_ray
        _, st = rng.masked_next_float(vs.state, setup)  # u: drawn, unused
        um_new, st = rng.masked_next_float(st, setup)
        u_mode = torch.where(setup, um_new, vs.u_mode)
        box_hit, t0, t1 = clip_to_aabb(vs.o, vs.d, medium.bounds_min,
                                       medium.bounds_max)
        t_cur = torch.where(setup, torch.clamp(t0, min=0.0), vs.t_cur)
        t_exit = torch.where(setup, t1, vs.t_exit)
        # the segment misses the box or ends at once: escape
        esc_now = setup & (~box_hit | (t_cur + _SEGMENT_EPS > t_exit))
        new_ray = vs.new_ray & ~setup

        # ---- the flight step (media.h:147-178)
        flying = vs.alive & ~esc_now
        u_t, st = rng.masked_next_float(st, flying)
        t = t_cur + sample_exponential_decay(u_t, sigma_maj)
        left_segment = flying & (t >= t_exit)
        p = vs.o + vs.d * t[:, None]
        inside, s_a, s_s, le_med = medium_properties_cells(medium, cells, p)
        in_medium = flying & ~left_segment
        left_medium = in_medium & ~inside  # SampleMedium returned false

        sampling_lane = in_medium & inside
        p_absorb = s_a / sigma_maj
        p_scatter = s_s / sigma_maj
        pa_det, ps_det = p_absorb.detach(), p_scatter.detach()
        absorb = sampling_lane & (u_mode < pa_det)
        scatter = sampling_lane & ~absorb & (u_mode < pa_det + ps_det)
        null = sampling_lane & ~absorb & ~scatter

        # event-probability ratios (value 1): the gradients' carriers
        beta = vs.beta * _ratio(p_absorb, absorb)[:, None]
        beta = beta * _ratio(p_scatter, scatter)[:, None]
        beta = beta * _ratio(1.0 - p_absorb - p_scatter, null)[:, None]

        # absorb: L += Le * beta, the walk ends (volumeintegrator.cpp:30-35)
        l_out = vs.l_out + torch.where(absorb[:, None], le_med * beta, 0.0)

        # scatter: past the bounce limit the walk ends, else a new segment
        over = scatter & (vs.bounce > params.bounces)
        bounce = vs.bounce + scatter.to(vs.bounce.dtype)
        redirect = scatter & ~over
        s1, st = rng.masked_next_float(st, redirect)
        s2, st = rng.masked_next_float(st, redirect)
        w_new, _ = uniform_sample_sphere(torch.stack([s1, s2], -1))
        o = torch.where(redirect[:, None], p, vs.o)
        d = torch.where(redirect[:, None], w_new, vs.d)
        new_ray = new_ray | redirect

        # null: redraw uMode, fly on from t
        um2, st = rng.masked_next_float(st, null)
        u_mode = torch.where(null, um2, u_mode)
        t_cur = torch.where(null, t, t_cur)

        # escape: left the segment or the medium, or missed the box
        # (volumeintegrator.cpp:66-80)
        esc = esc_now | left_segment | left_medium
        ended = absorb | over | esc
        out = VolState(
            alive=vs.alive & ~ended, new_ray=new_ray, bounce=bounce,
            u_mode=u_mode, t_cur=t_cur, t_exit=t_exit, o=o, d=d, state=st,
            beta=beta, l_out=l_out)
        if not defer_light:
            out = light(out, esc)
        return out, vs.alive & ended, esc

    return step, light


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


def _segment_starts(vs):
    return (vs.alive & vs.new_ray).sum()


def _walk(scene, o, d, state, params, max_steps):
    """The lockstep walk: (VolState after it, segment starts)."""
    step, _ = _make_vol_step(scene, params,
                             _light_partition(scene.lights, o.device))
    vs = _vol_state(o, d, state)
    rays = torch.zeros((), dtype=torch.int64, device=o.device)
    for _ in range(max_steps):
        if not bool(vs.alive.any()):
            break
        rays = rays + _segment_starts(vs)
        vs, _, _ = step(vs)
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
    integrator's ray count.  accel is not read."""
    ones = torch.ones(o.shape[0], device=o.device)
    if scene.medium is None:  # every ray escapes at once
        return _no_medium(scene, o, d), ones, state, 0
    vs, rays = _walk(scene, o, d, state, params, MAX_STEPS)
    return vs.l_out, ones, vs.state, rays


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
    (chunk_base + s) * n_pix_total + pix; pix_offset, n_pix_total and
    row_map place a shard's items in the global grid (path.item_pixels)."""
    n_pix = samples.shape[1]
    n_pix_total = n_pix if n_pix_total is None else n_pix_total
    pixels = item_pixels(render_w, pix_offset, row_map)

    def spawn(item, jit):
        s = item // n_pix
        px, py, pix = pixels(item % n_pix)
        o, d = camera.cast_rays(scene.cam_to_world, scene.fov,
                                params.image_width, params.image_height,
                                px, py, jit)
        gid = ((chunk_base + s) * n_pix_total + pix) & rng.MASK32
        return o, d, _path_stream_seed(gid)

    return spawn


def _fused_round(step, finish, vs):
    """FUSE_STEPS flight steps, then the escape light pass once: (vs',
    died, segment starts)."""
    died = torch.zeros_like(vs.alive)
    esc_pending = torch.zeros_like(vs.alive)
    seg = torch.zeros((), dtype=torch.int64, device=vs.o.device)
    for _ in range(FUSE_STEPS):
        seg = seg + _segment_starts(vs)
        vs, died_k, esc_k = step(vs)
        died = died | died_k
        esc_pending = esc_pending | esc_k
    return finish(vs, esc_pending), died, seg


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


def _queue_machine(scene, samples, params, render_w, chunk_base, n_lanes,
                   **shard):
    """The work queue (volume analogue of path._balanced_machine).

    Returns (core0, step_round, n): step_round(core) -> (core', died, l,
    item, segment starts), where l is the radiance of the lanes whose walk
    ended this round and item the item each lane carried into it.  shard:
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

    item0 = torch.arange(n, dtype=torch.int64, device=dev)
    vs0 = replace(_vol_state(*spawn(item0)), alive=item0 < total)
    core0 = (vs0, item0, torch.tensor(min(n, total), device=dev))
    step, finish = _make_vol_step(scene, params,
                                  _light_partition(scene.lights, dev),
                                  defer_light=True)

    def step_round(core):
        vs, item, head = core
        vs, died, seg = _fused_round(step, finish, vs)
        l_done = vs.l_out
        # pull the next queue items (prefix sum over this round's deaths)
        dy = died.to(torch.int64)
        new_item = head + torch.cumsum(dy, 0) - dy
        respawn = died & (new_item < total)
        vs = _respawn(vs, respawn, *spawn(new_item))
        core = (vs, torch.where(died, new_item, item), head + dy.sum())
        return core, died, l_done, item, seg

    return core0, step_round, n


def _static_machine(scene, samples, params, render_w, chunk_base, n_lanes,
                    **shard):
    """Static strided assignment: lane i owns items {i, i+n, i+2n, ...}
    (the `local`-th of them is item local * n + i).  The same interface as
    _queue_machine; an item keeps its global stream, so its radiance is
    the same bits as the queue's."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    n = n_lanes or vol_lanes(total)
    dev = samples.device
    ipl = -(-total // n)  # items per lane
    samples_ipl = torch.cat(
        [samples.reshape(total, 2),
         torch.zeros((ipl * n - total, 2), device=dev)]).reshape(ipl, n, 2)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    cam = _camera_spawn(scene, params, samples, render_w, chunk_base,
                        **shard)

    def spawn(local):
        item = local * n + lane
        o, d, st = cam(item.clamp(0, total - 1),
                       samples_ipl[local.clamp(0, ipl - 1), lane])
        return o, d, st, item < total

    local0 = torch.zeros(n, dtype=torch.int64, device=dev)
    o0, d0, st0, live0 = spawn(local0)
    core0 = (replace(_vol_state(o0, d0, st0), alive=live0), local0)
    step, finish = _make_vol_step(scene, params,
                                  _light_partition(scene.lights, dev),
                                  defer_light=True)

    def step_round(core):
        vs, local = core
        vs, died, seg = _fused_round(step, finish, vs)
        l_done = vs.l_out
        # advance to the lane's next item
        nxt = local + 1
        o_new, d_new, st_new, live_new = spawn(nxt)
        respawn = died & (nxt < ipl) & live_new
        vs = _respawn(vs, respawn, o_new, d_new, st_new)
        core = (vs, torch.where(died, nxt, local))
        return core, died, l_done, local * n + lane, seg

    return core0, step_round, n


def _run_machine(machine, scene, samples, params, render_w, chunk_base,
                 n_lanes, **shard):
    """Forward pass of a machine: (la (spp_chunk, P, 4), rays, rounds)."""
    spp_chunk, n_pix = samples.shape[0], samples.shape[1]
    total = spp_chunk * n_pix
    if scene.medium is None:
        return _no_medium_la(scene, samples, params, render_w, **shard)
    core, step_round, n = machine(scene, samples, params, render_w,
                                  chunk_base, n_lanes, **shard)
    rows = -(-total // n) * n
    # finished items add their radiance once; other lanes add zeros to
    # distinct rows past the end (no host sync per round)
    la_out = torch.zeros((rows + n, 3), device=samples.device)
    lane = torch.arange(n, device=samples.device)
    rays = torch.zeros((), dtype=torch.int64, device=samples.device)
    rounds = 0
    while rounds < MAX_STEPS and bool(core[0].alive.any()):
        core, died, l_done, item, seg = step_round(core)
        la_out.index_add_(0, torch.where(died, item, rows + lane),
                          torch.where(died[:, None], l_done, 0.0))
        rays = rays + seg
        rounds += 1
    la = torch.cat([la_out[:total], torch.ones_like(la_out[:total, :1])],
                   dim=-1)  # alpha is 1 (reference parity)
    return la.reshape(spp_chunk, n_pix, 4), int(rays), rounds


def trace_balanced(scene, accel, samples, params, render_w, render_h,
                   chunk_base=0, n_lanes=0, pix_offset=0, n_pix_total=None,
                   row_map=None):
    """Work-queue volume wavefront (path.trace_balanced's contract).

    Args:
      samples: (spp_chunk, P, 2) Latin-square jitters, P = render_w *
        render_h, or a shard's P pixels.
      chunk_base: first global sample index of this chunk.
      n_lanes: work slots; 0 = vol_lanes(spp_chunk * P).
      pix_offset, n_pix_total, row_map: a shard's place in the global grid
        (path.item_pixels).
    Returns (la (spp_chunk, P, 4), rays (segment starts), rounds).  Each
    item's stream is seeded by its global (sample, pixel) id, so results do
    not depend on the chunk size or the lane count; the reference's
    per-pixel stream layout belongs to the lockstep mode."""
    return _run_machine(_queue_machine, scene, samples, params, render_w,
                        chunk_base, n_lanes, pix_offset=pix_offset,
                        n_pix_total=n_pix_total, row_map=row_map)


def trace_vol_static(scene, accel, samples, params, render_w, render_h,
                     chunk_base=0, n_lanes=0, pix_offset=0, n_pix_total=None,
                     row_map=None):
    """Static-assignment volume wavefront: trace_balanced's contract and
    per-item results, without the queue's prefix sum.  The render route."""
    return _run_machine(_static_machine, scene, samples, params, render_w,
                        chunk_base, n_lanes, pix_offset=pix_offset,
                        n_pix_total=n_pix_total, row_map=row_map)


class _VolReplay:
    """Path replay over a volume machine: sum(cot * la) and its gradient
    with respect to the scene's tensors that require grad."""

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
        # alpha is the constant 1: its cotangent adds c[:, 3] per item
        c = self.cot_flat[item.clamp(0, self.total - 1)]
        per_lane = (c[:, :3] * l_done).sum(-1) + c[:, 3]
        return (per_lane * died.to(l_done.dtype)).sum()

    def forward(self):
        """The rounds without a graph, keeping each round's incoming carry;
        returns the loss (a detached scalar)."""
        with torch.no_grad():
            core, step_round, _ = self.machine(self.scene, *self.args,
                                               **self.shard)
            loss = torch.zeros((), device=self.cot_flat.device)
            rays = torch.zeros((), dtype=torch.int64, device=loss.device)
            while (len(self.saved) < MAX_STEPS
                   and bool(core[0].alive.any())):
                self.saved.append(core)
                core, died, l_done, item, seg = step_round(core)
                loss = loss + self._contribution(died, l_done, item)
                rays = rays + seg
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


def _replay_loss(machine, scene, samples, cot, params, render_w, chunk_base,
                 n_lanes, **shard):
    if scene.medium is None:
        la, rays, _ = _no_medium_la(scene, samples, params, render_w, **shard)
        return (cot * la).sum(), rays, 0, 0
    replay = _VolReplay(machine, scene, samples, cot, params, render_w,
                        chunk_base, n_lanes, **shard)
    loss = ReplayLoss.apply(replay, *replay.leaves)
    return loss, replay.rays, 0, len(replay.saved)


def trace_balanced_loss(scene, accel, samples, cot, params, render_w,
                        render_h, n_rounds=None, chunk_base=0, n_lanes=0,
                        pix_offset=0, n_pix_total=None, row_map=None):
    """Differentiable work-queue wavefront: loss = sum(cot * la), with
    gradients by path replay (path.trace_balanced_loss's contract).

    The forward pass runs the rounds without a graph and keeps each round's
    incoming carry (O(lanes) per round); the backward pass re-runs them in
    reverse with the graph on.  cot: (spp_chunk, P, 4).  n_rounds is
    accepted and ignored (the loop ends when no lane is alive).  Returns
    (loss, rays, unfinished = 0, rounds).  pix_offset, n_pix_total and
    row_map place a shard's items in the global grid (trace_balanced)."""
    return _replay_loss(_queue_machine, scene, samples, cot, params,
                        render_w, chunk_base, n_lanes, pix_offset=pix_offset,
                        n_pix_total=n_pix_total, row_map=row_map)


def trace_vol_static_loss(scene, accel, samples, cot, params, render_w,
                          render_h, n_rounds=None, chunk_base=0, n_lanes=0,
                          pix_offset=0, n_pix_total=None, row_map=None):
    """The replay counterpart of trace_vol_static (trace_balanced_loss's
    contract): the gradient route of grad.py."""
    return _replay_loss(_static_machine, scene, samples, cot, params,
                        render_w, chunk_base, n_lanes, pix_offset=pix_offset,
                        n_pix_total=n_pix_total, row_map=row_map)

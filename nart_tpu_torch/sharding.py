"""Multi-process rendering and training over torch.distributed.

Counterpart of ``nart_tpu/sharding.py``.  The JAX package runs one
controller over a device mesh (``shard_map`` + ``psum``); here every card
has its own process, the usual torch.distributed model:

  * ``Layout(n_row, n_spp)`` is the mesh: rank r owns row rank r // n_spp
    and sample slab r % n_spp (``make_mesh`` is ``Layout(n, 1)``,
    ``make_mesh2(n_tiles, n_spp)`` is ``Layout(n_tiles, n_spp)``);
  * a render is striped rows x spp slabs: the rows go in strips of
    max(8, 2 * filter_bounds + 2) dealt round-robin over the row ranks
    (path length is spatially systematic: contiguous slabs balance worse),
    and each rank traces its (rows, sample slab) block with the tracer of
    the session's mode (RenderSession.trace_chunk) and splats each strip
    at its global row.  "balanced" items are (pixel, sample) pairs on
    global streams; "spp"/"regen" run a pixel's samples in order on its
    one stream, so there every rank is a row rank (no sample slabs);
  * the partial films are summed with one all_reduce (render_sharded), and
    so are the loss and the gradient of a sharded replay
    (radiance_weighted_loss_and_grad_sharded): the counterpart of the psum
    that ``jax.grad`` inserts through the sharded render.

Determinism: every item's RNG stream is keyed by its global (pixel,
sample) id, and the per-pixel Latin squares are drawn for the full spp, so
every sample decision is the same for any layout; films differ only by the
association order of the sums (1e-6), and a layout of one is the same bits
as RenderSession.  The strip splats add at distinct film rows, so a film is
the same bits from run to run on the card too.  A rank traces only real
rows and samples: rows and slabs may be uneven.

``render_shard`` and ``radiance_weighted_loss_and_grad_shard`` need no
process group: summing them over the ranks of a layout in one process is
the same computation (the tests and chip_smoke.py do that).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import film, grad, resolve_device, rng, sampling
from .render import chunk_size, trace_mode


@dataclass(frozen=True)
class Layout:
    """n_row row ranks x n_spp sample-slab ranks; rank r is (r // n_spp,
    r % n_spp), as ``np.array(devs).reshape(n_row, n_spp)`` lays out the
    JAX package's 2-D mesh."""

    n_row: int = 1
    n_spp: int = 1

    def __post_init__(self):
        if self.n_row < 1 or self.n_spp < 1:
            raise ValueError(f"bad layout {self}")

    @property
    def world_size(self):
        return self.n_row * self.n_spp

    def coords(self, rank):
        """(row rank, sample-slab rank) of a rank."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} outside {self}")
        return rank // self.n_spp, rank % self.n_spp


def local_device():
    """This process's card, cuda:{LOCAL_RANK} (LOCAL_RANK as torchrun sets
    it, 0 when unset); raises where that card does not exist."""
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name device='cpu' for a CPU rank")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} but only "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def init_distributed(init_method=None, rank=None, world_size=None,
                     backend=None, device=None):
    """Join the process group and return this rank's device.

    device: the rank's device, the card cuda:{LOCAL_RANK} unless one is
    named.  backend: NCCL for a CUDA device, gloo for the CPU; an explicit
    backend wins (gloo lets two ranks share one card, which NCCL refuses),
    and NCCL with a CPU device raises.  No other backend is tried when one
    fails.  init_method: "tcp://host:port" with rank and world_size, or
    None for torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE)."""
    dev = local_device() if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL reduces CUDA tensors only (device {dev})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=-1 if rank is None else rank,
        world_size=-1 if world_size is None else world_size)
    return dev


def is_primary() -> bool:
    """True on the process that owns side effects (EXR write, logs): rank 0,
    or the only process when no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_sum(t):
    """SUM of ``t`` over the process group, in place.  gloo reduces host
    memory: a CUDA tensor goes through a host copy there."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def _check_world(layout):
    if layout.world_size != dist.get_world_size():
        raise ValueError(f"{layout} needs {layout.world_size} ranks, the "
                         f"group has {dist.get_world_size()}")


def strips_of(layout, row_rank, render_h, filter_bounds):
    """(first row, rows) of the strips a row rank owns: strips of
    max(8, 2 * filter_bounds + 2) rows dealt round-robin (all rows in one
    strip when there is one row rank).  Strips of one rank are separated by
    at least a strip, more than the filter reaches, so their splat windows
    never overlap.  The last strip of the image may be short."""
    sr = render_h if layout.n_row == 1 else max(8, 2 * filter_bounds + 2)
    return [(g * sr, min(sr, render_h - g * sr))
            for g in range(row_rank, -(-render_h // sr), layout.n_row)]


def sample_slab(layout, spp_rank, spp):
    """[s0, s1): the samples of a slab rank, ceil(spp / n_spp) each (the
    last ones may be short or empty)."""
    per = -(-spp // layout.n_spp)
    s0 = min(spp_rank * per, spp)
    return s0, min(s0 + per, spp)


def _block(layout, rank, width, height, filter_bounds, spp):
    """A rank's strips, its global rows (int64 tensor) and sample slab."""
    row_rank, spp_rank = layout.coords(rank)
    strips = strips_of(layout, row_rank, height, filter_bounds)
    rows = [torch.arange(r0, r0 + h) for r0, h in strips]
    rows = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64)
    return strips, rows, sample_slab(layout, spp_rank, spp)


def _strip_stack(strips, render_w, filter_bounds, device):
    """How _splat_strips stacks a rank's strips into one image: each strip's
    rows, then K = 2 * filter_bounds + 1 filler rows.  Returns (src: the
    rank's lane behind each stacked lane, real: False on filler lanes, dst:
    the film row of each row of the stacked splat's window)."""
    k = 2 * filter_bounds + 1
    src, real, dst = [], [], []
    lane0 = 0
    for row0, h in strips:
        src += [torch.arange(lane0, lane0 + h * render_w),
                torch.zeros(k * render_w, dtype=torch.int64)]
        real += [torch.ones(h * render_w, dtype=torch.bool),
                 torch.zeros(k * render_w, dtype=torch.bool)]
        dst.append(torch.arange(row0, row0 + h + k))
        lane0 += h * render_w
    return tuple(torch.cat(x).to(device) for x in (src, real, dst))


def _splat_strips(buf, jitter, la, stack, render_w, filter_width,
                  filter_bounds, table):
    """Splat one sample of a rank's lanes (its strips' rows, row-major) into
    the film, each strip at its global row.  With the strips stacked
    (_strip_stack), one film.splat_windows call makes every strip's window,
    the masked filler rows keep each window off the next strip, and the
    windows are added at their film rows."""
    src, real, dst = stack
    la_st = torch.where(real[:, None], la[src], 0.0)
    acc = film.splat_windows(jitter[src], la_st, filter_width, table,
                             render_w, dst.shape[0], filter_bounds,
                             real_mask=real)[:dst.shape[0]]
    h_tot, w_tot, _ = buf.shape
    ww = min(w_tot, acc.shape[1])
    keep = dst < h_tot
    add = torch.zeros((int(keep.sum()), w_tot, 5), device=buf.device)
    add[:, :ww] = acc[keep, :ww]
    buf.index_add_(0, dst[keep], add)


def render_shard(session, layout: Layout, rank: int):
    """One rank's partial film of a RenderSession, and its stats.

    The rank's strips x its sample slab, in chunks of render.chunk_size,
    through session.trace_chunk; the per-pixel Latin squares are drawn for
    the full spp and the slab cut out of them.  In "spp"/"regen" the layout
    counts as Layout(world_size, 1): a pixel's samples run in order on its
    stream.  Needs no process group.  Returns (film (totalH, totalW, 5) on
    the session's device, {"rays", "rounds"}); the films of all ranks of
    the layout sum to the whole image's."""
    p = session.params
    dev = session.device
    rw, rh = session.render_w, session.render_h
    fb = session.filter_bounds
    buf = torch.zeros((session.total_h, session.total_w, 5), device=dev)
    layout.coords(rank)  # validates the rank
    if trace_mode(p) != "balanced":
        layout = Layout(layout.world_size, 1)
    strips, rows, (s0, s1) = _block(layout, rank, rw, rh, fb, p.spp)
    rays = rounds = 0
    if not rows.numel() or s0 == s1:
        return buf, {"rays": rays, "rounds": rounds}
    rows = rows.to(dev)
    px = torch.arange(rw, device=dev).repeat(rows.shape[0])
    py = rows.repeat_interleave(rw)
    samples, state = sampling.latin_square(
        rng.seed(py * session.total_w + px), p.spp)
    samples = samples.transpose(0, 1)
    table = film.filter_table(dev)
    stack = _strip_stack(strips, rw, fb, dev)
    chunk = chunk_size(p)
    for i in range(s0, s1, chunk):
        j = min(i + chunk, s1)
        la, state, r, k = session.trace_chunk(samples[i:j], state, i, px, py,
                                              row_map=rows)
        for s in range(j - i):
            _splat_strips(buf, samples[i + s], la[s], stack, rw,
                          p.filter_width, fb, table)
        rays += r
        rounds += k
    return buf, {"rays": rays, "rounds": rounds}


def render_sharded(session, layout: Layout):
    """render_shard of this process's rank, then one all_reduce (SUM) of the
    film: the merged film lands on every rank.  Returns (film, this rank's
    stats)."""
    _check_world(layout)
    buf, stats = render_shard(session, layout, dist.get_rank())
    return all_reduce_sum(buf), stats


def radiance_weighted_loss_and_grad_shard(
        scene, theta, accel, samples, cot, params, width, height,
        layout: Layout, rank: int, chunk_base=0, lanes=0, device=None):
    """One rank's share of grad.radiance_weighted_loss_and_grad: its
    (strips, sample slab) block of the items of samples (spp, width *
    height, 2) and cot (spp, width * height, 4), replayed with the block's
    row_map, n_pix_total = width * height and chunk_base + the slab start,
    so every item keeps its global stream.  Needs no process group.
    Returns (loss, grads, rays, rounds) of the block; the losses and the
    gradients of all ranks of the layout sum to the whole chunk's."""
    fb = int(np.ceil(params.filter_width))
    _, rows, (s0, s1) = _block(layout, rank, width, height, fb,
                               samples.shape[0])
    if not rows.numel() or s0 == s1:
        dev = resolve_device(device)
        flat = grad.flatten_leaves(theta)
        zeros = grad.unflatten_like(
            torch.zeros(flat.shape, device=dev), theta)
        return torch.zeros((), device=dev), zeros, 0, 0
    pix = (rows[:, None] * width + torch.arange(width)).reshape(-1)
    pix = pix.to(samples.device)
    return grad.radiance_weighted_loss_and_grad(
        scene, theta, accel, samples[s0:s1][:, pix],
        cot[s0:s1][:, pix.to(cot.device)], params, width, rows.shape[0],
        chunk_base=chunk_base + s0, lanes=lanes, device=device,
        n_pix_total=width * height, row_map=rows)


def radiance_weighted_loss_and_grad_sharded(
        scene, theta, accel, samples, cot, params, width, height,
        layout: Layout, chunk_base=0, lanes=0, device=None):
    """radiance_weighted_loss_and_grad_shard of this process's rank, then
    one all_reduce (SUM) of the loss and one of every gradient leaf,
    flattened into one buffer.  Returns (loss, grads, rays, rounds): the
    whole chunk's loss and gradient on every rank, this rank's rays and
    rounds."""
    _check_world(layout)
    loss, grads, rays, rounds = radiance_weighted_loss_and_grad_shard(
        scene, theta, accel, samples, cot, params, width, height, layout,
        dist.get_rank(), chunk_base, lanes, device)
    loss = all_reduce_sum(loss.clone())
    flat = all_reduce_sum(grad.flatten_leaves(grads))
    return loss, grad.unflatten_like(flat, grads), rays, rounds

"""The scaling evidence of a striped render, rank by rank on one card.

Counterpart of ``tools/scaling_evidence.py``, which records the terms that
limit an N-device render's efficiency on eight virtual CPU devices.  Here
the ranks of ``sharding.Layout(N, 1)`` run one after another on one card
through ``sharding.render_shard`` (which needs no process group), each
tracing its strips of 8 rows dealt round-robin, as an N-card render does:

  * each rank's work-queue ROUND COUNT: every round is a full-lane pass of
    the same cost, so a rank's wall time follows its rounds, and mean /
    max rounds bounds the data-parallel efficiency from above
    (``round_balance_efficiency``);
  * each rank's DRAIN-TAIL rounds: rounds that began with the queue head
    past the chunk's last item, lanes finishing their last paths (counted
    on the device by the work queue, path.trace_balanced), and their share
    of the rank's rounds;
  * each rank's rays, and its device ms: CUDA-event ms around the rank's
    render_shard on the stream, after an untimed call of rank 0 that
    captured the session's graph (null on the CPU: no device time);
  * the bytes of the collectives: the film all-reduce of
    ``sharding.render_sharded`` (the film, (totalH, totalW, 5) float32),
    the JAX tool's psum of its striped film (rows * N + K) x (totalW + K)
    x 5 float32, K = 2 ceil(filterWidth) + 1, and the gradient all-reduce
    of a sharded replay, 4 bytes a trainable value (grad.get_params): all
    O(output), independent of spp and bounces.

The scene and settings are the JAX tool's: simple_glass
(``testing.simple_scene(("glass", "glass", "lambert"), priorities=[2, 3,
0])``), 256x256 @ 64 spp, 10 bounces, filter width 2, roughening 0.2;
with the port's default accel (the cluster kernels, where the JAX tool
scanned "brute": both find the nearest hit, so the paths are the same but
for ties) and its chunks of min(spp, 32) samples (the JAX tool ran all
spp in one).

    python -m nart_tpu_torch.scaling_evidence [size] [spp] [--ranks N]
        [--out PATH] [--device DEV]

writes one JSON object to --out (or stdout), never into the repository;
beside the fields it names the card and its power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import bench, grad, render, resolve_device, sharding, testing

def session(size=256, spp=64, device=None):
    """The JAX tool's scene and settings as a RenderSession on device (the
    card unless one is named)."""
    scene = testing.simple_scene(("glass", "glass", "lambert"),
                                 priorities=[2, 3, 0])
    params = render.RenderParams(
        image_width=size, image_height=size, spp=spp, bounces=10,
        filter_width=2.0, roughening_factor=0.2)
    return render.RenderSession(scene, params, device)


def psum_film_bytes(size, n_ranks, filter_width):
    """tools/scaling_evidence.py's film psum: its striped film of
    ceil(size / N) rows a device plus the filter's K rows, over a width of
    size + 4 plus K, 5 float32 channels."""
    k = 2 * int(np.ceil(filter_width)) + 1
    rows = -(-size // n_ranks)
    return (rows * n_ranks + k) * (size + 4 + k) * 5 * 4


def grad_bytes(scene):
    """The gradient all-reduce of a sharded replay: every trainable value of
    the scene (grad.get_params), 4 bytes each."""
    return int(grad.flatten_leaves(grad.get_params(scene)).numel()) * 4


def _rank(sess, layout, r):
    """render_shard of rank r: (stats, device ms or None)."""
    if sess.device.type != "cuda":
        return sharding.render_shard(sess, layout, r, drain=True)[1], None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, stats = sharding.render_shard(sess, layout, r, drain=True)
    end.record()
    torch.cuda.synchronize(sess.device)
    return stats, start.elapsed_time(end)


def evidence(size=256, spp=64, ranks=8, device=None):
    """The record of ranks 0..ranks-1 of Layout(ranks, 1), run one after
    another on one device (a dict; see the module's docstring), on one
    session: its kept machines serve every rank's chunks of one shape."""
    dev = resolve_device(device)
    sess = session(size, spp, dev)
    layout = sharding.Layout(ranks, 1)
    if dev.type == "cuda":
        sharding.render_shard(sess, layout, 0, drain=True)  # the capture
    per = [_rank(sess, layout, r) for r in range(ranks)]
    rounds = np.array([s["rounds"] for s, _ in per], np.float64)
    drain = np.array([s["drain"] for s, _ in per], np.float64)
    busy = rounds > 0
    p = sess.params
    (_, strip), *_ = sharding.strips_of(layout, 0, sess.render_h,
                                        sess.filter_bounds)
    return {
        "config": f"{size}x{size}@{spp}spp bounces={p.bounces} "
                  "(glass nested scene)",
        "row_assignment": f"striped, strips of {strip} rows",
        "n_ranks": ranks,
        "accel": p.accel,
        "spp_chunk": render.chunk_size(p),
        "rounds_per_rank": [int(x) for x in rounds],
        "rounds_mean": float(rounds.mean()),
        "rounds_max": float(rounds.max()),
        "round_balance_efficiency": float(rounds.mean() / rounds.max()),
        "drain_tail_rounds": [int(x) for x in drain],
        "drain_tail_fraction": float((drain[busy] / rounds[busy]).mean()),
        "rays_per_rank": [int(s["rays"]) for s, _ in per],
        "device_ms_per_rank": [ms for _, ms in per],
        "all_reduce_film_bytes": sess.total_h * sess.total_w * 5 * 4,
        "psum_film_bytes_per_step": psum_film_bytes(size, ranks,
                                                    p.filter_width),
        "psum_grad_bytes_per_step": grad_bytes(sess.scene),
        "device": bench.device_name(dev),
        "note": ("the ranks of one layout run one after another on one "
                 "device; wall per rank ~ rounds (each round is a "
                 "fixed-cost full-lane pass); efficiency upper bound = "
                 "mean/max rounds; collectives are O(output), independent "
                 "of spp"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", type=int, nargs="?", default=256)
    ap.add_argument("spp", type=int, nargs="?", default=64)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="write the JSON here (default: stdout)")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    args = ap.parse_args(argv)
    out = evidence(args.size, args.spp, args.ranks, args.device)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Visit counters of the cluster traversal: what the closest-hit and the
any-hit walk do on given rays.

Counterpart of ``tools/kernel_stats.py``, the JAX package's TPU tool.  It
answers, per ray: how many supercluster slab tests were made (every
supercluster, but for an any-hit ray that is occluded before the last), how
many superclusters passed theirs, how many
member-cluster slab tests were done, how many clusters had their triangles
tested, and how many rays of the ray's warp shared those triangle tests
(the TPU tool's live-lane census of a 512-ray block, restated for a 32-lane
warp).  These are the data-dependent operation counts that the bounds of the
closest-hit and any-hit kernels are reckoned from, each from its own walk:
the any-hit walk ends at a ray's first cluster with a hit (the TPU tool
counts the closest-hit walk only).

    python -m nart_tpu_torch.kernel_stats [scene.json] [--asset-root DIR]

prints them for coherent camera rays and for random directions from the
same origins, for both walks, on the card (``--device cpu`` runs the plain
versions).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import camera, resolve_device
from .cluster_accel import (
    WARP,
    ClusterAccel,
    any_hit_stats_cuda,
    any_hit_stats_plain,
    build_clusters,
    closest_hit_stats_cuda,
    closest_hit_stats_plain,
)
from .scene import load_scene

DEFAULT_SCENE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "macbeth", "macbeth.json")


def traversal_stats(o, d, t_min, t_max, accel: ClusterAccel, any_hit=False):
    """The walk's counters per ray, with the closest-hit t (TraversalStats)
    or, for any_hit, the occlusion (AnyHitStats): CUDA tensors launch
    nart_closest_hit_stats / nart_any_hit_stats, CPU tensors run the plain
    version."""
    if o.device.type == "cuda":
        fn = any_hit_stats_cuda if any_hit else closest_hit_stats_cuda
    elif o.device.type == "cpu":
        fn = any_hit_stats_plain if any_hit else closest_hit_stats_plain
    else:
        raise ValueError(f"no traversal-stats path for device {o.device}")
    return fn(o, d, t_min, t_max, accel)


def summarize(st) -> dict:
    """Means per ray of the walk's counters of a TraversalStats or
    AnyHitStats, and the mean number of rays that share a cluster's
    triangle tests."""
    tested = int(st.tested.sum())
    return {
        "sc_tests": float(st.sc_tests.double().mean()),
        "visited_sc": float(st.visited.double().mean()),
        "slab_tests": float(st.slabs.double().mean()),
        "tri_tests": float(st.tested.double().mean()),
        "lanes_per_test": int(st.together.sum()) / max(tested, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default=DEFAULT_SCENE)
    ap.add_argument("--asset-root", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    ap.add_argument("--rays", type=int, default=32768)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scene = load_scene(args.scene, asset_root=args.asset_root)
    acc = build_clusters(scene.tri_v.numpy()).to(dev)
    print(f"n_cl={acc.n_clusters} n_sc={acc.n_sc} sc_size={acc.sc_size} "
          f"csize={acc.csize} device={dev}")

    # the tool's rays: whole rows of a 256x256 view, through the pixels'
    # corners; the rows lie around the view's middle (the tool's own scene
    # fills its upper half, which it takes)
    n = args.rays
    idx = torch.arange(n, dtype=torch.int64)
    top = max(0, (256 - n // 256) // 2)
    o, d = camera.cast_rays(scene.cam_to_world, scene.fov, 256, 256,
                            idx % 256, (top + idx // 256) % 256,
                            torch.zeros(n, 2))
    d_inc = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    d_inc /= np.linalg.norm(d_inc, axis=-1, keepdims=True)
    o, d, d_inc = o.to(dev), d.to(dev), torch.from_numpy(d_inc).to(dev)
    t_min = torch.zeros(n, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    out = {}
    for label in ("coherent", "incoherent"):
        st = traversal_stats(o, d, t_min, t_max, acc)
        st_any = traversal_stats(o, d, t_min, t_max, acc, any_hit=True)
        out[label] = summarize(st)
        out[label + " any-hit"] = summarize(st_any)
        for key in (label, label + " any-hit"):
            s = out[key]
            print(f"[{key}] visited_sc mean={s['visited_sc']:.1f} "
                  f"slabs mean={s['slab_tests']:.1f} "
                  f"tri_tests mean={s['tri_tests']:.1f} "
                  f"lanes/test={s['lanes_per_test']:.1f}/{WARP}", flush=True)
        # second pass: random directions, from just before the points the
        # camera rays hit (the tool shoots them from the camera, which sits
        # inside its scene; a camera outside would see them all miss)
        hit = torch.isfinite(st.t)
        back = torch.where(hit, st.t - 1e-3, 0.0)
        o, d = (o + d * back[:, None]).contiguous(), d_inc
    return out


if __name__ == "__main__":
    main()

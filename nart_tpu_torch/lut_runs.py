"""The large tables' runs: how many lanes of one backward look-up share a
table row on the main path's differentiable rounds.

    python -m nart_tpu_torch.lut_runs [--width W] [--height H] [--spp S]

One per-round fwd+bwd (grad.radiance_weighted_loss_and_grad, per_round:
every round eager) of macbeth (tests/fixtures/macbeth) and of volume_blob
(tests/golden/volume_blob.json, its medium read from this checkout) at
1280x720 unless told otherwise, one chunk of the image's Latin-square
samples, cotangents 1 on RGB.  Every backward look-up that select takes
to the large-table kernel (select._large: more than 64 rows, or rows of
more than 4 values) is counted by its table's (rows, width): the
launches, their lanes, the most rows one launch touches, and the longest
run of one row (with that row).  A run is what PyTorch's
indexing_backward walks serially, and what csrc/large_lut.cu sums by
blocks.  The figures are kept on the device and read once at the end.

Prints a "#" line per (scene, table) and one JSON line.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from . import bench, cluster_accel, grad, render, resolve_device, select
from .bench_configs import REPO, load_scene_doc
from .scene import load_scene

MACBETH = os.path.join(REPO, "tests", "fixtures", "macbeth", "macbeth.json")
VOLUME = os.path.join(REPO, "tests", "golden", "volume_blob.json")


def _count(seen, g, idx, n):
    """Add one backward look-up of clamped rows idx to seen[(n, C)]."""
    per_row = torch.zeros(n, dtype=torch.int64, device=idx.device)
    per_row.index_add_(0, idx, torch.ones_like(idx))
    top, touched = per_row.max(), (per_row > 0).sum()
    rec = seen.setdefault((n, 1 if g.dim() == 1 else g.shape[1]), {
        "launches": 0, "lanes": 0, "rows": touched, "run": top,
        "row": per_row.argmax()})
    rec["launches"] += 1
    rec["lanes"] = max(rec["lanes"], idx.shape[0])
    rec["row"] = torch.where(top > rec["run"], per_row.argmax(), rec["row"])
    rec["run"] = torch.maximum(rec["run"], top)
    rec["rows"] = torch.maximum(rec["rows"], touched)


@contextlib.contextmanager
def counting():
    """Within it, each backward look-up that takes the large-table kernel
    is counted into the yielded dict, {(n, C): figures}, before it runs
    (select.lut_gather_bwd, the look-up Function's backward, is wrapped;
    the kernel and its launch count are unchanged)."""
    seen, inner = {}, select.lut_gather_bwd

    def bwd(g, idx, n):
        if select._large(g, n):
            _count(seen, g, idx, n)
        return inner(g, idx, n)

    select.lut_gather_bwd = bwd
    try:
        yield seen
    finally:
        select.lut_gather_bwd = inner


def runs(scene, accel, params, device):
    """One per-round fwd+bwd of one chunk of the image's samples:
    {(n, C): {"launches", "lanes", "rows", "run", "row"}} of its
    large-table backward look-ups."""
    w, h = params.image_width, params.image_height
    samples = render.image_samples(
        w, h, w + 2 * int(np.ceil(params.filter_width)), params.spp, device)
    cot = bench.rgb_cot(params.spp, w * h, device)
    with counting() as seen:
        grad.radiance_weighted_loss_and_grad(
            scene, grad.get_params(scene), accel, samples, cot, params, w, h,
            device=device, per_round=True)
    return {k: {f: int(v) for f, v in rec.items()}
            for k, rec in sorted(seen.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    size = {"image_width": args.width, "image_height": args.height,
            "spp": args.spp}
    mac = load_scene(MACBETH, asset_root=os.path.dirname(MACBETH))
    p_mac = render.load_sessions(MACBETH, size)[0]
    vol = load_scene_doc(VOLUME, os.path.dirname(VOLUME))
    if vol.medium is None:
        raise RuntimeError("blob.vol was not loaded: no medium")
    p_vol = render.load_sessions(VOLUME, size)[0]
    out = {}
    for label, scene, accel, params in (
            ("macbeth", mac,
             cluster_accel.build_accel(mac.tri_v.numpy(), p_mac.accel),
             p_mac),
            ("volume_blob", vol, None, p_vol)):
        for (n, c), rec in runs(scene, accel, params, dev).items():
            out[f"{label}, n={n}, C={c}"] = rec
            print(f"# {label}, a table of {n} rows of {c}: "
                  f"{rec['launches']} backward launches of {rec['lanes']} "
                  f"lanes, at most {rec['rows']} rows touched a launch, the "
                  f"longest run of one row {rec['run']} lanes (row "
                  f"{rec['row']})", file=sys.stderr, flush=True)
    print(json.dumps({"size": size, "tables": out,
                      "device": bench.device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()

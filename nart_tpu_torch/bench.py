"""The port's headline line: Mrays/s of a forward render, or of the
fwd+bwd (path-replay) work of a training step, on the card.

    python -m nart_tpu_torch.bench

Counterpart of the JAX package's ``bench.py``, with its config: the
reference checkout's glassSphere.json (REFERENCE) at NART_BENCH_SIZE (512)
square, NART_BENCH_SPP (16) spp, 10 bounces, filter width 2,
rougheningFactor 0.2; NART_BENCH_MODE is fwdbwd (the default) or fwd.
Where the reference checkout is absent it renders
``testing.simple_scene(("glass", "glass", "lambert"), priorities=[2, 3,
0])``, and the metric names that scene ("simple_glass").

Protocol, in one process: one warm-up run, then the median of `repeats`
(3) timed runs and their min-max spread.  Forward:
``RenderSession.render()`` between two ``torch.cuda.synchronize()`` calls,
rays from its stats.  fwd+bwd: ``fwdbwd_run``, chunks of 16 spp through
``grad.radiance_weighted_loss_and_grad`` with cot 1 on RGB and 0 on alpha,
the gradients summed over the chunks; its rate is one forward's rays over
the fwd+bwd seconds.

Prints one JSON line: metric, value, unit, vs_baseline and device
(nvidia-smi's "name, power.limit" of the card).  vs_baseline is the
reference renderer's CPU time for glassSphere 512x512 @ 16 spp, 321.66 s
(BASELINE.md: the anchor the JAX bench keeps), scaled by pixel-samples, over
the median forward seconds; it is null unless the scene rendered was
glassSphere, since the anchor times no other scene.  "#" lines on stderr give
the same ratio against the fresh build's 137.58 s (null likewise), and each
mode's per-run seconds, rounds, peak device memory and traversal-kernel
launches (over its timed runs).  With no device named and no card, it
raises (resolve_device).
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

from . import grad, render, resolve_device, testing
from .cluster_accel import launch_counts, reset_launch_counts
from .scene import load_scene

# the reference renderer's checkout, where the JAX package's bench.py and
# tests/test_golden.py look for it
REFERENCE = "/root/reference"
REF_SCENE = os.path.join(REFERENCE, "input", "scenes", "glassSphere.json")
# the reference's CPU seconds for glassSphere 512x512 @ 16 spp (BASELINE.md):
# the anchor of vs_baseline, and the fresh build's time
ANCHOR_S, FRESH_S = 321.66, 137.58
CHUNK = 16
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "device")


def bench_scene():
    """(name, scene): glassSphere from the reference checkout, else the
    three-quad glass stack."""
    if os.path.exists(REF_SCENE):
        return "glassSphere", load_scene(REF_SCENE, asset_root=REFERENCE)
    return "simple_glass", testing.simple_scene(
        ("glass", "glass", "lambert"), priorities=[2, 3, 0])


def device_name(dev):
    """nvidia-smi's "name, power.limit" of dev's card, queried by its UUID
    (nvidia-smi's indices ignore CUDA_VISIBLE_DEVICES); "cpu" for the
    CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return dev.type
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    if not uuid.startswith("GPU-"):
        uuid = "GPU-" + uuid
    return subprocess.run(
        ["nvidia-smi", f"--id={uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rgb_cot(n_samples, n_pix, device):
    """Cotangents 1 on RGB, 0 on alpha: (n_samples, n_pix, 4)."""
    cot = torch.ones((n_samples, n_pix, 4), device=device)
    cot[..., 3] = 0.0
    return cot


def fwdbwd_run(sess, samples, cot, chunk=CHUNK):
    """One fwd+bwd pass over the session's image: `chunk` samples at a time
    through radiance_weighted_loss_and_grad (cot: one chunk's), the
    gradients summed over the chunks (the loss is a sum over samples, so the
    sum is exact).  Returns (rays, rounds, grads): rays one forward's."""
    p = sess.params
    theta = grad.get_params(sess.scene)
    rays = rounds = 0
    total = g = None
    for i in range(0, p.spp, chunk):
        j = min(i + chunk, p.spp)
        _, g, r, k = grad.radiance_weighted_loss_and_grad(
            sess.scene, theta, sess.accel, samples[i:j], cot[:j - i], p,
            p.image_width, p.image_height, chunk_base=i, device=sess.device)
        rays += r
        rounds += k
        flat = grad.flatten_leaves(g)
        total = flat if total is None else total + flat
    return rays, rounds, grad.unflatten_like(total, g)


def timed(dev, fn, repeats):
    """fn() once to warm up, then `repeats` times between synchronizes:
    (the timed runs' seconds, the last run's output, their peak device
    memory in MiB (None on the CPU), their traversal-kernel launches)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    seconds = []
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**20
            if dev.type == "cuda" else None)
    return seconds, out, peak, dict(launch_counts)


def measure(sess, mode="fwdbwd", repeats=3):
    """The bench's timings of a session: {"fwd": ...} and, where mode is
    "fwdbwd", {"fwdbwd": ...}, each with the timed runs' seconds, their
    median, the spread ((max - min) / median, percent), one run's rays and
    rounds, the peak device memory and the launches (see timed)."""
    if mode not in ("fwd", "fwdbwd"):
        raise ValueError(f"mode must be fwd or fwdbwd (got {mode!r})")
    dev = sess.device

    def stats(fn):
        seconds, (rays, rounds), peak, launches = timed(dev, fn, repeats)
        med = statistics.median(seconds)
        return {"seconds": seconds, "median_s": med,
                "spread_pct": 100.0 * (max(seconds) - min(seconds)) / med,
                "rays": rays, "rounds": rounds, "peak_mib": peak,
                "launches": launches}

    def forward():
        sess.render()
        return sess.stats["rays"], sess.stats["rounds"]

    out = {"fwd": stats(forward)}
    if mode == "fwdbwd":
        p = sess.params
        samples = render.image_samples(p.image_width, p.image_height,
                                       sess.total_w, p.spp, dev)
        cot = rgb_cot(min(p.spp, CHUNK), samples.shape[1], dev)
        out["fwdbwd"] = stats(lambda: fwdbwd_run(sess, samples, cot)[:2])
    return out


def run(size, spp, mode="fwdbwd", device=None, repeats=3):
    """Render the bench scene at size x size, spp, and time it (measure).
    Returns the line's keys (LINE_KEYS), plus "scene", "vs_fresh" (vs
    the fresh build's time) and "runs" (measure's dict).  vs_baseline and
    vs_fresh are None unless the scene was glassSphere."""
    dev = resolve_device(device)
    name, scene = bench_scene()
    params = render.RenderParams(
        image_width=size, image_height=size, spp=spp, bounces=10,
        filter_width=2.0, roughening_factor=0.2)
    sess = render.RenderSession(scene, params, dev)
    runs = measure(sess, mode, repeats)
    headline = runs[mode]
    fwd_s = runs["fwd"]["median_s"]
    scale = size * size * spp / (512 * 512 * 16)

    def vs(anchor_s):
        return anchor_s * scale / fwd_s if name == "glassSphere" else None

    label = "fwd+bwd" if mode == "fwdbwd" else "fwd"
    return {
        "metric": f"Mrays/s/chip {label} {name} {size}x{size}@{spp}spp",
        "value": headline["rays"] / headline["median_s"] / 1e6,
        "unit": "Mrays/s",
        "vs_baseline": vs(ANCHOR_S),
        "device": device_name(dev),
        "scene": name,
        "vs_fresh": vs(FRESH_S),
        "runs": runs,
    }


def main():
    size = int(os.environ.get("NART_BENCH_SIZE", "512"))
    spp = int(os.environ.get("NART_BENCH_SPP", "16"))
    mode = os.environ.get("NART_BENCH_MODE", "fwdbwd")
    res = run(size, spp, mode)
    for label, r in res["runs"].items():
        print(f"# {label}: seconds {r['seconds']}, median {r['median_s']} s, "
              f"spread {r['spread_pct']}%, {r['rays']} rays, {r['rounds']} "
              f"rounds, peak {r['peak_mib']} MiB", file=sys.stderr)
        print(f"# {label} launches: {json.dumps(r['launches'])}",
              file=sys.stderr)
    print(f"# vs the fresh reference build ({FRESH_S} s scaled): "
          f"{res['vs_fresh']}", file=sys.stderr, flush=True)
    print(json.dumps({k: res[k] for k in LINE_KEYS}), flush=True)


if __name__ == "__main__":
    main()

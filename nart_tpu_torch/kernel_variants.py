"""Development tool: what each design choice of csrc/cluster_hit.cu buys.

    python -m nart_tpu_torch.kernel_variants [--rounds 3] [--reps 20]

Builds the kernel source as it is and variants of it made by exact text
substitution (``VARIANTS``; a substitution whose anchor is not found exactly
once raises, so an edit of the source that outdates a variant shows at
once, and tests/test_torch_kernel_variants.py checks it without a card):

  * ``loads twice`` / ``tests twice``: each cluster tile is loaded, or each
    ray's triangle tests are run, a second time with the same results.  The
    time a variant adds is what one pass of loads, or of tests, costs inside
    the kernel.  (Compiling a pass out instead would find no hits and so
    lengthen the walk.)
  * ``no register cap``: ``__launch_bounds__`` without its blocks-per-SM
    argument, so the compiler takes the registers it wants and fewer warps
    fit an SM;
  * ``plane first``: the triangle test solves the plane equation, with its
    IEEE division, before the edge functions instead of after them.

It prints ptxas' registers and spill bytes for every instantiation of every
variant, then, ``--rounds`` times over, one row per variant: CUDA-event
medians (ms) of the closest-hit and any-hit kernels on 65,536 camera rays
and 131,072 rays from hit points of the macbeth scene and on 65,536 rays
through a 40,000-triangle soup, and whether every output equals the
as-built kernel's.  The package's wrappers are left as they are: the tool
hands them a variant's library in place of the one cuda_build would load.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

from . import camera, cluster_accel as ca, cuda_build
from .kernel_stats import DEFAULT_SCENE
from .scene import load_scene

SOURCE = os.path.join(cuda_build.SRC_DIR, "cluster_hit.cu")

# a zero that the compiler cannot know, for the repeated passes
_ZERO = [
    ("struct Accel {",
     "__device__ volatile int g_zero;\n\nstruct Accel {"),
    ("  const int stride = a.n_cl * a.csize;\n",
     "  const int stride = a.n_cl * a.csize;\n  const int zero = g_zero;\n"),
]
_LOAD = "              p[k][q] = r < a.csize ? src[q * stride] : 0.0f;\n"
_REDUCE = """            if constexpr (kAny) {
              if (__any_sync(kFull, hit) && lane == owner) {
"""
_PLANE = """  float d_dot_n = d[0] * p[9] + d[1] * p[10] + d[2] * p[11];
  float o_dot_n = o[0] * p[9] + o[1] * p[10] + o[2] * p[11];
  t = (p[12] - o_dot_n) / d_dot_n;
  if (!(t > t_min && t < t_hi)) return false;
"""
_EDGES = "  float px[3], py[3];\n#pragma unroll\n  for (int k = 0; k < 3; ++k) {\n    float ca ="

VARIANTS = {
    "as built": [],
    "loads twice": _ZERO + [(_LOAD, _LOAD + """              {
                const float again =
                    r < a.csize ? src[q * stride + zero] : 0.0f;
                p[k][q] = again == p[k][q] ? p[k][q] : again;
              }
""")],
    "tests twice": _ZERO + [(_REDUCE, """            {
              float t2 = 0.0f, f0 = 0.0f, f1 = 0.0f, fs = 1.0f;
              int tile2 = 0;
              const float hi2 = t_hi + (float)zero;
              const bool hit2 =
                  mj == 0 ? lane_test<kTiles, 0>(p, ro, rd, ra.w, rb.w, rc.x,
                                                 hi2, t2, tile2, f0, f1, fs)
                  : mj == 1
                      ? lane_test<kTiles, 1>(p, ro, rd, ra.w, rb.w, rc.x, hi2,
                                             t2, tile2, f0, f1, fs)
                      : lane_test<kTiles, 2>(p, ro, rd, ra.w, rb.w, rc.x, hi2,
                                             t2, tile2, f0, f1, fs);
              hit = hit && hit2 && t2 == t && tile2 == tile;
            }
""" + _REDUCE)],
    "no register cap": [("__launch_bounds__(kThreads, kBlocksPerSm)",
                         "__launch_bounds__(kThreads)")],
    "plane first": [(_PLANE, ""), (_EDGES, _PLANE + _EDGES)],
}


def variant_sources() -> dict:
    """{variant: its source text}, each substitution applied exactly once."""
    with open(SOURCE) as f:
        base = f.read()
    out = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"variant {name!r}: anchor found "
                                 f"{text.count(old)} times:\n{old}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(name, text):
    """nvcc on one variant's source: (library path, ptxas' report)."""
    root = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(root, exist_ok=True)
    stem = os.path.join(root, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(text)
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", stem + ".so", stem + ".cu"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    return stem + ".so", proc.stderr


def ptxas_rows(report):
    """(kTiles, kAny, kStats, registers, spill store bytes, spill load
    bytes) of every walk_kernel instantiation in a ptxas -v report."""
    rows = []
    for m in re.finditer(
            r"walk_kernelILi(\d)ELb([01])ELb([01])E.*?(\d+) bytes spill "
            r"stores, (\d+) bytes spill loads.*?Used (\d+) registers",
            report, re.S):
        tiles, any_hit, stats, st, ld, regs = (int(x) for x in m.groups())
        rows.append((tiles, bool(any_hit), bool(stats), regs, st, ld))
    return sorted(rows)


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ray_sets(dev, rng):
    """The three ray sets of the smoke run's kernel phase, by its recipe:
    {label: (rays, accel)}."""
    sc = load_scene(DEFAULT_SCENE)
    acc = ca.build_clusters(sc.tri_v.numpy()).to(dev)
    n, m = 65536, 131072
    o, d = camera.cast_rays(
        sc.cam_to_world, sc.fov, 1280, 720,
        torch.from_numpy(rng.integers(0, 1280, n)),
        torch.from_numpy(rng.integers(0, 720, n)),
        torch.from_numpy(rng.random((n, 2), dtype=np.float32)))
    o, d = o.to(dev), d.to(dev)
    cam = (o, d, torch.zeros(n, device=dev),
           torch.full((n,), float("inf"), device=dev))
    hit = ca.intersect_clusters(*cam, acc)
    idx = torch.nonzero(hit.tri >= 0)[:, 0]
    pick = idx[torch.from_numpy(rng.integers(0, len(idx), m)).to(dev)]
    d2 = rng.normal(size=(m, 3)).astype(np.float32)
    d2 = torch.from_numpy(d2 / np.linalg.norm(d2, axis=-1, keepdims=True))
    d2 = d2.to(dev)
    v = sc.tri_v.to(dev)[hit.tri[pick]]
    gn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    side = torch.where((gn * d2).sum(-1) > 0, 1.0, -1.0)
    gn = gn / gn.norm(dim=-1, keepdim=True)
    o2 = (o[pick] + d[pick] * hit.t[pick, None]
          + gn * (1e-3 * side)[:, None]).contiguous()
    t2 = np.where(rng.random(m) < 0.25, 0.0,
                  np.where(rng.random(m) < 0.5, np.inf,
                           rng.exponential(3.0, m))).astype(np.float32)
    sh = (o2, d2, torch.zeros(m, device=dev), torch.from_numpy(t2).to(dev))

    tri = (rng.normal(size=(40000, 3, 3)) * 0.3
           + rng.normal(size=(40000, 1, 3)) * 8.0).astype(np.float32)
    acc_b = ca.build_clusters(tri).to(dev)
    ob = (rng.normal(size=(n, 3)) * 10.0).astype(np.float32)
    db = rng.normal(size=(n, 3)).astype(np.float32)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    tb = np.where(rng.random(n) < 0.25, 0.0, np.inf).astype(np.float32)
    soup = (torch.from_numpy(ob).to(dev), torch.from_numpy(db).to(dev),
            torch.zeros(n, device=dev), torch.from_numpy(tb).to(dev))
    return {"camera": (cam, acc), "hit points": (sh, acc),
            "soup": (soup, acc_b)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    sources = variant_sources()
    with ThreadPoolExecutor() as pool:  # one nvcc each, all started together
        built = dict(zip(sources, pool.map(_build, sources,
                                           sources.values())))
    for name, (_, report) in built.items():
        for tiles, any_hit, stats, regs, st, ld in ptxas_rows(report):
            print(f"ptxas {name}: walk_kernel<{tiles}, "
                  f"{'any' if any_hit else 'closest'}"
                  f"{', stats' if stats else ''}> {regs} registers, spill "
                  f"stores {st} B, spill loads {ld} B", flush=True)

    sets = ray_sets(torch.device("cuda"), np.random.default_rng(0))
    cases = {}  # label: a kernel through its wrapper, returning one tensor
    for label in ("camera", "soup"):
        cases["closest-hit " + label] = (
            lambda r=sets[label]: ca.intersect_clusters(*r[0], r[1]).tri)
    for label in ("hit points", "soup"):
        cases["any-hit " + label] = (
            lambda r=sets[label]: ca.intersect_clusters_any(*r[0], r[1]))
    want = {}
    for rnd in range(args.rounds):
        for name, (so, _) in built.items():
            lib = ctypes.CDLL(so)
            with mock.patch.object(cuda_build, "load", lambda _name: lib):
                same = True
                times = []
                for label, fn in cases.items():
                    same &= torch.equal(fn(), want.setdefault(label, fn()))
                    times.append(f"{label} {cuda_ms(fn, args.reps):.4f}")
            print(f"round {rnd + 1} {name:16s} " + "  ".join(times)
                  + f"  same={same}", flush=True)
            if not same:
                raise AssertionError(f"variant {name!r} changed a result")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of nart_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device: require CUDA; print the card's name and nvidia-smi's
     "name, power.limit" line;
  2. build: compile the CUDA kernels from nart_tpu_torch/csrc into
     build/nart_tpu_torch (timed);
  3. kernels against their plain PyTorch versions on the card: (a) the
     macbeth scene's clusters with 65,536 camera rays and 131,072
     random-direction rays from the hit points (25% with t_max = 0);
     (b) a random 40,000-triangle soup (the >= 32k cluster policy) with
     65,536 rays.  Triangle ids must agree on >= 99.99% of rays, t/u/v to
     rtol 1e-4 / atol 1e-5 where they agree, and any-hit must equal
     closest-hit validity exactly.  Median times of kernel and plain
     version (CUDA events, after warm-up);
  4. golden parity: macbeth at 96x96, 8 spp, through the kernels, against
     tests/golden/macbeth_96x96_8spp.exr (read with the port's PIZ
     reader) with test_macbeth_golden's criteria;
  5. main path: render_scene_file on macbeth.json at its own 1280x720 with
     spp cut from 256 to 16 (to fit the smoke's time): one warm run, one
     timed run with launch counters reset just before it; EXR written to a
     temporary directory and checked finite with a nonzero mean.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs the repository checkout (it imports
nart_tpu_torch from beside this file); imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MACBETH_DIR = os.path.join(HERE, "tests", "fixtures", "macbeth")
MACBETH = os.path.join(MACBETH_DIR, "macbeth.json")
GOLDEN = os.path.join(HERE, "tests", "golden", "macbeth_96x96_8spp.exr")
SOURCE = "nart_tpu_torch/csrc/cluster_hit.cu"
REPLACES = {"closest_hit": "nart_tpu/pallas_accel.py:605",  # _kernel
            "any_hit": "nart_tpu/pallas_accel.py:773"}  # _kernel_any
TRI_AGREE = 0.9999
RTOL, ATOL = 1e-4, 1e-5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    import torch

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


def random_rays(n, rng, center, spread):
    o = (center + rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def compare_closest(name, hk, hp):
    """Kernel hit record vs plain: returns (agree fraction, max abs err)."""
    import torch

    agree = hk.tri == hp.tri
    frac = float(agree.float().mean())
    both = agree & (hp.tri >= 0)
    err = 0.0
    for k in ("t", "u", "v"):
        a, b = getattr(hk, k)[both], getattr(hp, k)[both]
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            bad = (~torch.isclose(a, b, rtol=RTOL, atol=ATOL)).sum()
            raise AssertionError(f"{name}: {k} differs on {int(bad)} rays")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    if frac < TRI_AGREE:
        raise AssertionError(f"{name}: tri agrees on only {frac:.6f}")
    return frac, err


def kernel_checks(device, sizes):
    """Phase 3.  Returns the per-kernel records at the main-path shapes
    (the macbeth rays)."""
    import torch

    from nart_tpu_torch import camera, cluster_accel as ca, scene

    rng = np.random.default_rng(0)
    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    acc = ca.build_clusters(sc.tri_v.numpy()).to(device)
    log(f"macbeth: {sc.n_tris} triangles, {acc.n_clusters} clusters of "
        f"{acc.csize}, {acc.n_sc} superclusters")

    # (a1) camera rays through random pixels of the 1280x720 view
    n = sizes["camera_rays"]
    px = torch.from_numpy(rng.integers(0, 1280, n))
    py = torch.from_numpy(rng.integers(0, 720, n))
    jit = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
    o, d = camera.cast_rays(sc.cam_to_world, sc.fov, 1280, 720, px, py, jit)
    o, d = o.to(device), d.to(device)
    t_min = torch.zeros(n, device=device)
    t_max = torch.full((n,), float("inf"), device=device)
    cam = (o, d, t_min, t_max)
    hk = ca.intersect_clusters(*cam, acc)
    hp = ca.closest_hit_plain(*cam, acc)
    frac, err_c = compare_closest("closest-hit camera", hk, hp)
    log(f"(a) closest-hit, {n} camera rays: tri agree {frac:.6f}, "
        f"hits {int((hp.tri >= 0).sum())}, max abs err {err_c:.3g}")

    # (a2) random-direction rays from the camera rays' hit points
    m = sizes["shadow_rays"]
    hit_idx = torch.nonzero(hp.tri >= 0)[:, 0]
    pick = hit_idx[torch.from_numpy(rng.integers(0, len(hit_idx), m)).to(device)]
    p = o[pick] + d[pick] * hp.t[pick, None]
    d2 = torch.from_numpy(random_rays(m, rng, 0.0, 1.0)[1]).to(device)
    v = sc.tri_v.to(device)[hp.tri[pick]]
    gn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    side = torch.where((gn * d2).sum(-1) > 0, 1.0, -1.0)
    gn = gn / gn.norm(dim=-1, keepdim=True)
    o2 = (p + gn * (1e-3 * side)[:, None]).contiguous()
    t2 = torch.from_numpy(np.where(
        rng.random(m) < 0.25, 0.0,
        np.where(rng.random(m) < 0.5, np.inf, rng.exponential(3.0, m)),
    ).astype(np.float32)).to(device)
    sh = (o2, d2, torch.zeros(m, device=device), t2)
    hk2 = ca.intersect_clusters(*sh, acc)
    hp2 = ca.closest_hit_plain(*sh, acc)
    frac2, err_c2 = compare_closest("closest-hit secondary", hk2, hp2)
    occ_k = ca.intersect_clusters_any(*sh, acc)
    occ_p = ca.any_hit_plain(*sh, acc)
    if not torch.equal(occ_k, hk2.tri >= 0):
        raise AssertionError("any-hit != closest-hit validity on "
                             f"{int((occ_k != (hk2.tri >= 0)).sum())} rays")
    occ_agree = float((occ_k == occ_p).float().mean())
    if occ_agree < TRI_AGREE:
        raise AssertionError(f"any-hit vs plain agrees on {occ_agree:.6f}")
    err_a = float((occ_k.float() - occ_p.float()).abs().max())
    log(f"(a) {m} rays from hit points (25% t_max=0): tri agree "
        f"{frac2:.6f}, occluded {int(occ_k.sum())}, any-hit vs plain "
        f"{occ_agree:.6f}, any-hit == closest-hit validity: exact")

    # (b) random 40k-triangle soup: the >= 32k policy
    nt = sizes["soup_tris"]
    tri = (rng.normal(size=(nt, 3, 3)) * 0.3
           + rng.normal(size=(nt, 1, 3)) * 8.0).astype(np.float32)
    acc_b = ca.build_clusters(tri).to(device)
    nb = sizes["soup_rays"]
    ob, db = random_rays(nb, rng, 0.0, 10.0)
    rb = (torch.from_numpy(ob).to(device), torch.from_numpy(db).to(device),
          torch.zeros(nb, device=device),
          torch.from_numpy(np.where(rng.random(nb) < 0.25, 0.0, np.inf)
                           .astype(np.float32)).to(device))
    hkb = ca.intersect_clusters(*rb, acc_b)
    hpb = ca.closest_hit_plain(*rb, acc_b)
    fracb, _ = compare_closest("closest-hit soup", hkb, hpb)
    occb = ca.intersect_clusters_any(*rb, acc_b)
    if not torch.equal(occb, hkb.tri >= 0):
        raise AssertionError("soup: any-hit != closest-hit validity")
    log(f"(b) soup {nt} triangles (csize {acc_b.csize}, {acc_b.n_clusters} "
        f"clusters, sc_size {acc_b.sc_size}), {nb} rays: tri agree "
        f"{fracb:.6f}, hits {int((hpb.tri >= 0).sum())}, any-hit exact")

    # times at the main-path shapes
    reps = sizes["reps"]
    t_k1 = cuda_ms(lambda: ca.intersect_clusters(*cam, acc), reps)
    t_p1 = cuda_ms(lambda: ca.closest_hit_plain(*cam, acc), max(3, reps // 4))
    t_k2 = cuda_ms(lambda: ca.intersect_clusters_any(*sh, acc), reps)
    t_p2 = cuda_ms(lambda: ca.any_hit_plain(*sh, acc), max(3, reps // 4))
    t_kb = cuda_ms(lambda: ca.intersect_clusters(*rb, acc_b), reps)
    t_pb = cuda_ms(lambda: ca.closest_hit_plain(*rb, acc_b), 3, warmup=1)
    log(f"time closest-hit {n} camera rays: kernel {t_k1:.4f} ms, plain "
        f"{t_p1:.4f} ms")
    log(f"time any-hit {m} secondary rays: kernel {t_k2:.4f} ms, plain "
        f"{t_p2:.4f} ms")
    log(f"time closest-hit soup {nb} rays: kernel {t_kb:.4f} ms, plain "
        f"{t_pb:.4f} ms")
    return {
        "closest_hit": {"max_abs_err": max(err_c, err_c2), "ms": t_k1,
                        "plain_ms": t_p1},
        "any_hit": {"max_abs_err": err_a, "ms": t_k2, "plain_ms": t_p2},
    }


def block_compare(ours, ref, mean_tol, block_tol, block_frac):
    """tests/test_golden.py _compare: image mean and 16x16 block means."""
    r, o = ref[..., :3], ours[..., :3]
    mean_rel = abs(o.mean() - r.mean()) / max(r.mean(), 1e-6)
    h, w = r.shape[:2]
    rb = r[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    ob = o[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    rel = np.abs(ob.mean((1, 3, 4)) - rb.mean((1, 3, 4))) / np.maximum(
        rb.mean((1, 3, 4)), 0.05)
    frac = float((rel < block_tol).mean())
    log(f"golden: mean rel {mean_rel:.5f} (< {mean_tol}), blocks within "
        f"{block_tol}: {frac:.3f} (>= {block_frac}), worst {rel.max():.4f}")
    if not (mean_rel < mean_tol and frac >= block_frac):
        raise AssertionError("golden comparison failed")


def golden_check(device, size):
    """Phase 4."""
    from nart_tpu_torch import cluster_accel as ca, exr, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.resolve_params(
        {}, dict(image_width=size[0], image_height=size[1], spp=size[2]))
    before = dict(ca.launch_counts)
    sess = render.RenderSession(sc, params, device)
    ours = sess.image().cpu().numpy()
    grew = {k: ca.launch_counts[k] - before[k] for k in before}
    log(f"golden render {size[0]}x{size[1]} {size[2]} spp: {sess.stats}, "
        f"launches {grew}")
    if min(grew.values()) <= 0:
        raise AssertionError(f"kernels not launched by the render: {grew}")
    ref = exr.read(GOLDEN)
    if ref.shape != ours.shape:
        raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
    block_compare(ours, ref, 0.03, 0.12, 0.95)


def main_path(device, overrides):
    """Phase 5: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, exr, film, render

    params, sess = next(render.render_scene_file(MACBETH, overrides,
                                                 device=device))
    log(f"main path: macbeth.json {params.image_width}x{params.image_height}"
        f" at {params.spp} spp (the scene's own session has 256 spp; cut to "
        f"{params.spp} for the smoke's time), filterWidth "
        f"{params.filter_width}, rougheningFactor {params.roughening_factor}")
    t0 = time.perf_counter()
    sess.render()
    torch.cuda.synchronize()
    log(f"warm run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    buf = sess.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ca.launch_counts)
    rays, rounds = sess.stats["rays"], sess.stats["rounds"]
    log(f"timed run {dt:.4f} s, {rounds} rounds, {rays} rays (algorithmic), "
        f"{rays / dt / 1e6:.4f} Mrays/s, launches {counts}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        "MiB")
    img = film.finalize(buf, params.image_width, params.image_height,
                        sess.filter_bounds)
    with tempfile.TemporaryDirectory() as tmp:
        path = sess.write_exr(os.path.join(tmp, "macbeth"), img=img)
        back = exr.read(path)
    mean = float(img[..., :3].mean())
    if not (bool(torch.isfinite(img).all()) and mean > 0.0):
        raise AssertionError(f"image not finite with nonzero mean ({mean})")
    if back.shape != tuple(img.shape):
        raise AssertionError("EXR round trip changed the shape")
    log(f"image {tuple(img.shape)} finite, mean {mean:.6f}; EXR written")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    return counts


SIZES = {"camera_rays": 65536, "shadow_rays": 131072, "soup_tris": 40000,
         "soup_rays": 65536, "reps": 20}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from nart_tpu_torch import cuda_build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    cuda_build.load("cluster_hit")
    log(f"build: {SOURCE} in {time.perf_counter() - t0:.2f} s")

    records = kernel_checks("cuda", SIZES)
    golden_check("cuda", (96, 96, 8))
    counts = main_path("cuda", {"spp": 16})

    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=counts[k], **records[k])
               for k in ("closest_hit", "any_hit")]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

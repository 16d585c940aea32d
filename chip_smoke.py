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
     closest-hit validity exactly.  The two counter kernels' five counters
     must equal their plain versions' on every ray, the closest-hit walk's
     t the closest-hit kernel's and the any-hit walk's occlusion the
     any-hit kernel's.  Median times of kernel and plain version (CUDA
     events, after warm-up), and each kernel's bound from its own walk's
     counters on the very rays that were timed (see bound);
  4. golden parity: macbeth at 96x96, 8 spp, through the kernels, against
     tests/golden/macbeth_96x96_8spp.exr (read with the port's PIZ
     reader) with test_macbeth_golden's criteria;
  5. forward main path: render_scene_file on macbeth.json at its own
     1280x720 with spp cut from 256 to 8 (to fit the smoke's time): one
     warm run, one timed run with launch counters reset just before it;
     EXR written to a temporary directory and checked finite with a nonzero
     mean; then the counter tool's entry point (kernel_stats.main) on the
     same scene (both walks), its launches counted the same way;
  6. training path at full width: radiance_weighted_loss_and_grad on
     macbeth 1280x720, one chunk of 4 spp, cot = 1 on RGB: one warm and
     one timed run.  The loss must equal the forward work queue's
     sum(la[..., :3]) (rtol 1e-4), every gradient leaf must be finite, the
     albedo, texture and env-map gradients nonzero, and the closest-hit
     and any-hit kernels launched exactly `rounds` times each: the
     backward pass launches none.  Then the forward queue once more under
     torch.profiler: the card's busy share;
  7. gradients through the kernels against the same call on the CPU
     (plain versions), simple_scene at 32x32, 2 spp: every leaf to rtol
     1e-3 / atol 1e-5 (float32 sums in another order, atomics in the
     gathers' backward), and one central finite difference to 5%;
  8. the "spp" and "regen" modes through the kernels: macbeth at 128x72,
     2 spp; the "regen" film equals the "spp" film (rtol 1e-5 / atol
     1e-6), both image means within 3% of the "balanced" image's;
  9. volume golden: tests/golden/volume_blob.json at its own 96x96, 32 spp
     against volume_blob_96x96_32spp.exr with test_volume_golden's
     criteria (mean rel < 0.02, >= 95% of 16x16 blocks within 0.05).  The
     scene file names blob.vol by an absolute path and a missing volume
     only warns, so the phases render a copy that names this checkout's
     and assert that the medium was loaded;
 10. volume forward at full width: volume_blob at 1280x720 with spp cut
     from 32 to 8: one warm run, one timed run (rounds, segment starts,
     Mrays/s, peak memory), EXR finite with a nonzero mean, no traversal
     kernel launched; the card's busy share under torch.profiler over a
     window of the static machine's rounds;
 11. volume fwd+bwd at full width: radiance_weighted_loss_and_grad on
     volume_blob 1280x720, one chunk of 4 spp, cot = 1 on RGB: the loss
     equals the forward's sum(la[..., :3]) (rtol 1e-4), the medium's
     gradients are finite and nonzero, no traversal kernel launched; the
     busy share over a window of the replay's backward rounds;
 12. volume gradients on the card against the CPU: medium_scene at 32x32,
     2 spp: every leaf to rtol 1e-3 / atol 1e-5;
 13. (a) sharding in one process: macbeth at 1280x720, 2 spp, the virtual
     ranks of Layout(4, 1) and Layout(2, 2) (sharding.render_shard) summed
     against the one-process film (atol/rtol 1e-6), each rank's seconds and
     rounds and the rounds' balance over the row ranks logged; macbeth
     "regen" at 320x180, 2 spp, Layout(2, 2), the same check, and a second
     run of its shards bit-equal to the first; volume_blob at 1280x720,
     2 spp, Layout(4, 1), the same check;
 14. (b) two ranks sharing the card under gloo (NCCL refuses two ranks on
     one GPU), spawned as `chip_smoke.py --rank R PORT DIR`:
     render_sharded of macbeth at 2 spp against phase 13's one-process film
     (1e-6), radiance_weighted_loss_and_grad_sharded of one 1-spp chunk at
     1280x720 against the one-process call (loss rtol 1e-5, gradient rtol
     1e-3 / atol 1e-5);
 15. (c) the CLI as a world of one under NCCL (--coordinator
     127.0.0.1:PORT --numProcesses 1 --processId 0 -s 2 --timing) on
     macbeth: its EXR equals RenderSession.write_exr's bit for bit; its
     --timing lines are logged;
 16. (d) checkpoint and resume: macbeth 1280x720, 4 spp "balanced",
     checkpoint_every=2, resumed in a new session from the first save, and
     "regen" at 128x72, 2 spp, every 1: the films equal the uninterrupted
     ones bit for bit; save and load seconds and the file size logged;
 17. (e) accel="bvh" (the plain lockstep LBVH walk) against the cluster
     kernels: macbeth at 128x72, 1 spp, the images by test_golden's
     _compare criteria (tight and golden), the wall times side by side;
 18. the bench as a user runs it: `python -m nart_tpu_torch.bench` in a
     subprocess at NART_BENCH_SIZE=128, NART_BENCH_SPP=4, once in each
     mode (fwd, fwdbwd): its last line parses with the five keys and a
     finite positive value; the launches it reports (its "# ... launches"
     lines, over its timed runs) are the kernels' launches_bench;
 19. the cornell golden through the kernels (tests/golden/cornell.json with
     tests/fixtures/macbeth's meshes): 64x64, 8 spp, 6 bounces against
     cornell_64x64_8spp.exr with test_cornell_golden's criteria (mean rel
     < 0.02, >= 90% of blocks within 0.1), and 128x128, 64 spp against
     cornell_128x128_64spp.exr with the _64spp criteria (0.015, 0.05,
     95%);
 20. no stream synchronisation inside a path round: path.trace_balanced,
     after a warm call, under torch.cuda.set_sync_debug_mode("warn") with
     warnings "always", on macbeth (1280x720, 1 spp; an environment light)
     and on testing.distant_scene (128x128, 1 spp; a disk and a distant
     light): from the first round on, exactly rounds + 1 synchronising
     calls, each on the loop's alive.any() or its final int(rays); the
     set-up's are logged.
The line before the last is the kernels' JSON record (launches_sharded:
phases 13-15, launches_bench: phase 18); the last line is {"ok": true,
"device": {...}}.  Needs the repository checkout (it imports nart_tpu_torch
from beside this file); imports nothing of JAX.
"""

import json
import math
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
VOLUME = os.path.join(HERE, "tests", "golden", "volume_blob.json")
VOLUME_GOLDEN = os.path.join(HERE, "tests", "golden",
                             "volume_blob_96x96_32spp.exr")
CORNELL = os.path.join(HERE, "tests", "golden", "cornell.json")
SOURCE = "nart_tpu_torch/csrc/cluster_hit.cu"
DEVICE = "cuda"  # every phase runs on the card
REPLACES = {"closest_hit": "nart_tpu/pallas_accel.py:605",  # _kernel
            "any_hit": "nart_tpu/pallas_accel.py:773",  # _kernel_any
            "closest_hit_stats": "tools/kernel_stats.py:27",  # _kernel_stats
            # the same counters, on _kernel_any's walk
            "any_hit_stats": "tools/kernel_stats.py:27"}
KERNELS = tuple(REPLACES)
TRI_AGREE = 0.9999
RTOL, ATOL = 1e-4, 1e-5
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
# tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# float operations of cluster_hit.cu, counted from the source: slab() does
# 6 subtractions, 6 multiplies, 12 min/max and 1 compare; tri_test() does
# 76 when it runs to the end: 60 for the edge functions (21 to translate
# and shear the corners, 9 for each of the three, 12 for the sign and zero
# checks), 14 for the plane equation and the t-window (two 3-term dot
# products, one subtraction, one division, two compares), 2 for esum.  The
# bound charges a triangle the 14: the least that rejects it, whichever
# part a kernel runs first (cluster_hit.cu runs the edge functions first)
SLAB_OPS, TRI_OPS_MIN, TRI_OPS_FULL = 25, 14, 76


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


def compare_stats(name, acc, rays, hit_kernel, any_hit=False):
    """Counter kernel vs plain on `rays`, for the closest-hit walk
    (hit_kernel: the closest-hit kernel's Hit) or the any-hit walk
    (hit_kernel: the any-hit kernel's occlusion): returns (the kernel's
    stats, max abs err of its t or occlusion)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, kernel_stats

    sk = kernel_stats.traversal_stats(*rays, acc, any_hit=any_hit)
    plain = ca.any_hit_stats_plain if any_hit else ca.closest_hit_stats_plain
    sp = plain(*rays, acc)
    # `together` too: it is the size of the group that tested the cluster,
    # which follows from the walk alone
    for k in ("visited", "slabs", "tested", "together", "sc_tests"):
        bad = int((getattr(sk, k) != getattr(sp, k)).sum())
        if bad:
            raise AssertionError(f"{name}: counter {k} differs on {bad} rays")
    if any_hit:
        if not torch.equal(sk.occluded, hit_kernel):
            raise AssertionError(f"{name}: stats occlusion != any-hit kernel's")
        agree = float((sk.occluded == sp.occluded).float().mean())
        if agree < TRI_AGREE:
            raise AssertionError(f"{name}: occlusion vs plain {agree:.6f}")
        err = float((sk.occluded != sp.occluded).any())
    else:
        if not torch.equal(sk.t, hit_kernel.t):
            raise AssertionError(f"{name}: stats t != closest-hit kernel's t")
        both = torch.isfinite(sk.t) & torch.isfinite(sp.t)
        if not torch.equal(torch.isfinite(sk.t), torch.isfinite(sp.t)):
            raise AssertionError(f"{name}: stats hit set differs from plain")
        err = (float((sk.t[both] - sp.t[both]).abs().max()) if both.any()
               else 0.0)
        if err > ATOL:
            raise AssertionError(f"{name}: stats t off by {err}")
    s = kernel_stats.summarize(sk)
    log(f"    counters {name}: supercluster tests {s['sc_tests']:.3f}, "
        f"visited {s['visited_sc']:.3f}, slab tests "
        f"{s['slab_tests']:.3f}, clusters tested {s['tri_tests']:.3f} per "
        f"ray; rays together on a cluster {s['lanes_per_test']:.2f}/32; all "
        "five counters equal plain on every ray")
    return sk, err


def bound(acc, n_rays, out_bytes_per_ray, stats):
    """Least time the card could take (ms) and what sets it.

    Bytes: each ray read once (o, d, t_min, t_max: 32 B), each output
    written once, the accel arrays once.  Operations: the counters of the
    kernel's own walk on these very rays (`stats`; a ray that never joins
    the walk counts nothing) times the arithmetic of one slab test and of
    the least part of a triangle test that can reject a triangle
    (TRI_OPS_MIN; the kernel's own order pays 60 before it rejects, and a
    hit costs TRI_OPS_FULL, neither of which is counted, so the bound errs
    low).  Slab tests: the supercluster tests the ray made (an
    any-hit ray makes none behind the supercluster that occludes it), and
    the member tests where sc_size > 1 (where it is 1 a member's box is its
    supercluster's and the kernel tests it once).  Triangles: every row of
    each cluster the ray tested; but of the cluster that occludes an
    any-hit ray only the row that does: the query may stop at its first
    hit, whichever row it meets first."""
    accel_bytes = sum(x.numel() * x.element_size() for x in
                      (acc.planes, acc.aabb, acc.sc_aabb, acc.morder,
                       acc.order))
    nbytes = n_rays * (32 + out_bytes_per_ray) + accel_bytes
    slabs = int(stats.sc_tests.sum())
    if acc.sc_size > 1:
        slabs += int(stats.slabs.sum())
    ended = int(stats.occluded.sum()) if hasattr(stats, "occluded") else 0
    tris = (int(stats.tested.sum()) - ended) * acc.csize + ended
    ops = SLAB_OPS * slabs + TRI_OPS_MIN * tris
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def kernel_checks(device, sizes):
    """Phase 3.  Returns the per-kernel records at the main-path shapes
    (the macbeth rays)."""
    import torch

    from nart_tpu_torch import (camera, cluster_accel as ca, kernel_stats,
                                scene)

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
    st_cam, err_s = compare_stats("camera rays", acc, cam, hk)

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
    _, err_s2 = compare_stats("secondary rays", acc, sh, hk2)
    _, err_a1 = compare_stats(
        "camera rays, any-hit walk", acc, cam,
        ca.intersect_clusters_any(*cam, acc), any_hit=True)
    st_any, err_a2 = compare_stats("secondary rays, any-hit walk", acc, sh,
                                   occ_k, any_hit=True)

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
    _, err_sb = compare_stats("soup", acc_b, rb, hkb)
    _, err_ab = compare_stats("soup, any-hit walk", acc_b, rb, occb,
                              any_hit=True)

    # times at the main-path shapes
    reps = sizes["reps"]
    t_k1 = cuda_ms(lambda: ca.intersect_clusters(*cam, acc), reps)
    t_p1 = cuda_ms(lambda: ca.closest_hit_plain(*cam, acc), max(3, reps // 4))
    t_k2 = cuda_ms(lambda: ca.intersect_clusters_any(*sh, acc), reps)
    t_p2 = cuda_ms(lambda: ca.any_hit_plain(*sh, acc), max(3, reps // 4))
    t_kb = cuda_ms(lambda: ca.intersect_clusters(*rb, acc_b), reps)
    t_pb = cuda_ms(lambda: ca.closest_hit_plain(*rb, acc_b), 3, warmup=1)
    t_k3 = cuda_ms(lambda: kernel_stats.traversal_stats(*cam, acc), reps)
    t_p3 = cuda_ms(lambda: ca.closest_hit_stats_plain(*cam, acc), 3, warmup=1)
    t_k4 = cuda_ms(lambda: kernel_stats.traversal_stats(*sh, acc, any_hit=True),
                   reps)
    t_p4 = cuda_ms(lambda: ca.any_hit_stats_plain(*sh, acc), 3, warmup=1)
    # the closest-hit kernel once more, after the counter kernel ran: the
    # template must not have changed it
    t_k1b = cuda_ms(lambda: ca.intersect_clusters(*cam, acc), reps)
    log(f"time closest-hit {n} camera rays: kernel {t_k1:.4f} ms, plain "
        f"{t_p1:.4f} ms")
    log(f"time any-hit {m} secondary rays: kernel {t_k2:.4f} ms, plain "
        f"{t_p2:.4f} ms")
    log(f"time closest-hit soup {nb} rays: kernel {t_kb:.4f} ms, plain "
        f"{t_pb:.4f} ms")
    log(f"time counter kernel {n} camera rays: kernel {t_k3:.4f} ms, plain "
        f"{t_p3:.4f} ms; closest-hit again {t_k1b:.4f} ms")
    log(f"time any-hit counter kernel {m} secondary rays: kernel {t_k4:.4f} "
        f"ms, plain {t_p4:.4f} ms")
    records = {
        "closest_hit": dict(max_abs_err=max(err_c, err_c2), ms=t_k1,
                            plain_ms=t_p1, **bound(acc, n, 20, st_cam)),
        "any_hit": dict(max_abs_err=err_a, ms=t_k2, plain_ms=t_p2,
                        **bound(acc, m, 1, st_any)),
        "closest_hit_stats": dict(max_abs_err=max(err_s, err_s2, err_sb),
                                  ms=t_k3, plain_ms=t_p3,
                                  **bound(acc, n, 24, st_cam)),
        "any_hit_stats": dict(max_abs_err=max(err_a1, err_a2, err_ab),
                              ms=t_k4, plain_ms=t_p4,
                              **bound(acc, m, 21, st_any)),
    }
    for k, r in records.items():
        r["library_ms"] = None  # no PyTorch call intersects rays with a scene
        log(f"bound {k}: {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes; {r['operations']} operations): the kernel "
            "reaches "
            f"{100.0 * r['bound_ms'] / r['ms']:.3f}% of it")
    return records


def block_compare(ours, ref, mean_tol, block_tol, block_frac,
                  label="golden"):
    """tests/test_golden.py _compare: image mean and 16x16 block means."""
    r, o = ref[..., :3], ours[..., :3]
    mean_rel = abs(o.mean() - r.mean()) / max(r.mean(), 1e-6)
    h, w = r.shape[:2]
    rb = r[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    ob = o[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    rel = np.abs(ob.mean((1, 3, 4)) - rb.mean((1, 3, 4))) / np.maximum(
        rb.mean((1, 3, 4)), 0.05)
    frac = float((rel < block_tol).mean())
    log(f"{label}: mean rel {mean_rel:.5f} (< {mean_tol}), blocks within "
        f"{block_tol}: {frac:.3f} (>= {block_frac}), worst {rel.max():.4f}")
    if not (mean_rel < mean_tol and frac >= block_frac):
        raise AssertionError(f"{label} comparison failed")


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
    if min(grew["closest_hit"], grew["any_hit"]) <= 0:
        raise AssertionError(f"kernels not launched by the render: {grew}")
    ref = exr.read(GOLDEN)
    if ref.shape != ours.shape:
        raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
    block_compare(ours, ref, 0.03, 0.12, 0.95)


def main_path(overrides):
    """Phase 5: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, exr, film, render

    params, sess = next(render.render_scene_file(MACBETH, overrides))
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
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    return counts


def stats_path():
    """Phase 5, the counter tool's entry point on the card: returns its
    launch counts."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, kernel_stats

    ca.reset_launch_counts()
    out = kernel_stats.main([MACBETH, "--asset-root", MACBETH_DIR])
    torch.cuda.synchronize()
    counts = dict(ca.launch_counts)
    if min(counts["closest_hit_stats"], counts["any_hit_stats"]) <= 0:
        raise AssertionError(f"a counter kernel was not launched: {counts}")
    for label, s in out.items():
        if not (0 < s["tri_tests"] <= s["slab_tests"]
                and 1.0 <= s["lanes_per_test"] <= 32.0):
            raise AssertionError(f"kernel_stats {label}: {s}")
    return counts


def _image_samples(params, device):
    """The session's Latin-square image samples: (spp, W*H, 2)."""
    from nart_tpu_torch import render

    w, h = params.image_width, params.image_height
    return render.image_samples(
        w, h, w + 2 * int(np.ceil(params.filter_width)), params.spp, device)


def _rgb_cot(samples):
    import torch

    cot = torch.ones(samples.shape[:2] + (4,), device=samples.device)
    cot[..., 3] = 0.0
    return cot


def _leaves(theta):
    """[(name, tensor)] of a parameter dict, the medium's dict included."""
    out = []
    for k in sorted(theta):
        if isinstance(theta[k], dict):
            out += [(f"{k}.{s}", v) for s, v in sorted(theta[k].items())]
            continue
        vals = theta[k] if isinstance(theta[k], list) else [theta[k]]
        out += [(f"{k}[{i}]", v) for i, v in enumerate(vals) if v is not None]
    return out


def device_busy(label, fn, wall_s, top=5):
    """Run fn once under torch.profiler (the card's activity only) and log
    the card's busy time -- the sum of its kernels' and copies' device time
    -- as a share of wall_s, the wall time of the same call untraced; the
    host dispatching the round's small operations takes the rest.  Returns
    the number of kernels and copies."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not busy_ms > 0.0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    log(f"device busy, {label}: {busy_ms:.3f} ms in "
        f"{sum(e.count for e in events)} kernels and copies = "
        f"{100.0 * busy_ms / (1e3 * wall_s):.2f}% of the untraced "
        f"{wall_s:.4f} s")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # the heaviest, and the traversal kernels wherever they rank
    for e in events[:top] + [e for e in events[top:]
                             if "walk_kernel" in e.key]:
        log(f"    {e.key[:60]:60s} {e.self_device_time_total / 1e3:10.3f} ms"
            f" x{e.count}")
    return sum(e.count for e in events)


def training_path(spp):
    """Phase 6: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, grad, render, scene
    from nart_tpu_torch.integrators import path

    # the camera's placeholder medium is a trainable leaf the path
    # integrator never reads: its gradient is zero
    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.load_sessions(MACBETH, {"spp": spp})[0]
    w, h = params.image_width, params.image_height
    acc = ca.build_accel(sc.tri_v.numpy(), params.accel)
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    log(f"training path: macbeth.json {w}x{h}, one chunk of {spp} spp, "
        "cot = 1 on RGB")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grad.radiance_weighted_loss_and_grad(
            sc, theta, acc, samples, cot, params, w, h)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, dt = run()
    log(f"warm run {dt:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    (loss, grads, rays, rounds), dt = run()
    counts = dict(ca.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"timed run fwd+bwd {dt:.4f} s, {rounds} rounds, {rays} rays "
        f"(one forward's, algorithmic), {rays / dt / 1e6:.4f} Mrays/s "
        f"fwd+bwd, launches {counts}, peak device memory {peak:.1f} MiB")
    if not (counts["closest_hit"] == counts["any_hit"] == rounds):
        raise AssertionError(
            f"launches {counts} != rounds {rounds}: the backward pass must "
            "launch no traversal kernel")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    la, rays_f, rounds_f = path.trace_balanced(
        sc.to(DEVICE), acc.to(DEVICE), samples, params, w, h)
    want = float(la[..., :3].sum())
    torch.cuda.synchronize()
    dt_f = time.perf_counter() - t0
    log(f"forward work queue alone {dt_f:.4f} s ({rounds_f} rounds): "
        f"fwd+bwd / fwd = {dt / dt_f:.3f}; loss {float(loss):.6f} vs "
        f"sum(la rgb) {want:.6f}")
    if not (np.isfinite(float(loss))
            and abs(float(loss) - want) <= 1e-4 * abs(want)):
        raise AssertionError(f"loss {float(loss)} != forward sum {want}")
    if (rays_f, rounds_f) != (rays, rounds):
        raise AssertionError("replay and forward disagree on rays or rounds")
    device_busy("forward work queue", lambda: path.trace_balanced(
        sc.to(DEVICE), acc.to(DEVICE), samples, params, w, h), dt_f)
    for k, g in _leaves(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient leaf {k} is not finite")
    sums = {k: float(g.abs().sum()) for k, g in _leaves(grads)}
    log("gradient |sum| per leaf: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sums.items()))
    env = [k for k, v in _leaves(theta) if k.startswith("light_le_tex")]
    for k in ["rho_d_const[0]", "tex_data[0]"] + env:
        if not sums[k] > 0.0:
            raise AssertionError(f"gradient leaf {k} is all zero")
    if not env:
        raise AssertionError("macbeth has no env-map texture leaf")
    return counts


def card_against_cpu():
    """Phase 7."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, grad, render, testing
    from nart_tpu_torch.integrators import path

    sc = testing.simple_scene(("lambert",))
    params = render.RenderParams(image_width=32, image_height=32, spp=2)
    acc = ca.build_clusters(sc.tri_v.numpy())
    samples = _image_samples(params, "cpu")
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    # 256 work slots for 2,048 items: a dozen rounds with respawns
    args = (sc, theta, acc, samples, cot, params, 32, 32, 0, 256)
    before = dict(ca.launch_counts)
    loss_k, grads_k, rays_k, rounds_k = grad.radiance_weighted_loss_and_grad(
        *args)
    if ca.launch_counts["closest_hit"] - before["closest_hit"] != rounds_k:
        raise AssertionError("the card's gradient did not go through the "
                             "closest-hit kernel once per round")
    loss_c, grads_c, rays_c, rounds_c = grad.radiance_weighted_loss_and_grad(
        *args, device="cpu")
    if (rays_k, rounds_k) != (rays_c, rounds_c):
        raise AssertionError("card and CPU traced different paths")
    worst = 0.0
    for (k, gk), (_, gc) in zip(_leaves(grads_k), _leaves(grads_c)):
        gk = gk.cpu()
        if not torch.allclose(gk, gc, rtol=1e-3, atol=1e-5):
            raise AssertionError(
                f"gradient leaf {k}: card {gk.flatten()[:4]} vs CPU "
                f"{gc.flatten()[:4]}")
        worst = max(worst, float((gk - gc).abs().max()))

    def fwd(delta):
        rho = theta["rho_d_const"].clone()
        rho[0, 0] += delta
        scn = grad.put_params(sc, dict(theta, rho_d_const=rho)).to(DEVICE)
        la, _, _ = path.trace_balanced(scn, acc.to(DEVICE),
                                       samples.to(DEVICE), params, 32, 32,
                                       n_lanes=256)
        return float(la[..., :3].double().sum())

    eps = 1e-2
    g_fd = (fwd(eps) - fwd(-eps)) / (2 * eps)
    g_ad = float(grads_k["rho_d_const"][0, 0])
    log(f"card vs CPU gradients: loss {float(loss_k):.6f} vs "
        f"{float(loss_c):.6f}, {rounds_k} rounds, every leaf within rtol "
        f"1e-3 / atol 1e-5 (max abs diff {worst:.3g}); d/d rho_d[0,0]: "
        f"replay {g_ad:.6f}, finite difference {g_fd:.6f}")
    if not abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), 1e-3):
        raise AssertionError(f"replay {g_ad} vs finite difference {g_fd}")


def modes_path(size):
    """Phase 8: returns the K1/K2 launches of the "spp" and "regen" runs."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, film, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    w, h, spp = size
    films, means, counts = {}, {}, {}
    for mode in ("balanced", "spp", "regen"):
        params = render.resolve_params(
            {}, dict(image_width=w, image_height=h, spp=spp, wavefront=mode))
        sess = render.RenderSession(sc, params, DEVICE)
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        films[mode] = sess.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[mode] = {k: ca.launch_counts[k] for k in KERNELS[:2]}
        img = film.finalize(films[mode], w, h, sess.filter_bounds)
        means[mode] = float(img[..., :3].mean())
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{mode}: the image is not finite")
        log(f"mode {mode}: macbeth {w}x{h} {spp} spp in {dt:.3f} s, "
            f"{sess.stats}, image mean {means[mode]:.6f}, launches "
            f"{counts[mode]}")
        if min(counts[mode].values()) <= 0:
            raise AssertionError(f"{mode}: K1 and K2 not both launched")
    if not torch.allclose(films["regen"], films["spp"], rtol=1e-5,
                          atol=1e-6):
        worst = float((films["regen"] - films["spp"]).abs().max())
        raise AssertionError(f"regen film != spp film (max diff {worst})")
    log("regen film == spp film within rtol 1e-5 / atol 1e-6 (bit-equal: "
        f"{bool(torch.equal(films['regen'], films['spp']))})")
    for mode in ("spp", "regen"):
        rel = abs(means[mode] - means["balanced"]) / means["balanced"]
        if not rel < 0.03:
            raise AssertionError(f"{mode} mean {means[mode]} vs balanced "
                                 f"{means['balanced']}: {rel:.4f} apart")
    return {k: counts["spp"][k] + counts["regen"][k] for k in KERNELS[:2]}


def volume_session(overrides=None):
    """volume_blob.json's session, its blob.vol read from this checkout
    (bench_configs.load_scene_doc)."""
    from nart_tpu_torch import render
    from nart_tpu_torch.bench_configs import load_scene_doc

    scene = load_scene_doc(VOLUME, os.path.dirname(VOLUME))
    if scene.medium is None:
        raise AssertionError("blob.vol was not loaded: no medium")
    (params,) = render.load_sessions(VOLUME, overrides)
    return params, render.RenderSession(scene, params, DEVICE)


def _no_traversal(label, counts):
    if any(counts.values()):
        raise AssertionError(f"{label} launched a traversal kernel: {counts}")


def volume_golden():
    """Phase 9."""
    from nart_tpu_torch import cluster_accel as ca, exr

    params, sess = volume_session()
    ca.reset_launch_counts()
    ours = sess.image().cpu().numpy()
    _no_traversal("the volume golden", ca.launch_counts)
    log(f"volume golden render {params.image_width}x{params.image_height} "
        f"{params.spp} spp: {sess.stats}")
    ref = exr.read(VOLUME_GOLDEN)
    if ref.shape != ours.shape:
        raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
    block_compare(ours, ref, 0.02, 0.05, 0.95, label="volume golden")


def window_busy(label, run, count):
    """device_busy over a window of `count` rounds: run() re-runs them from
    a kept carry, once untraced and once under the profiler.  Profiling a
    whole volume run (hundreds of thousands of small kernels) takes
    minutes; the window's rounds are the same work as the others'."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = device_busy(label, run, wall)
    log(f"    {kernels / count:.0f} kernels and copies a round, "
        f"{1e3 * wall / count:.3f} ms a round untraced")


def volume_forward(spp, window):
    """Phase 10: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, exr, film, render
    from nart_tpu_torch.integrators import volume

    params, sess = volume_session(
        {"image_width": 1280, "image_height": 720, "spp": spp})
    log(f"volume forward: volume_blob.json {params.image_width}x"
        f"{params.image_height} at {params.spp} spp (the scene's own session "
        f"has 32 spp; cut to {params.spp} for the smoke's time)")
    t0 = time.perf_counter()
    sess.render()
    torch.cuda.synchronize()
    log(f"warm run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    buf = sess.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ca.launch_counts)
    rays, rounds = sess.stats["rays"], sess.stats["rounds"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"timed run {dt:.4f} s, {rounds} rounds "
        f"({1e3 * dt / rounds:.3f} ms a round), {rays} segment starts, "
        f"{rays / dt / 1e6:.4f} Mrays/s, peak device memory {peak:.1f} MiB, "
        f"launches {counts}")
    _no_traversal("the volume forward", counts)
    img = film.finalize(buf, params.image_width, params.image_height,
                        sess.filter_bounds)
    with tempfile.TemporaryDirectory() as tmp:
        back = exr.read(sess.write_exr(os.path.join(tmp, "blob"), img=img))
    mean = float(img[..., :3].mean())
    if not (bool(torch.isfinite(img).all()) and mean > 0.0
            and back.shape == tuple(img.shape)):
        raise AssertionError(f"volume image not finite with nonzero mean "
                             f"({mean}) or its EXR changed shape")
    log(f"image {tuple(img.shape)} finite, mean {mean:.6f}; EXR written")

    samples = render.image_samples(sess.render_w, sess.render_h,
                                   sess.total_w, params.spp, DEVICE)
    core, step_round, n = volume._static_machine(
        sess.scene, samples, params, sess.render_w, 0, params.lanes)
    items = samples.shape[0] * samples.shape[1]
    log(f"static machine: {n} lanes, {-(-items // n)} items a lane")
    first, count = window
    for _ in range(first):
        core = step_round(core)[0]

    def run():
        c = core
        for _ in range(count):
            if not bool(c[0].alive.any()):
                break
            c = step_round(c)[0]

    window_busy(f"volume forward, rounds {first}-{first + count - 1}", run,
                count)
    return counts


def volume_training(spp, window):
    """Phase 11: returns the launch counts of the timed fwd+bwd run."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, grad, render
    from nart_tpu_torch.integrators import volume

    params, sess = volume_session(
        {"image_width": 1280, "image_height": 720, "spp": spp})
    w, h = params.image_width, params.image_height
    sc = sess.scene
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    log(f"volume training path: volume_blob.json {w}x{h}, one chunk of {spp}"
        " spp, cot = 1 on RGB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    la, rays_f, rounds_f = volume.trace_vol_static(sc, None, samples, params,
                                                   w, h)
    want = float(la[..., :3].double().sum() + cot[..., 3].double().sum())
    torch.cuda.synchronize()
    dt_f = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, rays, rounds = grad.radiance_weighted_loss_and_grad(
        sc, theta, None, samples, cot, params, w, h)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(ca.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"forward alone {dt_f:.4f} s ({rounds_f} rounds); fwd+bwd "
        f"{dt:.4f} s, {rounds} rounds, {rays} segment starts (one "
        f"forward's), {rays / dt / 1e6:.4f} Mrays/s fwd+bwd, fwd+bwd / fwd "
        f"= {dt / dt_f:.3f}, peak device memory {peak:.1f} MiB, launches "
        f"{counts}; loss {float(loss):.6f} vs forward {want:.6f}")
    _no_traversal("the volume fwd+bwd", counts)
    if not (np.isfinite(float(loss))
            and abs(float(loss) - want) <= 1e-4 * abs(want)):
        raise AssertionError(f"loss {float(loss)} != forward sum {want}")
    if (rays, rounds) != (rays_f, rounds_f):
        raise AssertionError("replay and forward disagree on rays or rounds")
    for k, g in _leaves(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient leaf {k} is not finite")
    med = {k: float(g.abs().sum()) for k, g in _leaves(grads)
           if k.startswith("medium.")}
    log("medium gradient |sum|: " + ", ".join(
        f"{k} {v:.6g}" for k, v in med.items()))
    if len(med) != 4 or not all(v > 0.0 for v in med.values()):
        raise AssertionError(f"a medium gradient is missing or zero: {med}")

    # the busy share over a window of the replay's backward rounds
    leaves = grad._as_leaves(theta, DEVICE)
    replay = volume._VolReplay(volume._static_machine,
                               grad.put_params(sc, leaves), samples, cot,
                               params, w, 0, params.lanes)
    replay.forward()
    saved = replay.saved
    g = torch.ones((), device=DEVICE)
    first, count = window

    def run():
        # the backward pass walks the window's rounds, last to first
        replay.saved = saved[first:first + count]
        replay.backward(g)

    window_busy(f"volume replay backward, rounds {first}-{first + count - 1}",
                run, count)
    return counts


def volume_card_against_cpu(size):
    """Phase 12."""
    import torch

    from nart_tpu_torch import grad, render, testing

    w, h, spp = size
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
    params = render.RenderParams(image_width=w, image_height=h, spp=spp,
                                 bounces=16, integrator="volume")
    samples = _image_samples(params, "cpu")
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    # 256 work slots for 2,048 items: rounds with respawns
    args = (sc, theta, None, samples, cot, params, w, h, 0, 256)
    loss_k, grads_k, rays_k, rounds_k = grad.radiance_weighted_loss_and_grad(
        *args)
    loss_c, grads_c, rays_c, rounds_c = grad.radiance_weighted_loss_and_grad(
        *args, device="cpu")
    worst = 0.0
    for (k, gk), (_, gc) in zip(_leaves(grads_k), _leaves(grads_c)):
        gk = gk.cpu()
        if not torch.allclose(gk, gc, rtol=1e-3, atol=1e-5):
            raise AssertionError(
                f"volume gradient leaf {k}: card {gk.flatten()[:4]} vs CPU "
                f"{gc.flatten()[:4]}")
        worst = max(worst, float((gk - gc).abs().max()))
    log(f"volume card vs CPU gradients: loss {float(loss_k):.6f} vs "
        f"{float(loss_c):.6f}, rounds {rounds_k} / {rounds_c}, segment "
        f"starts {rays_k} / {rays_c}, every leaf within rtol 1e-3 / atol "
        f"1e-5 (max abs diff {worst:.3g}); d/d sigma_a "
        f"{float(grads_k['medium']['sigma_a']):.6f}")


def _shard_rounds(label, stats, layout):
    """Log the per-rank rounds of a layout and the balance over its row
    ranks (a row rank's rounds summed over its sample slabs): mean / max
    (the JAX package's measure) and max / mean."""
    per_row = [sum(stats[r * layout.n_spp + j]["rounds"]
                   for j in range(layout.n_spp)) for r in range(layout.n_row)]
    mean = statistics.mean(per_row)
    log(f"    {label}: rounds per rank {[st['rounds'] for st in stats]}; "
        f"row ranks {per_row}: balance mean/max {mean / max(per_row):.4f}, "
        f"max/mean {max(per_row) / mean:.4f}")


def _close_films(label, got, want):
    import torch

    if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
        bad = ~torch.isclose(got, want, rtol=1e-6, atol=1e-6)
        raise AssertionError(f"{label}: {int(bad.sum())} film values off, "
                             f"max diff {float((got - want).abs().max())}")
    log(f"    {label}: equal to the one-process film within atol/rtol 1e-6 "
        f"(max diff {float((got - want).abs().max()):.3g}, bit-equal "
        f"{bool(torch.equal(got, want))})")


def _virtual_ranks(sess, layout, label):
    """Every rank of a layout in turn (render_shard), the films summed:
    returns (film, per-rank stats)."""
    import torch

    from nart_tpu_torch import sharding

    film = torch.zeros((sess.total_h, sess.total_w, 5), device=DEVICE)
    stats = []
    for r in range(layout.world_size):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, st = sharding.render_shard(sess, layout, r)
        torch.cuda.synchronize()
        st["seconds"] = time.perf_counter() - t0
        film += f
        stats.append(st)
    log(f"    {label}: seconds per rank "
        f"{[round(st['seconds'], 3) for st in stats]}")
    if any(st["rounds"] for st in stats):  # "spp"/"regen" count no rounds
        _shard_rounds(label, stats, layout)
    return film, stats


def sharded_virtual(spp):
    """Phase 13 (a): returns the launch counts of the sharded renders and
    the one-process macbeth film (phase 14's reference)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, render, sharding

    params, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                                  device=DEVICE))
    t0 = time.perf_counter()
    single = sess.render()
    torch.cuda.synchronize()
    log(f"sharded (virtual ranks, one process): macbeth {params.image_width}"
        f"x{params.image_height} {spp} spp; one process {time.perf_counter() - t0:.3f} s, "
        f"{sess.stats}")
    counts = dict.fromkeys(KERNELS, 0)
    for shape in ((4, 1), (2, 2)):
        layout = sharding.Layout(*shape)
        ca.reset_launch_counts()
        film, _ = _virtual_ranks(sess, layout, f"macbeth {layout}")
        for k in KERNELS:
            counts[k] += ca.launch_counts[k]
        _close_films(f"macbeth {layout}", film, single)
    # "regen" shards: whole rows on the per-pixel streams, Layout(2, 2)
    # counting as four row ranks; the strip splats add at distinct rows, so
    # a second run gives the same bits
    _, sess_r = next(render.render_scene_file(
        MACBETH, {"spp": spp, "image_width": 320, "image_height": 180,
                  "wavefront": "regen"}, device=DEVICE))
    single_r = sess_r.render()
    layout = sharding.Layout(2, 2)
    label = f"macbeth 320x180 regen {layout}"
    ca.reset_launch_counts()
    film_r, _ = _virtual_ranks(sess_r, layout, label)
    for k in KERNELS:
        counts[k] += ca.launch_counts[k]
    _close_films(label, film_r, single_r)
    again = [sharding.render_shard(sess_r, layout, r)[0]
             for r in range(layout.world_size)]
    if not torch.equal(sum(again), film_r):
        raise AssertionError("a second run of the regen shards differs")
    log("    macbeth 320x180 regen: a second run of the shards is bit-equal")
    params_v, sess_v = volume_session({"image_width": 1280,
                                       "image_height": 720, "spp": spp})
    single_v = sess_v.render()
    layout = sharding.Layout(4, 1)
    ca.reset_launch_counts()
    film_v, _ = _virtual_ranks(sess_v, layout, f"volume_blob {layout}")
    _no_traversal("the sharded volume", ca.launch_counts)
    _close_films(f"volume_blob {layout}", film_v, single_v)
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the sharded renders launched {counts}")
    return counts, single


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grad_inputs(spp, device):
    """macbeth at its 1280x720: scene, clusters, params, samples of one
    chunk of spp samples, cot = 1 on RGB, theta."""
    from nart_tpu_torch import cluster_accel as ca, grad, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.load_sessions(MACBETH, {"spp": spp})[0]
    acc = ca.build_accel(sc.tri_v.numpy(), params.accel)
    samples = _image_samples(params, device)
    return sc, acc, params, samples, _rgb_cot(samples), grad.get_params(sc)


def rank_worker(rank, port, out_dir):
    """One of phase 14's two ranks: gloo on the one card (NCCL refuses two
    ranks on one GPU).  The sharded macbeth film (Layout(2, 1), 2 spp) and
    the sharded gradient of one 1-spp chunk; writes rank<r>.npz."""
    import torch

    sys.path.insert(0, HERE)
    from nart_tpu_torch import cluster_accel as ca, grad, render, sharding

    dev = sharding.init_distributed(f"tcp://127.0.0.1:{port}", rank, 2,
                                    backend="gloo", device="cuda:0")
    layout = sharding.Layout(2, 1)
    _, sess = next(render.render_scene_file(MACBETH, {"spp": 2}, device=dev))
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    film, stats = sharding.render_sharded(sess, layout)
    torch.cuda.synchronize()
    t_film = time.perf_counter() - t0
    sc, acc, params, samples, cot, theta = _grad_inputs(1, dev)
    w, h = params.image_width, params.image_height
    t0 = time.perf_counter()
    loss, grads, rays, rounds = sharding.radiance_weighted_loss_and_grad_sharded(
        sc, theta, acc, samples, cot, params, w, h, layout, device=dev)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    flat = torch.cat([g.reshape(-1) for _, g in _leaves(grads)])
    # the two collectives alone, on buffers of the same sizes
    t_reduce = []
    for n in (film.numel(), flat.numel()):
        buf = torch.ones(n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharding.all_reduce_sum(buf)
        torch.cuda.synchronize()
        t_reduce.append(time.perf_counter() - t0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             film=film.cpu().numpy() if rank == 0 else np.zeros(0),
             loss=float(loss), grads=flat.cpu().numpy(),
             counts=np.array([ca.launch_counts[k] for k in KERNELS]),
             rounds=np.array([stats["rounds"], rounds]),
             seconds=np.array([t_film, t_grad] + t_reduce),
             sizes=np.array([film.numel(), flat.numel()]))
    torch.distributed.destroy_process_group()


def two_ranks(single):
    """Phase 14 (b): returns the two ranks' launch counts."""
    import torch

    from nart_tpu_torch import grad

    log("two ranks on the one card under gloo (NCCL refuses two ranks on "
        "one GPU): render_sharded of macbeth at 2 spp and "
        "radiance_weighted_loss_and_grad_sharded of one 1-spp chunk, "
        "Layout(2, 1)")
    sc, acc, params, samples, cot, theta = _grad_inputs(1, DEVICE)
    w, h = params.image_width, params.image_height
    loss1, grads1, _, _ = grad.radiance_weighted_loss_and_grad(
        sc, theta, acc, samples, cot, params, w, h)
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank", str(r), str(port), tmp])
                 for r in range(2)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"the ranks exited with {rcs}")
        out = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(2)]
    for r, o in enumerate(out):
        log(f"    rank {r}: film {o['seconds'][0]:.3f} s ({o['rounds'][0]} "
            f"rounds), gradient {o['seconds'][1]:.3f} s ({o['rounds'][1]} "
            f"rounds), launches {dict(zip(KERNELS, o['counts'].tolist()))}; "
            f"all-reduce under gloo (through host memory) of the film's "
            f"{4 * o['sizes'][0]} bytes {o['seconds'][2]:.4f} s, of the "
            f"gradient's {4 * o['sizes'][1]} bytes {o['seconds'][3]:.4f} s")
    _close_films("two ranks, gloo", torch.from_numpy(out[0]["film"]),
                 single.cpu())
    loss2 = out[0]["loss"]
    if not (out[1]["loss"] == loss2
            and abs(loss2 - float(loss1)) <= 1e-5 * abs(float(loss1))):
        raise AssertionError(f"sharded loss {loss2} / {out[1]['loss']} vs "
                             f"one process {float(loss1)}")
    want = torch.cat([g.reshape(-1) for _, g in _leaves(grads1)]).cpu()
    got = torch.from_numpy(out[0]["grads"])
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-5):
        raise AssertionError("sharded gradient differs from one process's: "
                             f"max diff {float((got - want).abs().max())}")
    log(f"    loss {loss2:.6f} vs one process {float(loss1):.6f} (rtol 1e-5); "
        f"{want.numel()} gradient values within rtol 1e-3 / atol 1e-5 (max "
        f"diff {float((got - want).abs().max()):.3g})")
    counts = {k: int(out[0]["counts"][i] + out[1]["counts"][i])
              for i, k in enumerate(KERNELS)}
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the ranks launched {counts}")
    return counts


def cli_world_of_one(spp):
    """Phase 15 (c): the CLI as a world of one under NCCL, in this process;
    its EXR against RenderSession.write_exr's.  Returns its launch counts."""
    import contextlib
    import io

    from nart_tpu_torch import cli, cluster_accel as ca, exr, render

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli")
        err = io.StringIO()
        ca.reset_launch_counts()
        with contextlib.redirect_stderr(err):
            rc = cli.main([MACBETH, out, "--coordinator",
                           f"127.0.0.1:{_free_port()}", "--numProcesses", "1",
                           "--processId", "0", "-s", str(spp), "--timing"])
        counts = dict(ca.launch_counts)
        for line in err.getvalue().splitlines():
            log(f"    cli {line}")
        if rc != 0:
            raise AssertionError(f"the CLI returned {rc}")
        _, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                                 device=DEVICE))
        want = exr.read(sess.write_exr(os.path.join(tmp, "session")))
        got = exr.read(out + ".exr")
    if not np.array_equal(got, want):
        raise AssertionError("the CLI's EXR differs from write_exr's: max "
                             f"diff {np.abs(got - want).max()}")
    log(f"    the CLI's EXR {got.shape} equals RenderSession.write_exr's bit "
        f"for bit; launches {counts}")
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the CLI launched {counts}")
    return counts


def checkpoint_resume():
    """Phase 16 (d)."""
    import torch

    from nart_tpu_torch import checkpoint, render

    cases = (("balanced", {"spp": 4}, 2),
             ("regen", {"spp": 2, "image_width": 128, "image_height": 72,
                        "wavefront": "regen"}, 1))
    for label, overrides, every in cases:
        params, sess = next(render.render_scene_file(MACBETH, overrides,
                                                      device=DEVICE))
        full = sess.render()
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck.npz")
            # after the render the file holds its first save: no save is
            # made at the last sample
            render.RenderSession(sess.scene, params, DEVICE).render(
                checkpoint_path=ck, checkpoint_every=every)
            t0 = time.perf_counter()
            film, state, done = checkpoint.load(ck, params)
            t_load = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint.save(os.path.join(tmp, "again.npz"), film, state, done,
                            params)
            t_save = time.perf_counter() - t0
            size = os.path.getsize(ck)
            resumed = render.RenderSession(sess.scene, params, DEVICE).render(
                checkpoint_path=ck, resume=True)
        if done != every or not torch.equal(resumed, full):
            raise AssertionError(f"{label}: resumed from {done} spp, film "
                                 "differs from the uninterrupted one")
        log(f"checkpoint {label}: macbeth {params.image_width}x"
            f"{params.image_height} {params.spp} spp, saved at {done}: "
            f"{size} bytes, save {t_save:.3f} s, load {t_load:.3f} s; the "
            "resumed film equals the uninterrupted one bit for bit")


def bvh_accel(size):
    """Phase 17 (e)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, render

    w, h, spp = size
    imgs, secs = {}, {}
    for kind in ("cluster", "bvh"):
        params, sess = next(render.render_scene_file(
            MACBETH, dict(image_width=w, image_height=h, spp=spp,
                          accel=kind), device=DEVICE))
        ca.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sess.image()
        torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
        imgs[kind] = img.cpu().numpy()
        log(f"accel {kind}: macbeth {w}x{h} {spp} spp in {secs[kind]:.3f} s, "
            f"{sess.stats}, launches {dict(ca.launch_counts)}")
        if kind == "bvh":
            _no_traversal("the bvh render", ca.launch_counts)
    if not np.isfinite(imgs["bvh"]).all():
        raise AssertionError("the bvh image is not finite")
    block_compare(imgs["bvh"], imgs["cluster"], 1e-3, 0.01, 0.95,
                  label="bvh vs cluster (tight)")
    block_compare(imgs["bvh"], imgs["cluster"], 0.03, 0.12, 0.95,
                  label="bvh vs cluster (golden)")
    log(f"bvh / cluster wall time {secs['bvh'] / secs['cluster']:.2f}x")


def bench_subprocess(size, spp):
    """Phase 18: `python -m nart_tpu_torch.bench` in each mode; returns the
    launches its timed runs reported, summed over both."""
    counts = dict.fromkeys(KERNELS, 0)
    for mode in ("fwd", "fwdbwd"):
        env = dict(os.environ, NART_BENCH_SIZE=str(size),
                   NART_BENCH_SPP=str(spp), NART_BENCH_MODE=mode)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nart_tpu_torch.bench"], cwd=HERE,
            env=env, capture_output=True, text=True, timeout=600)
        for line in proc.stderr.splitlines():
            log(f"    bench {mode} {line}")
        if proc.returncode:
            raise AssertionError(f"bench {mode} exited {proc.returncode}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"    bench {mode} ({time.perf_counter() - t0:.1f} s with its "
            f"start): {json.dumps(last)}")
        keys = {"metric", "value", "unit", "vs_baseline", "device"}
        if set(last) != keys:
            raise AssertionError(f"bench {mode}: keys {sorted(last)}")
        if not (math.isfinite(last["value"]) and last["value"] > 0.0):
            raise AssertionError(f"bench {mode}: value {last['value']}")
        for line in proc.stderr.splitlines():
            if " launches: " in line:
                grew = json.loads(line.split(" launches: ", 1)[1])
                for k in KERNELS:
                    counts[k] += grew[k]
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the bench launched {counts}")
    return counts


def cornell_golden():
    """Phase 19: returns the launches of the two renders."""
    from nart_tpu_torch import cluster_accel as ca, exr, render, scene

    sc = scene.load_scene(CORNELL, asset_root=MACBETH_DIR)
    counts = dict.fromkeys(KERNELS, 0)
    for (w, h, spp), golden, tols in (
            ((64, 64, 8), "cornell_64x64_8spp.exr", (0.02, 0.1, 0.9)),
            ((128, 128, 64), "cornell_128x128_64spp.exr",
             (0.015, 0.05, 0.95))):
        params = render.resolve_params(
            {}, dict(image_width=w, image_height=h, spp=spp, bounces=6))
        sess = render.RenderSession(sc, params, DEVICE)
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        ours = sess.image().cpu().numpy()
        grew = {k: ca.launch_counts[k] for k in KERNELS}
        log(f"cornell {w}x{h} {spp} spp in {time.perf_counter() - t0:.3f} s: "
            f"{sess.stats}, launches {grew}")
        if min(grew["closest_hit"], grew["any_hit"]) <= 0:
            raise AssertionError(f"kernels not launched by the render: {grew}")
        for k in KERNELS:
            counts[k] += grew[k]
        ref = exr.read(os.path.join(os.path.dirname(CORNELL), golden))
        if ref.shape != ours.shape:
            raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
        block_compare(ours, ref, *tols, label=f"cornell golden {w}x{h} {spp} "
                      "spp")
    return counts


def _sync_checked(label, sess, spp):
    """path.trace_balanced of the session's image, once to warm up and once
    under the sync debug mode.  The loop may synchronise only where it
    reads the host: bool(alive.any()) before each round and after the last,
    and int(rays) at the end.  A wrapper of the machine's step marks where
    the rounds begin, so from there on exactly rounds + 1 synchronising
    calls, on those two lines, are allowed; before it, the machine's set-up
    (once per call) is counted and logged."""
    import inspect
    import warnings

    import torch

    from nart_tpu_torch import render
    from nart_tpu_torch.integrators import path

    p = sess.params
    samples = render.image_samples(sess.render_w, sess.render_h,
                                   sess.total_w, spp, DEVICE)

    def trace():
        return path.trace_balanced(sess.scene, sess.accel, samples, p,
                                   sess.render_w, sess.render_h, 0, p.lanes)

    trace()
    torch.cuda.synchronize()
    src, first = inspect.getsourcelines(path.trace_balanced)
    line_of = {what: first + next(i for i, ln in enumerate(src) if what in ln)
               for what in ("alive.any()", "int(core[0].rays)")}
    real_machine = path._balanced_machine
    started = []

    def machine(*a, **k):
        core, step = real_machine(*a, **k)

        def marked(c):
            if not started:
                started.append(len(caught))
            return step(c)
        return core, marked

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        path._balanced_machine = machine
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, rays, rounds = trace()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            path._balanced_machine = real_machine

    def synced(ws):
        # the mode's own notice that it is a prototype is no synchronisation
        return [w for w in ws
                if "synchronizing CUDA operation" in str(w.message)]

    def where(ws):
        return [(os.path.basename(w.filename), w.lineno) for w in ws]

    before, in_loop = synced(caught[:started[0]]), synced(caught[started[0]:])
    allowed = {("path.py", ln) for ln in line_of.values()}
    strays = [w for w, at in zip(in_loop, where(in_loop)) if at not in allowed]
    for w in strays:
        log(f"    synchronised in the loop: {w.filename}:{w.lineno}: "
            f"{w.message}")
    at = where(before + in_loop)
    n_alive = at.count(("path.py", line_of["alive.any()"]))
    n_rays = at.count(("path.py", line_of["int(core[0].rays)"]))
    log(f"sync check: {label} {sess.render_w}x{sess.render_h} {spp} spp, "
        f"{rounds} rounds, {rays} rays: {len(before)} synchronising calls "
        f"before the first round ({sorted(set(where(before)))}), "
        f"{len(in_loop)} from it on; alive.any() {n_alive}, int(rays) "
        f"{n_rays}")
    if strays:
        raise AssertionError(f"{label}: {len(strays)} synchronising calls in "
                             "the loop besides alive.any() and int(rays)")
    if not (len(in_loop) == rounds + 1 and n_alive == rounds + 1
            and n_rays == 1):
        raise AssertionError(
            f"{label}: {len(in_loop)} synchronising calls from the first "
            f"round on, alive.any() {n_alive}, int(rays) {n_rays}; want "
            f"{rounds + 1}, {rounds + 1}, 1 (rounds {rounds})")


def round_sync_check(spp):
    """Phase 20: path.trace_balanced under the sync debug mode, on macbeth
    (an environment light) and on a scene with a distant light."""
    from nart_tpu_torch import render, testing

    _, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                            device=DEVICE))
    _sync_checked("macbeth", sess, spp)
    params = render.RenderParams(image_width=128, image_height=128, spp=spp,
                                 bounces=6)
    sess = render.RenderSession(testing.distant_scene(), params, DEVICE)
    _sync_checked("distant light", sess, spp)


SIZES = {"camera_rays": 65536, "shadow_rays": 131072, "soup_tris": 40000,
         "soup_rays": 65536, "reps": 20}
# (first round, rounds) of the volume phases' profiled windows
VOLUME_WINDOW = (40, 20)


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
    cuda_build.load("cluster_hit")  # the one source: one nvcc
    log(f"build: {SOURCE} in {time.perf_counter() - t0:.2f} s")

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{label}: {time.perf_counter() - t0:.1f} s]")
        return out

    records = phase("kernel checks", kernel_checks, DEVICE, SIZES)
    phase("golden", golden_check, DEVICE, (96, 96, 8))
    counts = phase("forward path", main_path, {"spp": 8})
    counts_tool = phase("counter tool", stats_path)
    for k in ("closest_hit_stats", "any_hit_stats"):
        counts[k] = counts_tool[k]
    counts_train = phase("training path", training_path, 4)
    phase("card against CPU", card_against_cpu)
    counts_modes = phase("spp and regen modes", modes_path, (128, 72, 2))
    phase("volume golden", volume_golden)
    counts_vol = phase("volume forward", volume_forward, 8, VOLUME_WINDOW)
    counts_vol_train = phase("volume training path", volume_training, 4,
                             VOLUME_WINDOW)
    phase("volume card against CPU", volume_card_against_cpu, (32, 32, 2))
    counts_a, single = phase("sharded, virtual ranks", sharded_virtual, 2)
    counts_b = phase("two ranks, gloo", two_ranks, single)
    counts_c = phase("CLI, NCCL world of one", cli_world_of_one, 2)
    phase("checkpoint and resume", checkpoint_resume)
    phase("bvh accel", bvh_accel, (128, 72, 1))
    counts_bench = phase("bench subprocess", bench_subprocess, 128, 4)
    counts_cornell = phase("cornell golden", cornell_golden)
    phase("round sync check", round_sync_check, 1)

    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=counts[k], launches_training=counts_train[k],
                    launches_modes=counts_modes.get(k, 0),
                    launches_volume=counts_vol[k] + counts_vol_train[k],
                    launches_sharded=counts_a[k] + counts_b[k] + counts_c[k],
                    launches_bench=counts_bench[k],
                    launches_cornell=counts_cornell[k],
                    **records[k])
               for k in KERNELS]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())

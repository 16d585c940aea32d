"""Flag-compatible CLI: the counterpart of ``nart_tpu/cli.py`` (reference
src/core/main.cpp + ParseRenderParamArguments).

Usage: nart-tpu-torch <scene.json> <outPath> [flags]
       python -m nart_tpu_torch.cli <scene.json> <outPath> [flags]

  --imageWidth/-w --imageHeight/-h --bucketSize/-b --spp/-s
  --bounces/-o --filterWidth/-f --rougheningFactor/-r   (reference flags)
  --assetRoot DIR   base dir for scene-relative assets (default: auto)
  --accel {auto,cluster,brute,bvh,pallas}   "pallas" is the JAX package's
                    name of the cluster kernels, so its command lines run
  --wavefront {balanced,regen,spp}  --lanes N  --sortRays
  --device DEV      cpu or cuda (default: the card); --platform is the JAX
                    CLI's spelling (cpu, gpu, cuda) and means the same
  --devices N       N processes on this host, one per card under NCCL
                    (raises where fewer than N cards exist); with
                    --device cpu, N CPU processes under gloo
  --coordinator HOST:PORT --numProcesses N --processId I
                    one rank of a multi-process (multi-host) render: every
                    process passes the same coordinator; a rank's card is
                    cuda:{LOCAL_RANK}; rank 0 writes the EXR
  --profile DIR     torch.profiler chrome trace of the renders into DIR
  --timing          load / accel build / render / write seconds and Mrays/s
                    to stderr

A scene with several renderSessions writes <outPath>_<i>.exr for session i
(main.cpp:44-49).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from . import render as render_mod
from . import resolve_device, sharding
from .film import finalize
from .scene import load_scene

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def build_parser():
    p = argparse.ArgumentParser(prog="nart-tpu-torch", add_help=False)
    p.add_argument("scene")
    p.add_argument("out")
    p.add_argument("--imageWidth", "-w", type=int, dest="image_width")
    p.add_argument("--imageHeight", "-h", type=int, dest="image_height")
    p.add_argument("--bucketSize", "-b", type=int, dest="bucket_size")
    p.add_argument("--spp", "-s", type=int, dest="spp")
    p.add_argument("--bounces", "-o", type=int, dest="bounces")
    p.add_argument("--filterWidth", "-f", type=float, dest="filter_width")
    p.add_argument("--rougheningFactor", "-r", type=float,
                   dest="roughening_factor")
    p.add_argument("--devices", type=int, default=None,
                   help="render with N processes on this host, one per card")
    p.add_argument("--coordinator", type=str, default=None,
                   metavar="HOST:PORT",
                   help="multi-process rendering: the rendezvous address "
                   "(pass the same value to every process)")
    p.add_argument("--numProcesses", type=int, default=None,
                   dest="num_processes",
                   help="multi-process rendering: total process count")
    p.add_argument("--processId", type=int, default=None, dest="process_id",
                   help="multi-process rendering: this process's rank "
                   "(0-based); rank 0 writes the EXR")
    p.add_argument("--assetRoot", type=str, default=None)
    p.add_argument("--accel", default=None,
                   choices=("auto", "cluster", "brute", "bvh", "pallas"),
                   help="intersector: the cluster kernels (pallas is the "
                   "JAX package's name for them), brute force, or the "
                   "lockstep LBVH walk")
    p.add_argument("--wavefront", choices=("balanced", "regen", "spp"),
                   default=None,
                   help="balanced work queue (default), per-pixel sample "
                   "regeneration, or lockstep per-spp passes")
    p.add_argument("--lanes", type=int, default=None,
                   help="work slots of --wavefront balanced (0 = auto)")
    p.add_argument("--sortRays", action="store_true", dest="sort_rays",
                   help="coherence-sort rays inside each traversal query")
    p.add_argument("--device", type=str, default=None,
                   help="cpu or cuda (default: the card)")
    p.add_argument("--platform", type=str, default=None,
                   choices=tuple(_PLATFORMS),
                   help="the JAX CLI's name for --device")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace into DIR")
    p.add_argument("--timing", action="store_true",
                   help="print per-phase seconds and Mrays/s to stderr")
    p.add_argument("--help", action="help")
    return p


def _overrides(args):
    keys = ("image_width", "image_height", "bucket_size", "spp", "bounces",
            "filter_width", "roughening_factor", "accel", "wavefront",
            "lanes")
    out = {k: getattr(args, k) for k in keys if getattr(args, k) is not None}
    if args.sort_rays:
        out["sort_rays"] = True
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(argv, n, device):
    """Run this CLI as n ranks on this host (--coordinator on a local port,
    LOCAL_RANK = rank) and wait for them; raises where a CUDA run has fewer
    than n cards or a rank fails.  Every rank is stopped before returning."""
    if device != "cpu" and torch.cuda.device_count() < n:
        raise RuntimeError(f"--devices {n} needs {n} CUDA devices, this host "
                           f"has {torch.cuda.device_count()}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    try:
        for i in range(n):
            env = dict(os.environ, LOCAL_RANK=str(i),
                       PYTHONPATH=os.pathsep.join(
                           [root, os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "nart_tpu_torch.cli", *argv,
                 "--coordinator", coord, "--numProcesses", str(n),
                 "--processId", str(i)], env=env))
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"ranks exited with {rcs}")
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    device = args.device or _PLATFORMS.get(args.platform)
    if args.devices and args.devices > 1 and not args.coordinator:
        return _spawn_ranks(argv, args.devices, device)

    distributed = bool(args.coordinator)
    if distributed:
        device = sharding.init_distributed(
            f"tcp://{args.coordinator}", args.process_id, args.num_processes,
            device=None if device in (None, "cuda") else device)
    else:
        device = resolve_device(device)
    primary = sharding.is_primary()

    def say(msg, err=False):
        if primary:
            print(msg, file=sys.stderr if err else sys.stdout, flush=True)

    say(f"Loading {args.scene}...")
    t_load = time.perf_counter()
    scene = load_scene(args.scene, asset_root=args.assetRoot)
    if args.timing:
        say(f"# load: {time.perf_counter() - t_load:.3f}s", err=True)
    sessions = render_mod.load_sessions(args.scene, _overrides(args))
    if not sessions:
        say(f"Failed to load sessions from {args.scene}", err=True)
        return 1

    prof = None
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    for i, params in enumerate(sessions):
        start = time.perf_counter()
        say("Rendering...")
        t_build = time.perf_counter()
        sess = render_mod.RenderSession(scene, params, device)
        if args.timing:
            say(f"# accel build: {time.perf_counter() - t_build:.3f}s",
                err=True)
        t_render = time.perf_counter()
        if distributed:
            layout = sharding.Layout(dist.get_world_size(), 1)
            buf, stats = sharding.render_sharded(sess, layout)
            rays = sharding.all_reduce_sum(
                torch.tensor(float(stats["rays"]), device=device))
            rays = float(rays)
        else:
            buf = sess.render()
            rays = float(sess.stats["rays"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_render = time.perf_counter() - t_render
        if args.timing:
            say(f"# render: {t_render:.3f}s  rays: {rays:.0f}  "
                f"({rays / t_render / 1e6:.3f} Mrays/s)", err=True)
        img = finalize(buf, params.image_width, params.image_height,
                       sess.filter_bounds)
        out_path = args.out if len(sessions) == 1 else f"{args.out}_{i}"
        if not out_path.endswith(".exr"):
            out_path += ".exr"
        if primary:
            # every rank holds the merged film; one writes it
            say(f"Writing to {out_path}...")
            t_write = time.perf_counter()
            sess.write_exr(out_path, img=img)
            if args.timing:
                say(f"# write: {time.perf_counter() - t_write:.3f}s",
                    err=True)
        say(f"Completed in {time.perf_counter() - start:.6g}s")

    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        rank = dist.get_rank() if distributed else 0
        trace = os.path.join(args.profile, f"trace_rank{rank}.json")
        prof.export_chrome_trace(trace)
        say(f"# profiler trace written to {trace}", err=True)
    if distributed:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

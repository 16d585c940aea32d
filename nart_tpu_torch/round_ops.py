"""The operations a round dispatches, by call site: where the small kernels
of a path round and of a volume flight step come from.

    python -m nart_tpu_torch.round_ops [--width W] [--height H] [--spp S]
        [--rounds R] [--device D]

A per-round render (RenderSession(per_round=True): every round eager) of
macbeth (tests/fixtures/macbeth) and of volume_blob
(tests/golden/volume_blob.json, its medium read from this checkout), at
32x18 @ 1 spp unless told otherwise, stopped after R rounds (4).  Under a
TorchDispatchMode every aten operation dispatched inside a round's own
function is counted against the call that the round function made: its
line there and the function called (or the operation, where the round
function dispatched it itself).  The path's is ``bounce_body``
(integrators/path.py), a count a round; the volume's a flight step's,
a count a step, on two routes: the plain step (vol_ops.step_plain, every
operation of the step, forced on any device by running
vol_ops.flight_steps_plain in flight_steps' place) and, on the card, the
kernel route (the operations of vol_ops.flight_steps: its wrappers' few
and one launch of V1 a round of steps).  On the card the BSDF calls
dispatch only their wrappers' few operations and one launch each
(csrc/bsdf.cu: the sample+eval launch and X1); on the CPU they run the
plain versions, the parent's ~2,500 operations a sample.  The launches of
the port's kernels are printed from cuda_build.launch_counts.  A count is
of dispatched operations (views and allocations included), not of device
kernels: chip_smoke.py's phase 21 counts those.

Prints a "#" line per call site (operations a round, share) and one JSON
line.
"""

import argparse
import collections
import json
import linecache
import os
import sys

from torch.utils._python_dispatch import TorchDispatchMode

from . import bench, cuda_build, render, resolve_device, vol_ops
from .bench_configs import REPO, load_scene_doc
from .integrators import path, volume
from .scene import load_scene

MACBETH = os.path.join(REPO, "tests", "fixtures", "macbeth", "macbeth.json")
VOLUME = os.path.join(REPO, "tests", "golden", "volume_blob.json")
PACKAGE = os.path.dirname(os.path.abspath(__file__)) + os.sep
# the round functions: (file, function name); the volume's on the plain
# route and on the kernel route
ROUND_FUNCTIONS = {"path": (path.__file__, "bounce_body"),
                   "volume": (vol_ops.__file__, "step_plain"),
                   "volume_kernels": (vol_ops.__file__, "flight_steps")}


class Done(Exception):
    """Ends a render after the rounds wanted (stop_after)."""


class _Counter(TorchDispatchMode):
    """Counts each aten operation dispatched inside a frame of the round
    function (file, name) against (line there, the function it called)."""

    def __init__(self, file, name):
        super().__init__()
        self.file, self.name = os.path.abspath(file), name
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        frame, inner = sys._getframe(1), None
        while frame is not None:
            code = frame.f_code
            if (code.co_name == self.name
                    and os.path.abspath(code.co_filename) == self.file):
                callee = (inner.f_code.co_name if inner
                          else func.overloadpacket.__name__)
                self.sites[(frame.f_lineno, callee)] += 1
                break
            if os.path.abspath(code.co_filename).startswith(PACKAGE):
                inner = frame  # the package's function the round called
            frame = frame.f_back
        return func(*args, **(kwargs or {}))


def stop_after(module, maker, rounds, seen, hook=None):
    """module.maker with its round function wrapped to count its calls in
    seen["rounds"], call hook(*args) before each, and end the render by
    raising Done after `rounds` (None: never); returns the original."""
    real = getattr(module, maker)

    def make(*a, **k):
        made = real(*a, **k)
        body, rest = (made, None) if callable(made) else (made[0], made[1:])

        def counted(*args, **kw):
            if seen["rounds"] == rounds:
                raise Done
            seen["rounds"] += 1
            if hook is not None:
                hook(*args, **kw)
            return body(*args, **kw)
        return counted if rest is None else (counted, *rest)

    setattr(module, maker, make)
    return real


def round_ops(kind, scene, params, device, rounds):
    """(ops a round by call site {(line, callee): ops}, rounds counted,
    the port's kernel launches a round).  kind: "path", or "volume" /
    "volume_kernels" (the flight step's plain route / kernel route: ops
    and launches a flight step)."""
    module, maker = ((path, "make_bounce") if kind == "path"
                     else (volume, "_make_vol_step"))
    seen = {"rounds": 0}
    real = stop_after(module, maker, rounds, seen)
    real_steps = vol_ops.flight_steps
    steps = {"n": 0}

    def counted_steps(vs, k, *args):
        steps["n"] += k
        run = real_steps if kind == "volume_kernels" else (
            vol_ops.flight_steps_plain)
        return run(vs, k, *args)

    vol_ops.flight_steps = counted_steps
    counter = _Counter(*ROUND_FUNCTIONS[kind])
    cuda_build.reset_launch_counts()
    try:
        sess = render.RenderSession(scene, params, device, per_round=True)
        with counter:
            sess.render()
    except Done:
        pass
    finally:
        setattr(module, maker, real)
        vol_ops.flight_steps = real_steps
    n = max(seen["rounds"], 1)
    per = n if kind == "path" else max(steps["n"], 1)
    launches = {k: v / per for k, v in cuda_build.launch_counts.items() if v}
    return ({k: v / per for k, v in counter.sites.items()}, seen["rounds"],
            launches)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--height", type=int, default=18)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    size = {"image_width": args.width, "image_height": args.height,
            "spp": args.spp}
    vol = load_scene_doc(VOLUME, os.path.dirname(VOLUME))
    if vol.medium is None:
        raise RuntimeError("blob.vol was not loaded: no medium")
    out = {}
    cells = [("macbeth", "path",
              load_scene(MACBETH, asset_root=os.path.dirname(MACBETH)),
              MACBETH),
             ("volume_blob", "volume", vol, VOLUME)]
    if dev.type == "cuda":
        cells.append(("volume_blob, kernels", "volume_kernels", vol, VOLUME))
    for label, kind, scene, scene_path in cells:
        params = render.load_sessions(scene_path, size)[0]
        sites, n, launches = round_ops(kind, scene, params, dev, args.rounds)
        total = sum(sites.values())
        file = ROUND_FUNCTIONS[kind][0]
        unit = "a round" if kind == "path" else "a flight step"
        rows = []
        for (line, callee), ops in sorted(sites.items(),
                                          key=lambda kv: -kv[1]):
            text = linecache.getline(file, line).strip()
            rows.append({"line": line, "call": callee, "ops": ops,
                         "source": text})
            print(f"# {label}: {os.path.basename(file)}:{line} {callee}: "
                  f"{ops:.1f} ops {unit} ({100 * ops / total:.1f}%)  "
                  f"{text[:60]}", file=sys.stderr, flush=True)
        print(f"# {label}: {total:.1f} ops {unit} over {n} rounds; the "
              f"port's kernel launches {unit} {launches}", file=sys.stderr,
              flush=True)
        out[label] = {"rounds": n, "ops_a_round": total, "unit": unit,
                      "sites": rows, "launches_a_round": launches}
    if dev.type != "cuda":
        print("# volume_blob, kernels: not run (the kernel route needs the "
              "card)", file=sys.stderr, flush=True)
    print(json.dumps({"size": size, "rounds": args.rounds, "scenes": out,
                      "device": bench.device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()

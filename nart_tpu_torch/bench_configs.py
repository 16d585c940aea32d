"""The port's config matrix (BASELINE.md configs 1-5) on the card: the
counterpart of tools/bench_configs.py.

    python -m nart_tpu_torch.bench_configs [config ...]   (default: all)

Each config is rendered with the JAX tool's protocol (bench.measure): a warm
render, then the median of 3 timed renders and their min-max spread; the
fwd+bwd of configs 1 and 4 (at rougheningFactor 0.2) is timed the same way.
One JSON row per config (per sweep point of config 4) on stdout, with the
JAX tool's keys plus the card's nvidia-smi "name, power.limit", the round
count, the peak device memory and the timed runs' seconds.

A config whose inputs are absent prints {"config", "missing": [paths]} and
is not run: nothing is substituted for them.  Asset roots: configs 1, 3 and
4 read the reference checkout (bench.REFERENCE); config 2 reads it where it
exists, else tests/fixtures/macbeth, which holds the two meshes
tests/golden/cornell.json names; the volume rows read
tests/golden/volume_blob.json.  A file that a scene names by an absolute
path is read from beside the scene JSON where it is there (the generated
goldens name this checkout's tests/golden so), and a volume row fails if
its medium was not loaded.

Env: NART_BENCH_SIZE_SCALE scales the image sizes (smoke runs);
NART_BENCH_OUT writes all rows to that file as JSON.
"""

import json
import os
import sys
import tempfile

from . import bench, render, resolve_device
from .scene import load_scene, resolve_asset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = bench.REFERENCE
MACBETH_DIR = "tests/fixtures/macbeth"

CONFIGS = {
    # name: (scene path, asset roots (the first that exists), w, h, spp,
    #        bounces, extra params, validation note)
    "1_glassSphere": (
        bench.REF_SCENE, (REF,),
        512, 512, 16, 10, {"roughening_factor": 0.2},
        "tests/test_golden.py::test_glass_sphere_golden",
    ),
    "2_cornell": (
        "tests/golden/cornell.json", (REF, MACBETH_DIR),
        128, 128, 64, 6, {},
        "tests/test_golden.py::test_cornell_golden{,_64spp}",
    ),
    "3_texture_env": (
        "tests/golden/texture_env.json", (REF,),
        128, 128, 256, 6, {"roughening_factor": 0.25},
        "tests/test_golden.py::test_texture_env_golden",
    ),
    "4_caustic_sweep": (
        bench.REF_SCENE, (REF,),
        256, 256, 1024, 10, {"roughening_factor": None},  # sweep below
        "tests/test_golden.py::test_glass_sphere_golden (geometry/materials)"
        " + tools/bench_configs.py sweep rows",
    ),
    "5_volume": (
        "tests/golden/volume_blob.json", ("tests/golden",),
        96, 96, 256, 64, {"integrator": "volume"},
        "tests/test_golden.py::test_volume_golden",
    ),
    "5b_volume_256": (
        "tests/golden/volume_blob.json", ("tests/golden",),
        256, 256, 256, 64, {"integrator": "volume"},
        "tests/test_golden.py::test_volume_golden (same scene, 96^2)",
    ),
}
# rougheningFactor sweep of config 4 (the reference's -r); fwd+bwd at 0.2
SWEEP = (0.0, 0.2, 0.5)


def _in_repo(path):
    return path if os.path.isabs(path) else os.path.join(REPO, path)


def _file_nodes(node):
    """Every dict of a scene document that names a file ("filePath")."""
    if isinstance(node, dict):
        if isinstance(node.get("filePath"), str):
            yield node
        for v in node.values():
            yield from _file_nodes(v)
    elif isinstance(node, list):
        for v in node:
            yield from _file_nodes(v)


def scene_doc(scene_path):
    """The scene document, with each file named by an absolute path pointed
    at the file of that name beside the scene JSON where there is one."""
    with open(scene_path) as f:
        doc = json.load(f)
    here = os.path.dirname(os.path.abspath(scene_path))
    for node in _file_nodes(doc):
        beside = os.path.join(here, os.path.basename(node["filePath"]))
        if os.path.isabs(node["filePath"]) and os.path.exists(beside):
            node["filePath"] = beside
    return doc


def load_scene_doc(scene_path, root):
    """load_scene of scene_doc(scene_path) (through a temporary copy), its
    relative assets under root."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, os.path.basename(scene_path))
        with open(path, "w") as f:
            json.dump(scene_doc(scene_path), f)
        return load_scene(path, asset_root=root)


def missing_inputs(scene_path, root):
    """The inputs of a scene that are absent: the scene file itself, or
    the files it names that the loader would not find under root (each
    once, in the order the scene names them)."""
    if not os.path.exists(scene_path):
        return [scene_path]
    out = {}
    for node in _file_nodes(scene_doc(scene_path)):
        try:
            resolve_asset(node["filePath"], root)
        except FileNotFoundError:
            out[os.path.normpath(os.path.join(
                root, node["filePath"].replace("//", "/")))] = None
    return list(out)


def run_config(name, device=None):
    """The rows of one config (printed as they come)."""
    scene_path, roots, w, h, spp, bounces, extra, validation = CONFIGS[name]
    scene_path = _in_repo(scene_path)
    roots = [_in_repo(r) for r in roots]
    root = next((r for r in roots if os.path.isdir(r)), roots[-1])
    missing = missing_inputs(scene_path, root)
    if missing:
        row = {"config": name, "missing": missing}
        print(json.dumps(row), flush=True)
        return [row]
    dev = resolve_device(device)
    scale = float(os.environ.get("NART_BENCH_SIZE_SCALE", "1"))
    w, h = int(w * scale), int(h * scale)
    scene = load_scene_doc(scene_path, root)
    if extra.get("integrator") == "volume" and scene.medium is None:
        raise RuntimeError(f"{name}: the medium of {scene_path} was not "
                           "loaded")

    sweep = [None]
    if name == "4_caustic_sweep":
        sweep, extra = SWEEP, {}
    rows = []
    for r in sweep:
        kw = dict(image_width=w, image_height=h, spp=spp, bounces=bounces,
                  filter_width=2.0, **{k: v for k, v in extra.items()
                                       if v is not None})
        if r is not None:
            kw["roughening_factor"] = r
        sess = render.RenderSession(scene, render.RenderParams(**kw), dev)
        fwdbwd = name == "1_glassSphere" or (name == "4_caustic_sweep"
                                              and r == 0.2)
        runs = bench.measure(sess, "fwdbwd" if fwdbwd else "fwd")
        fwd = runs["fwd"]
        row = {
            "config": name if r is None else f"{name}_r{r}",
            "size": f"{w}x{h}", "spp": spp,
            "fwd_s": fwd["median_s"],
            "fwd_mrays_per_s": fwd["rays"] / fwd["median_s"] / 1e6,
            "fwd_spread_pct": fwd["spread_pct"],
            "fwd_runs_s": fwd["seconds"],
            "rays": int(fwd["rays"]),
            "validated_by": validation,
            "rounds": fwd["rounds"],
            "peak_mib": fwd["peak_mib"],
            "device": bench.device_name(dev),
        }
        if fwdbwd:
            fb = runs["fwdbwd"]
            row["fwdbwd_s"] = fb["median_s"]
            row["fwdbwd_mrays_per_s"] = fb["rays"] / fb["median_s"] / 1e6
            row["fwdbwd_spread_pct"] = fb["spread_pct"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or list(CONFIGS)
    rows = [row for n in names for row in run_config(n)]
    out = os.environ.get("NART_BENCH_OUT")
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"# wrote {out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()

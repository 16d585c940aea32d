"""A configuration's scene as the program and the reference read it: one
directory of the checkout (build/bench/scenes/<config>, at a fixed path)
that holds the frozen scene file, links to its frozen assets, and the
files the benchmark makes for it (configs/<name>.json's "generated":
each made once by its maker, from the parameters given there, and kept
for the later runs of the checkout)."""

import importlib
import os

from .spec import HERE, ROOT

SCENES = os.path.join(ROOT, "build", "bench", "scenes")


def _link(src, dst):
    if os.path.islink(dst) and os.readlink(dst) == src:
        return
    if os.path.lexists(dst):
        os.remove(dst)
    os.symlink(src, dst)


def _make(entry, dst):
    module, fn = entry["maker"].rsplit(".", 1)
    maker = getattr(importlib.import_module(f"{__package__}.{module}"), fn)
    args = {k: v for k, v in entry.items() if k not in ("file", "maker")}
    from . import exrfile

    part = dst + ".partial"
    exrfile.write_half_rgb(part, maker(**args))
    os.replace(part, dst)


def scene_file(cfg, root=SCENES):
    """The path of the configuration's scene file in its directory, every
    asset present."""
    src = os.path.join(HERE, os.path.dirname(cfg["scene"]))
    out = os.path.join(root, cfg["name"])
    name = os.path.basename(cfg["scene"])
    for rel in [name] + cfg.get("assets", []):
        frozen = os.path.join(src, rel)
        if not os.path.isfile(frozen):
            raise FileNotFoundError(f"the benchmark's {frozen} is missing")
        os.makedirs(os.path.dirname(os.path.join(out, rel)), exist_ok=True)
        _link(frozen, os.path.join(out, rel))
    for entry in cfg.get("generated", []):
        dst = os.path.join(out, entry["file"])
        if not os.path.isfile(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            _make(entry, dst)
    return os.path.join(out, name)

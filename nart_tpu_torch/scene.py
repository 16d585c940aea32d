"""JSON scene loading -> SceneData of tensors.

Counterpart of ``nart_tpu/scene.py`` (reference src/core/scene.cpp: JSON
schema, material/light/camera construction, pattern parsing, clamping
quirks).  Everything is baked into data: one concatenated triangle soup with
a per-triangle mesh id, per-mesh parameter tables whose patterns are a
constant or an index into one packed texture buffer, and a short list of
LightData records.  Containers hold CPU tensors after loading and move with
``.to(device)``.

Matrix convention: JSON 4x4s are row-major matrices A acting on column
vectors (points A @ [p,1], directions A @ [d,0], normals inv(A).T @ [n,0]).

Reference quirks preserved (as in the JAX package):
  * bare-array rho_d is NOT clamped to <1; all other color constants are
    clamped per channel to 1 - epsilon (scene.cpp:345-590)
  * glass materials never get normal maps (glassmaterial.cpp:4-9)
  * "distant" lights are an extension: the reference never constructs them
  * disk lights ignore "innerRadius" (only rings use it)

The env-map distribution keeps only its CDFs and pdfs: the JAX package's
inverse-CDF bracket tables (``marg_inv``/``cond_inv``) exist because TPU
``searchsorted`` is a rolled loop, and the sampler here searches directly
(see lights.env2d_sample).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from . import exr as exr_mod
from . import geo as geo_mod
from . import vol as vol_mod

FLT_BEFORE_ONE = np.float32(1.0) - np.float32(1.1920928955078125e-07)

# material type codes
MAT_LAMBERT, MAT_SPECULAR, MAT_GLASS, MAT_GLOSSY, MAT_PLASTIC = range(5)
_MAT_CODES = {
    "lambert": MAT_LAMBERT,
    "specular": MAT_SPECULAR,
    "glass": MAT_GLASS,
    "glossy": MAT_GLOSSY,
    "plastic": MAT_PLASTIC,
}

# light type codes
LIGHT_DISK, LIGHT_RING, LIGHT_ENV, LIGHT_DISTANT = 0, 1, 2, 3


def map_tensors(obj, fn):
    """A copy of dataclass ``obj`` with ``fn`` applied to every tensor
    (also inside nested dataclasses and lists)."""
    def conv(v):
        if torch.is_tensor(v):
            return fn(v)
        if dataclasses.is_dataclass(v):
            return map_tensors(v, fn)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return dataclasses.replace(
        obj, **{f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    )


def _to_device(obj, device):
    return map_tensors(obj, lambda t: t.to(device))


def _t(a, dtype=None):
    """numpy (or scalar) -> CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=dtype))


@dataclass
class Env2D:
    """Piecewise-constant 2D distribution for env-map importance sampling.

    Parity: Piecewise2DDistribution (texturepattern.cpp:3-109) — marginal
    over rows (v), conditional over columns (u), with the image's v-flip
    applied at build."""

    marg_pdf: Any  # (h,)
    marg_cdf: Any  # (h+1,)
    cond_pdf: Any  # (h, w)
    cond_cdf: Any  # (h, w+1)
    width: int
    height: int

    def to(self, device):
        return _to_device(self, device)


@dataclass
class LightData:
    kind: int  # LIGHT_DISK / LIGHT_RING / LIGHT_ENV / LIGHT_DISTANT
    xf: Any  # (4,4) light-to-world
    radius: float
    inner_radius: float
    intensity: Any  # () float32
    le_const: Any  # (3,)
    # None or (h, w, 3) texture stored as RAW image rows; the v-flip happens
    # at lookup (lights._le_value)
    le_tex: Any
    env2d: Optional[Env2D]

    def to(self, device):
        return _to_device(self, device)


@dataclass
class MediumData:
    bounds_min: Any  # (3,)
    bounds_max: Any  # (3,)
    sigma_a: Any  # () float32
    sigma_s: Any  # () float32
    le: Any  # (3,)
    density: Any  # (Z, Y, X) float32
    sigma_maj: float  # global majorant: max density * (sigma_a + sigma_s)

    def to(self, device):
        return _to_device(self, device)


@dataclass
class SceneData:
    """A loaded scene: per-triangle and per-mesh tables as tensors."""

    # triangle soup (world space)
    tri_v: Any  # (T, 3, 3)
    tri_n: Any  # (T, 3, 3)
    tri_uv: Any  # (T, 3, 2)
    tri_mesh: Any  # (T,) int32
    # per-mesh tables
    mesh_priority: Any  # (M,) int32
    mat_type: Any  # (M,) int32
    rho_d_const: Any  # (M, 3)
    rho_d_tex: Any  # (M,) int32
    rho_s_const: Any
    rho_s_tex: Any
    tau_const: Any
    tau_tex: Any
    eta_const: Any  # (M,)
    eta_tex: Any
    alpha_const: Any  # (M,) pre-squared roughness
    alpha_tex: Any
    has_normal: Any  # (M,) bool
    normal_const: Any  # (M, 3)
    normal_tex: Any  # (M,) int32
    # packed mesh textures
    tex_data: Any  # (P, 3) float32 (roughness textures pre-squared)
    tex_off: Any  # (NT,) int32
    tex_w: Any  # (NT,) int32
    tex_h: Any  # (NT,) int32
    lights: list  # list[LightData]
    cam_to_world: Any  # (4, 4)
    fov: float
    medium: Optional[MediumData]
    n_meshes: int
    n_tris: int
    # which mesh-texture slots have any texture bound (subset of
    # {"rho_d","rho_s","tau","eta","alpha","normal"}): unbound slots skip
    # their texture fetch
    tex_slots: tuple = ()

    def to(self, device):
        return _to_device(self, device)


_ARRAY_FIELDS = {
    "tri_v": np.float32, "tri_n": np.float32, "tri_uv": np.float32,
    "tri_mesh": np.int32, "mesh_priority": np.int32, "mat_type": np.int32,
    "rho_d_const": np.float32, "rho_d_tex": np.int32,
    "rho_s_const": np.float32, "rho_s_tex": np.int32,
    "tau_const": np.float32, "tau_tex": np.int32,
    "eta_const": np.float32, "eta_tex": np.int32,
    "alpha_const": np.float32, "alpha_tex": np.int32,
    "has_normal": bool, "normal_const": np.float32, "normal_tex": np.int32,
    "tex_data": np.float32, "tex_off": np.int32, "tex_w": np.int32,
    "tex_h": np.int32, "cam_to_world": np.float32,
}


def light_from_numpy(d) -> LightData:
    env = d.get("env2d")
    env2d = None
    if env is not None:
        env2d = Env2D(
            marg_pdf=_t(env["marg_pdf"], np.float32),
            marg_cdf=_t(env["marg_cdf"], np.float32),
            cond_pdf=_t(env["cond_pdf"], np.float32),
            cond_cdf=_t(env["cond_cdf"], np.float32),
            width=int(env["width"]),
            height=int(env["height"]),
        )
    le_tex = d.get("le_tex")
    return LightData(
        kind=int(d["kind"]),
        xf=_t(d["xf"], np.float32),
        radius=float(d["radius"]),
        inner_radius=float(d["inner_radius"]),
        intensity=_t(d["intensity"], np.float32),
        le_const=_t(d["le_const"], np.float32),
        le_tex=None if le_tex is None else _t(le_tex, np.float32),
        env2d=env2d,
    )


def from_numpy(d: dict) -> SceneData:
    """SceneData from a dict of numpy arrays and scalars.

    The dict has SceneData's field names; ``lights`` is a list of dicts with
    LightData's field names (``env2d`` a dict or None) and ``medium`` a dict
    or None — the shape ``dataclasses.asdict`` gives a JAX-package scene,
    so both packages can compute on the same data.  Extra keys (the JAX
    package's env bracket tables) are ignored."""
    kw = {k: _t(d[k], dt) for k, dt in _ARRAY_FIELDS.items()}
    med = d.get("medium")
    medium = None
    if med is not None:
        medium = MediumData(
            bounds_min=_t(med["bounds_min"], np.float32),
            bounds_max=_t(med["bounds_max"], np.float32),
            sigma_a=_t(med["sigma_a"], np.float32),
            sigma_s=_t(med["sigma_s"], np.float32),
            le=_t(med["le"], np.float32),
            density=_t(med["density"], np.float32),
            sigma_maj=float(med["sigma_maj"]),
        )
    return SceneData(
        **kw,
        lights=[light_from_numpy(li) for li in d["lights"]],
        fov=float(d["fov"]),
        medium=medium,
        n_meshes=int(d["n_meshes"]),
        n_tris=int(d["n_tris"]),
        tex_slots=tuple(d.get("tex_slots", ())),
    )


def _mat4(vec) -> np.ndarray:
    return np.asarray(vec, np.float32).reshape(4, 4)


_IDENTITY = np.eye(4, dtype=np.float32).reshape(-1).tolist()


class _TexturePacker:
    def __init__(self, asset_root):
        self.asset_root = asset_root
        self.cache = {}  # (path, is_rough) -> tex_id
        self.images = []

    def add(self, path, is_roughness=False):
        key = (path, is_roughness)
        if key in self.cache:
            return self.cache[key]
        img = _read_texture(path, self.asset_root)
        if is_roughness:
            img = img * img  # reference squares roughness on fetch
        tid = len(self.images)
        self.images.append(np.ascontiguousarray(img, np.float32))
        self.cache[key] = tid
        return tid

    def pack(self):
        if not self.images:
            return (
                np.zeros((1, 3), np.float32),
                np.zeros((1,), np.int32),
                np.ones((1,), np.int32),
                np.ones((1,), np.int32),
            )
        offs, ws, hs, flat = [], [], [], []
        off = 0
        for img in self.images:
            h, w, _ = img.shape
            offs.append(off)
            ws.append(w)
            hs.append(h)
            flat.append(img.reshape(-1, 3))
            off += h * w
        return (
            np.concatenate(flat, axis=0),
            np.asarray(offs, np.int32),
            np.asarray(ws, np.int32),
            np.asarray(hs, np.int32),
        )


def _read_texture(path, asset_root):
    """Read an EXR texture, substituting a neutral placeholder when the
    asset is absent."""
    try:
        return exr_mod.read(resolve_asset(path, asset_root))[..., :3]
    except FileNotFoundError:
        print(f"warning: texture {path!r} missing; using 0.5 placeholder",
              file=sys.stderr)
        return np.full((4, 4, 3), 0.5, np.float32)


def resolve_asset(path: str, asset_root: str) -> str:
    """Resolve scene-relative asset paths like 'input//meshes//sphere.geo'."""
    path = path.replace("//", "/")
    for base in (asset_root, os.getcwd()):
        cand = os.path.join(base, path)
        if os.path.exists(cand):
            return cand
    if os.path.exists(path):
        return path
    raise FileNotFoundError(f"asset {path!r} not found under {asset_root!r}")


def _clampv(v):
    return np.minimum(np.asarray(v, np.float32), FLT_BEFORE_ONE)


def _get_pattern(packer, node, *, clamp=True, is_roughness=False, scalar=False):
    """Parse a pattern node -> (const (3,), tex_id).

    Parity: Scene::GetRho_d / GetRho_s / GetEta / GetTau / GetAlpha / GetLe
    (scene.cpp:345-590).  Scalars (eta, roughness) broadcast to 3 channels.
    """
    if isinstance(node, dict):
        ptype = node.get("type")
        if ptype == "texture":
            return np.zeros(3, np.float32), packer.add(node["filePath"],
                                                       is_roughness)
        if ptype == "constant":
            v = node["value"]
            if scalar or np.isscalar(v):
                v = np.full(3, np.float32(v), np.float32)
                if is_roughness:
                    v = v * v
                return v.astype(np.float32), -1
            v = np.asarray(v, np.float32)
            return (_clampv(v) if clamp else v), -1
        raise ValueError(f"'{ptype}' is not a pattern type")
    if np.isscalar(node):
        v = np.full(3, np.float32(node), np.float32)
        if is_roughness:
            v = v * v
        return v, -1
    v = np.asarray(node, np.float32)
    return (_clampv(v) if clamp else v), -1


def _build_env2d(img: np.ndarray) -> Env2D:
    """Marginal/conditional CDFs.  texturepattern.cpp:3-70."""
    h, w, _ = img.shape
    # v-flip: row j of the distribution is image row (h - j - 1)
    lum = np.abs(img[::-1]).sum(axis=2).astype(np.float64)  # (h, w)
    marg = lum.mean(axis=1)  # (h,) — *= invW
    f_int = marg.mean()  # *= invH
    cond = np.where(
        marg[:, None] != 0.0,
        lum / np.where(marg[:, None] == 0, 1, marg[:, None]),
        1.0,
    )
    marg = marg / f_int
    marg_cdf = np.zeros(h + 1)
    marg_cdf[1:] = np.cumsum(marg) / h
    marg_cdf[h] = 1.0
    cond_cdf = np.zeros((h, w + 1))
    cond_cdf[:, 1:] = np.cumsum(cond, axis=1) / w
    cond_cdf[:, w] = 1.0
    return Env2D(
        marg_pdf=_t(marg, np.float32),
        marg_cdf=_t(marg_cdf, np.float32),
        cond_pdf=_t(cond, np.float32),
        cond_cdf=_t(cond_cdf, np.float32),
        width=w,
        height=h,
    )


def load_scene(scene_path: str, asset_root: Optional[str] = None) -> SceneData:
    """Load a scene JSON into CPU tensors (move with ``.to(device)``)."""
    with open(scene_path) as f:
        doc = json.load(f)
    if asset_root is None:
        # scenes reference assets as input/... relative to the project root
        # (<root>/input/scenes/x.json), or to the scene's own directory when
        # an input/ directory sits beside it (tests/fixtures/macbeth)
        d = os.path.dirname(os.path.abspath(scene_path))
        if not os.path.isdir(os.path.join(d, "input")):
            d = os.path.dirname(os.path.dirname(d))
        asset_root = d

    packer = _TexturePacker(asset_root)

    # ---- camera (scene.cpp:782-875) ----
    cam = doc.get("camera", {})
    fov = float(cam.get("fov", 11.0))
    cam_xf = _mat4(cam.get("transform", _IDENTITY))
    medium = None
    if "medium" in cam:
        m = cam["medium"]
        try:
            grid = vol_mod.load_vol(resolve_asset(m["filePath"], asset_root))
        except FileNotFoundError:
            print(f"warning: volume {m['filePath']!r} missing; camera medium "
                  "disabled", file=sys.stderr)
            grid = None
        if grid is not None:
            sigma_a = np.float32(m["sigma_a"])
            sigma_s = np.float32(m["sigma_s"])
            # width-1 grid => one global majorant (reference)
            sigma_maj = float(grid.density.max()) * (sigma_a + sigma_s)
            medium = MediumData(
                bounds_min=_t(grid.bounds_min),
                bounds_max=_t(grid.bounds_max),
                sigma_a=_t(sigma_a),
                sigma_s=_t(sigma_s),
                le=_t(m["Le"], np.float32),
                density=_t(grid.density),
                sigma_maj=float(sigma_maj),
            )

    # ---- meshes + materials (scene.cpp:644-780) ----
    mesh_defs = doc.get("meshes", [])
    tri_v, tri_n, tri_uv, tri_mesh = [], [], [], []
    mesh_priority = []
    mat_type = []
    z3 = np.zeros(3, np.float32)
    slots = ("rho_d", "rho_s", "tau", "eta", "alpha", "normal")
    cols = {k: {"const": [], "tex": []} for k in slots}
    has_normal = []

    def push(k, const, tex):
        cols[k]["const"].append(const)
        cols[k]["tex"].append(tex)

    for i, md in enumerate(mesh_defs):
        mat = md["material"]
        mtype = mat["type"]
        if mtype not in _MAT_CODES:
            raise ValueError(f"'{mtype}' is not a material type")
        mat_type.append(_MAT_CODES[mtype])
        mesh_priority.append(int(md.get("priority", 0)))

        need = {
            "lambert": ("rho_d",),
            "specular": ("rho_s", "eta"),
            "glass": ("rho_s", "tau", "eta", "alpha"),
            "glossy": ("rho_s", "eta", "alpha"),
            "plastic": ("rho_d", "rho_s", "eta", "alpha"),
        }[mtype]
        for k in ("rho_d", "rho_s", "tau", "eta", "alpha"):
            if k in need:
                src = mat["roughness"] if k == "alpha" else mat[k]
                const, tex = _get_pattern(
                    packer,
                    src,
                    clamp=(k != "rho_d" or isinstance(src, dict)),
                    is_roughness=(k == "alpha"),
                    scalar=(k in ("eta", "alpha")),
                )
            else:
                const, tex = z3, -1
            push(k, const, tex)

        # normal map; glass never gets one (reference ctor bug, preserved)
        n_node = mat.get("normal")
        if n_node is not None and mtype != "glass":
            const, tex = _get_pattern(packer, n_node, clamp=True)
            has_normal.append(True)
            push("normal", const, tex)
        else:
            has_normal.append(False)
            push("normal", z3, -1)

        arr = geo_mod.load_geo(
            resolve_asset(md["filePath"], asset_root),
            _mat4(md.get("transform", _IDENTITY)),
        )
        tri_v.append(arr.v)
        tri_n.append(arr.n)
        tri_uv.append(arr.uv)
        tri_mesh.append(np.full(len(arr.v), i, np.int32))

    if tri_v:
        tri_v = np.concatenate(tri_v)
        tri_n = np.concatenate(tri_n)
        tri_uv = np.concatenate(tri_uv)
        tri_mesh = np.concatenate(tri_mesh)
    else:
        tri_v = np.zeros((1, 3, 3), np.float32)
        tri_n = np.tile(np.array([0, 0, 1], np.float32), (1, 3, 1))
        tri_uv = np.zeros((1, 3, 2), np.float32)
        tri_mesh = np.zeros(1, np.int32)

    # ---- lights (scene.cpp:877-932) ----
    lights = []
    for ld in doc.get("lights", []):
        ltype = ld.get("type")
        if ltype not in ("disk", "ring", "environment", "distant"):
            continue  # parity: unknown types silently skipped
        xf = _mat4(ld.get("transform", _IDENTITY))
        le_node = ld["Le"]
        le_tex = None
        env2d = None
        if isinstance(le_node, dict) and le_node.get("type") == "texture":
            img = _read_texture(le_node["filePath"], asset_root).astype(
                np.float32
            )
            le_tex = _t(img)
            env2d = _build_env2d(img)  # GetLe always builds the pdf
            le_const = np.zeros(3, np.float32)
        else:
            le_const, _ = _get_pattern(packer, le_node, clamp=True)
        kind = {
            "disk": LIGHT_DISK,
            "ring": LIGHT_RING,
            "environment": LIGHT_ENV,
            "distant": LIGHT_DISTANT,
        }[ltype]
        lights.append(
            LightData(
                kind=kind,
                xf=_t(xf),
                radius=float(ld.get("radius", 1.0)),
                inner_radius=float(ld.get("innerRadius", 0.0)),
                intensity=_t(np.float32(ld.get("intensity", 1.0))),
                le_const=_t(le_const, np.float32),
                le_tex=le_tex,
                env2d=env2d,
            )
        )

    tex_data, tex_off, tex_w, tex_h = packer.pack()

    def stack(name):
        c = cols[name]["const"] or [np.zeros(3, np.float32)]
        t = cols[name]["tex"] or [-1]
        return np.stack(c).astype(np.float32), np.asarray(t, np.int32)

    tables = {name: stack(name) for name in slots}
    tex_slots = tuple(name for name in slots if (tables[name][1] >= 0).any())
    return SceneData(
        tri_v=_t(tri_v, np.float32),
        tri_n=_t(tri_n, np.float32),
        tri_uv=_t(tri_uv, np.float32),
        tri_mesh=_t(tri_mesh, np.int32),
        mesh_priority=_t(mesh_priority or [0], np.int32),
        mat_type=_t(mat_type or [0], np.int32),
        rho_d_const=_t(tables["rho_d"][0]),
        rho_d_tex=_t(tables["rho_d"][1]),
        rho_s_const=_t(tables["rho_s"][0]),
        rho_s_tex=_t(tables["rho_s"][1]),
        tau_const=_t(tables["tau"][0]),
        tau_tex=_t(tables["tau"][1]),
        eta_const=_t(tables["eta"][0][:, 0]),
        eta_tex=_t(tables["eta"][1]),
        alpha_const=_t(tables["alpha"][0][:, 0]),
        alpha_tex=_t(tables["alpha"][1]),
        has_normal=_t(np.asarray(has_normal or [False], bool)),
        normal_const=_t(tables["normal"][0]),
        normal_tex=_t(tables["normal"][1]),
        tex_data=_t(tex_data, np.float32),
        tex_off=_t(tex_off),
        tex_w=_t(tex_w),
        tex_h=_t(tex_h),
        lights=lights,
        cam_to_world=_t(cam_xf),
        fov=fov,
        medium=medium,
        n_meshes=max(1, len(mesh_defs)),
        n_tris=len(tri_v),
        tex_slots=tex_slots,
    )

"""The port's host core (nart_tpu_torch/csrc/core.cpp, bound by
nart_tpu_torch/native.py) against the numpy versions it stands beside,
bit for bit: .geo meshes of triangles, quads and a pentagon with and
without uvs under a transform that is not the identity, a .vol grid, and
LBVH builds of soups of 1 to 5,000 triangles at leaves of 1 to 16; and
against the JAX package's C++ route (nart_tpu/_native.py), the same bits.
The loaders and the LBVH build take the core on the CPU too (it is their
only route), malformed files raise ValueError in the core and in numpy, a
failed build raises, and no module of the port imports jax or nart_tpu.  Skips only where
there is no g++ to build the core with.
"""

import ast
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from nart_tpu import _native as jnative
from nart_tpu import geo as jgeo
from nart_tpu_torch import bvh, cluster_accel, cuda_build, geo, native, vol
from nart_tpu_torch.scene import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MACBETH_DIR = os.path.join(REPO, "tests", "fixtures", "macbeth")
_XF = np.array([[0.5, -0.25, 0.0, 1.0],
                [0.25, 0.75, 0.1, -2.0],
                [0.0, 0.2, 1.5, 0.5],
                [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.fixture
def core():
    """The port's core, built here; the test skips where no g++ exists."""
    if shutil.which(cuda_build.cxx_path()) is None:
        pytest.skip(f"no host compiler ({cuda_build.cxx_path()}) to build "
                    "csrc/core.cpp with")
    return native.lib()


def jax_core(monkeypatch):
    """The JAX package's libnartcore.so, or None where it cannot be built
    here (no make or no g++).  nart_tpu/_native.py builds it with make at
    first use in every process into one file name, and keeps a failure as
    None: a load that met another process's build half-written is taken
    again, once, after that build had a moment to end."""
    lib = jnative.get()
    if lib is None and shutil.which("make") and shutil.which("g++"):
        time.sleep(1.0)
        monkeypatch.setattr(jnative, "_tried", False)
        monkeypatch.setattr(jnative, "_lib", None)
        lib = jnative.get()
        assert lib is not None, "nart_tpu/native/libnartcore.so did not build"
    return lib


def assert_same_bits(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=name)


def write_geo(path, faces, verts, norms, uvs=None, rng=None):
    """A .geo file of `faces` (corner counts) over the given coordinates,
    each corner's indices drawn from rng."""
    rng = rng or np.random.default_rng(0)
    nvi = int(sum(faces))
    secs = [[len(faces)], faces,
            rng.integers(0, len(verts), nvi), np.asarray(verts).ravel(),
            rng.integers(0, len(norms), nvi), np.asarray(norms).ravel()]
    if uvs is not None:
        secs += [rng.integers(0, len(uvs), nvi), np.asarray(uvs).ravel()]
    with open(path, "w") as f:
        for sec in secs:
            f.write(" ".join(repr(float(x)) if isinstance(x, (float,
                             np.floating)) else str(int(x)) for x in sec))
            f.write("\n")
    return str(path)


def _mesh_file(tmp_path, uvs, seed=1):
    rng = np.random.default_rng(seed)
    faces = [3, 4, 5, 4, 3, 5, 4]  # triangles, quads and pentagons
    verts = rng.normal(size=(11, 3)) * 3.0
    norms = rng.normal(size=(6, 3))
    uv = rng.random((9, 2)) if uvs else None
    return write_geo(tmp_path / f"m{int(uvs)}.geo", faces, verts, norms, uv,
                     rng), sum(f - 2 for f in faces)


@pytest.mark.parametrize("uvs", [True, False], ids=["vt", "no vt"])
def test_geo_cpp_matches_numpy(tmp_path, core, uvs, monkeypatch):
    path, n_tris = _mesh_file(tmp_path, uvs)
    cpp = geo.load_geo(path, _XF)
    plain = geo.load_geo_plain(path, _XF)
    assert cpp.v.shape == (n_tris, 3, 3)
    for name in ("v", "n", "uv"):
        assert_same_bits(getattr(cpp, name), getattr(plain, name), name)
    if not uvs:
        assert_same_bits(cpp.uv, np.broadcast_to(geo._DEFAULT_UVS,
                                                 (n_tris, 3, 2)))
    lib = jax_core(monkeypatch)
    if lib is not None:
        for name, want in zip(("v", "n", "uv"), jnative.geo_load(path, _XF)):
            assert_same_bits(getattr(cpp, name), want, "JAX C++ " + name)
    else:  # the JAX package's numpy route, to tests/test_native.py's bounds
        py = jgeo._load_geo_py(path, _XF)
        np.testing.assert_allclose(cpp.v, py.v, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(cpp.n, py.n, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(cpp.uv, py.uv)


def test_vol_cpp_matches_numpy(tmp_path, core, monkeypatch):
    rng = np.random.default_rng(2)
    dens = rng.random((5, 4, 3)).astype(np.float32) * 7.0
    head = [-1.25, -2.0, 0.1, 1.0, 0.5, 3.3, 3, 4, 5]
    path = tmp_path / "t.vol"
    path.write_text(" ".join(map(str, head)) + "\n"
                    + "\n".join(repr(float(x)) for x in dens.ravel()))
    cpp = vol.load_vol(str(path))
    plain = vol.load_vol_plain(str(path))
    for name in ("bounds_min", "bounds_max", "density"):
        assert_same_bits(getattr(cpp, name), getattr(plain, name), name)
    assert cpp.density.shape == (5, 4, 3)
    lib = jax_core(monkeypatch)
    if lib is not None:
        for got, want in zip((cpp.bounds_min, cpp.bounds_max, cpp.density),
                             jnative.vol_load(str(path))):
            assert_same_bits(got, want, "JAX C++")


def _soup(t, seed):
    rng = np.random.default_rng(seed)
    tri = (rng.normal(size=(t, 3, 3)) * 2.0
           + rng.normal(size=(t, 1, 3)) * 10.0).astype(np.float32)
    tri[::7, 1] = tri[::7, 0]  # some degenerate triangles
    return tri


@pytest.mark.parametrize("t", [1, 5, 300, 5000])
def test_lbvh_cpp_matches_numpy(core, t, monkeypatch):
    tri = _soup(t, t)
    lib = jax_core(monkeypatch)
    for leaf in (1, 4, 8, 16):
        cpp = native.lbvh_build(tri, leaf)
        plain = bvh.build_bvh_arrays(tri, leaf)
        assert cpp.keys() == plain.keys()
        for k in ("n_leaves", "leaf_size", "depth"):
            assert cpp[k] == plain[k], k
        for k in ("node_lo", "node_hi", "order", "tri_v"):
            assert_same_bits(cpp[k], plain[k], f"{k} leaf {leaf}")
        if lib is not None:
            want = jnative.lbvh_build(tri, leaf, cpp["n_leaves"])
            for k, w in zip(("node_lo", "node_hi", "order", "tri_v"), want):
                assert_same_bits(cpp[k], w, f"JAX C++ {k} leaf {leaf}")


def test_scene_and_accel_take_the_core(core, monkeypatch):
    """load_scene and build_accel on CPU tensors parse and build through
    the core (every .geo, the camera's .vol and the LBVH of macbeth: two
    spheres and a plane), and give the scene and tree of the numpy
    versions."""
    calls = []

    def counted(name):
        fn = getattr(native, name)

        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    scene_path = os.path.join(MACBETH_DIR, "macbeth.json")
    with monkeypatch.context() as m:
        for name in ("geo_load", "vol_load", "lbvh_build"):
            m.setattr(native, name, counted(name))
        a = load_scene(scene_path)
        ta = cluster_accel.build_accel(a.tri_v.numpy(), "bvh")
    with open(scene_path) as f:
        n_meshes = len(json.load(f)["meshes"])
    assert calls == ["vol_load"] + ["geo_load"] * n_meshes + ["lbvh_build"]
    with monkeypatch.context() as m:
        m.setattr(geo, "load_geo", geo.load_geo_plain)
        m.setattr(vol, "load_vol", vol.load_vol_plain)
        m.setattr(native, "lbvh_build", bvh.build_bvh_arrays)
        b = load_scene(scene_path)
        tb = cluster_accel.build_accel(b.tri_v.numpy(), "bvh")
    for k in ("tri_v", "tri_n", "tri_uv", "tri_mesh"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.medium.density, b.medium.density)
    for k in ("node_lo", "node_hi", "order", "tri_v", "node_pairs",
              "tri_rec"):
        assert torch.equal(getattr(ta, k), getattr(tb, k)), k


_BAD_GEO = {
    "empty": "",
    "face counts": "3 4 4",
    "vertex indices": "1 3 0 1",
    "vertex coords": "1 3 0 1 2 0 0 0 1 0 0 0 1",
    "normals": "1 3 0 1 2 0 0 0 1 0 0 0 1 0 0 0 0 0 1",
    "uvs": "1 3 0 1 2 0 0 0 1 0 0 0 1 0 0 0 0 0 0 1 0 1 2 0 0 1",
    "negative index": "1 3 0 -1 2 0 0 0 1 0 0 0 1 0",
    "no corners": "2 0 0 1 2 3",
}


@pytest.mark.parametrize("case", list(_BAD_GEO))
def test_bad_geo_raises_in_core_and_numpy(tmp_path, core, case):
    path = tmp_path / "bad.geo"
    path.write_text(_BAD_GEO[case])
    for load in (geo.load_geo, geo.load_geo_plain):
        with pytest.raises(ValueError):
            load(str(path), np.eye(4))


@pytest.mark.parametrize("text", ["0 0 0 1 1", "0 0 0 1 1 1 2 2 2 0.5 0.5",
                                  "0 0 0 1 1 1 -2 2 2 0.5"],
                         ids=["header", "densities", "resolution"])
def test_bad_vol_raises_in_core_and_numpy(tmp_path, core, text):
    path = tmp_path / "bad.vol"
    path.write_text(text)
    for load in (vol.load_vol, vol.load_vol_plain):
        with pytest.raises(ValueError):
            load(str(path))


def test_missing_files_raise_file_not_found(tmp_path, core):
    for load_geo, load_vol in ((geo.load_geo, vol.load_vol),
                               (geo.load_geo_plain, vol.load_vol_plain)):
        with pytest.raises(FileNotFoundError):
            load_geo(str(tmp_path / "none.geo"), np.eye(4))
        with pytest.raises(FileNotFoundError):
            load_vol(str(tmp_path / "none.vol"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """CXX=/bin/false and an empty build directory: the loaders, the LBVH
    build and load_scene raise with the compiler's exit, and nothing falls
    back to numpy."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setenv("CXX", "/bin/false")
    path, _ = _mesh_file(tmp_path, True)
    with pytest.raises(RuntimeError, match="/bin/false failed"):
        geo.load_geo(path, _XF)
    with pytest.raises(RuntimeError, match="/bin/false failed"):
        bvh.build_bvh(_soup(5, 0))
    with pytest.raises(RuntimeError, match="/bin/false failed"):
        load_scene(os.path.join(MACBETH_DIR, "macbeth.json"))
    assert os.listdir(tmp_path / "build") == []  # no stub left behind


def _imported_modules(path):
    """Every module name a Python file imports, at any depth."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "nart_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "nart_tpu"), (f, mod)

"""tools/obj2geo.py's .geo files read by the port's loader
(nart_tpu_torch.geo.load_geo) and by the JAX package's.

A tiny OBJ of quads and a triangle, with per-corner normals, with and
without texture coordinates, is written, converted with the tool's
``convert`` and loaded under a transform that is not the identity by the
port's loader (its C++ core), by that loader's numpy version and by the
JAX package's C++ route (nart_tpu._native.geo_load, the route nart_tpu.geo.load_geo takes
where its library is built): the fan-triangulated vertices, normals and
uvs must be the same bits (the port does its float32 arithmetic in that
route's order).  The JAX package's numpy fallback rounds the transforms
otherwise; it is the comparison only where the JAX library cannot be
built at all (no make or g++), to tests/test_native.py's tolerances.
Without ``vt`` every loader takes the reference's default uvs.
"""

import importlib.util
import os

import numpy as np
import pytest

from nart_tpu import _native as jnative
from nart_tpu import geo as jgeo
from nart_tpu_torch import geo as tgeo
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401
from tests.test_torch_native import assert_same_bits, core, jax_core  # noqa: F401

TOOL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                    "obj2geo.py")

_VERTS = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1.5
v 0.5 2 0.25
vn 0 0 1
vn 0 1 0
vn 1 0.5 0.25
"""
_UVS = """vt 0 0
vt 1 0
vt 1 1
vt 0 1
"""
# two quads and a triangle, every corner with a normal
_FACES_UV = """f 1/1/1 2/2/1 3/3/1 4/4/1
f 1/1/2 2/2/2 6/3/3 5/4/3
f 3/1/3 7/2/2 4/3/1
"""
_FACES = """f 1//1 2//1 3//1 4//1
f 1//2 2//2 6//3 5//3
f 3//3 7//2 4//1
"""
_XF = np.array([[0.5, -0.25, 0.0, 1.0],
                [0.25, 0.75, 0.1, -2.0],
                [0.0, 0.2, 1.5, 0.5],
                [0.0, 0.0, 0.0, 1.0]], np.float32)


def _convert():
    spec = importlib.util.spec_from_file_location("obj2geo", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert


def _geo(tmp_path, uvs, capsys):
    obj = tmp_path / "mesh.obj"
    obj.write_text(_VERTS + (_UVS + _FACES_UV if uvs else _FACES))
    geo = _convert()(str(obj))
    assert geo == str(tmp_path / "mesh.geo") and os.path.exists(geo)
    assert "Faces: 3" in capsys.readouterr().out
    return geo


@pytest.mark.parametrize("uvs", [True, False], ids=["vt", "no vt"])
def test_obj2geo_output_loads_alike(tmp_path, uvs, capsys, monkeypatch,
                                    core):
    geo = _geo(tmp_path, uvs, capsys)
    mt = tgeo.load_geo(geo, _XF)
    assert mt.v.shape == (5, 3, 3)  # 2 + 2 + 1 fan triangles
    if jax_core(monkeypatch) is not None:
        for name, want in zip(("v", "n", "uv"), jnative.geo_load(geo, _XF)):
            assert_same_bits(getattr(mt, name), want, name)
    else:
        mj = jgeo._load_geo_py(geo, _XF)
        np.testing.assert_allclose(mt.v, mj.v, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mt.n, mj.n, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(mt.uv, mj.uv)
    if not uvs:
        np.testing.assert_array_equal(
            mt.uv, np.broadcast_to(tgeo._DEFAULT_UVS, (5, 3, 2)))


@pytest.mark.parametrize("uvs", [True, False], ids=["vt", "no vt"])
def test_obj2geo_output_core_matches_numpy(tmp_path, uvs, capsys, core):
    """The port's C++ core loads the tool's file with its numpy bits."""
    geo = _geo(tmp_path, uvs, capsys)
    cpp = tgeo.load_geo(geo, _XF)
    plain = tgeo.load_geo_plain(geo, _XF)
    for name in ("v", "n", "uv"):
        assert_same_bits(getattr(cpp, name), getattr(plain, name), name)

"""nart_tpu_torch scene loading and EXR I/O vs nart_tpu: exact.

Every SceneData field of the port's load_scene must equal the JAX
package's (the env-map bracket tables, which the port does not build,
excepted), and the port's numpy PIZ reader must return the same bits as
nart_tpu.exr.read on every PIZ file in the repository.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from nart_tpu import exr as jexr
from nart_tpu import scene as jscene
from nart_tpu_torch import exr as texr
from nart_tpu_torch import scene as tscene
from tests.test_torch_harness import one_intra_op_thread  # noqa: F401

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures", "macbeth")
PIZ_FILES = sorted(glob.glob(os.path.join(HERE, "golden", "*.exr"))) + [
    os.path.join(FIX, "input", "textures", "parking_garage_4k.exr")]


def _eq(a, b, name):
    a = a.numpy() if torch.is_tensor(a) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=name)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=name)


def _assert_same_scene(t: tscene.SceneData, j):
    for f in dataclasses.fields(j):
        name = f.name
        jv, tv = getattr(j, name), getattr(t, name)
        if name == "lights":
            assert len(tv) == len(jv)
            for lt, lj in zip(tv, jv):
                for lf in ("kind", "xf", "radius", "inner_radius",
                           "intensity", "le_const"):
                    _eq(getattr(lt, lf), getattr(lj, lf), lf)
                assert (lt.le_tex is None) == (lj.le_tex is None)
                if lj.le_tex is not None:
                    _eq(lt.le_tex, lj.le_tex, "le_tex")
                assert (lt.env2d is None) == (lj.env2d is None)
                if lj.env2d is not None:
                    for ef in ("marg_pdf", "marg_cdf", "cond_pdf", "cond_cdf",
                               "width", "height"):
                        _eq(getattr(lt.env2d, ef), getattr(lj.env2d, ef), ef)
        elif name == "medium":
            assert (tv is None) == (jv is None)
            if jv is not None:
                for mf in dataclasses.fields(jv):
                    _eq(getattr(tv, mf.name), getattr(jv, mf.name), mf.name)
        elif name == "tex_slots":
            assert tuple(tv) == tuple(jv)
        else:
            _eq(tv, jv, name)


@pytest.mark.parametrize("scene_file", [
    os.path.join(FIX, "macbeth.json"),
    os.path.join(HERE, "golden", "cornell.json"),
])
def test_load_scene_fields_equal(scene_file):
    j = jscene.load_scene(scene_file, asset_root=FIX)
    t = tscene.load_scene(scene_file, asset_root=FIX)
    _assert_same_scene(t, j)


def test_from_numpy_matches_loader():
    """from_numpy(asdict(JAX scene)) == the port's own load_scene."""
    path = os.path.join(FIX, "macbeth.json")
    j = jscene.load_scene(path, asset_root=FIX)
    t = tscene.from_numpy(dataclasses.asdict(j))
    _assert_same_scene(t, j)
    moved = t.to("cpu")
    assert moved.tri_v.device.type == "cpu" and moved.lights[0].xf is not None


@pytest.mark.parametrize("path", PIZ_FILES,
                         ids=[os.path.basename(p) for p in PIZ_FILES])
def test_piz_reader_bit_exact(path):
    a = texr.read(path)
    b = jexr.read(path)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_zips_reader_and_writer_roundtrip(tmp_path):
    """The ColorChecker texture (ZIPS, RGB) reads as the JAX package reads
    it, and the ZIPS writer round-trips half RGBA through both readers."""
    tex = os.path.join(FIX, "input", "textures", "sRGB_ColorChecker2005.exr")
    np.testing.assert_array_equal(texr.read(tex), jexr.read(tex))
    img = np.random.default_rng(0).random((17, 23, 4), dtype=np.float32) * 4
    out = str(tmp_path / "rt.exr")
    texr.write(out, img)
    want = img.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(texr.read(out), want)
    np.testing.assert_array_equal(jexr.read(out), want)

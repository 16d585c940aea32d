"""ctypes binding of the port's host runtime core (csrc/core.cpp).

Counterpart of ``nart_tpu/_native.py``: the .geo parse (fan triangulation
and world transform), the .vol parse and the LBVH build in C++, with the
numpy versions' bits (geo.load_geo_plain, vol.load_vol_plain,
bvh.build_bvh_arrays).  The library is built with g++ at first use
(cuda_build.build_host) into ``build/nart_tpu_torch/``; a failed build
raises with the compiler's output, and nothing falls back to numpy.

The core is the loaders' only route, on every device: geo.load_geo,
vol.load_vol and bvh.build_bvh call it.  The numpy versions stay only as
the plain references the tests hold it to.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from . import cuda_build

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_NO_FILE = 2  # core.cpp's return code for a file that cannot be opened


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def lib() -> ctypes.CDLL:
    """The loaded core, built on first use (raises where it cannot be)."""
    core = cuda_build.load_host("core")
    if core.core_last_error.restype is not ctypes.c_char_p:
        core.core_last_error.argtypes = []
        core.core_last_error.restype = ctypes.c_char_p
        core.geo_open.argtypes = [ctypes.c_char_p, _f32p, _f32p, _i64p]
        core.geo_read_into.argtypes = [_f32p, _f32p, _f32p]
        core.vol_open.argtypes = [ctypes.c_char_p, _f64p]
        core.vol_read_into.argtypes = [_f32p]
        core.lbvh_build.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, _f32p, _f32p, _i32p,
                                    _f32p]
        for fn in (core.geo_open, core.geo_read_into, core.vol_open,
                   core.vol_read_into, core.lbvh_build):
            fn.restype = ctypes.c_int
    return core


def _raise(core, rc, what, path):
    why = core.core_last_error().decode()
    if rc == _NO_FILE:
        raise FileNotFoundError(f"{what} file {path}: {why}")
    raise ValueError(f"{what} file {path}: {why}")


def _object_to_world(m) -> np.ndarray:
    """A 4x4 objectToWorld (or its 16 values, row-major) as a C-contiguous
    float32 (4, 4) array."""
    return np.ascontiguousarray(np.asarray(m, np.float32).reshape(4, 4))


def _normal_matrix(a: np.ndarray) -> np.ndarray:
    """inv(A)[:3, :3].T in float32, the normals' transform (the inverse in
    numpy's float32, as nart_tpu/_native.py computes it)."""
    return np.ascontiguousarray(np.linalg.inv(a)[:3, :3].T, np.float32)


def geo_load(path: str, xf):
    """A .geo mesh through the core: (v (T, 3, 3), n (T, 3, 3), uv (T, 3,
    2)) float32, world space.  Raises ValueError on a malformed file and
    FileNotFoundError where it cannot be opened, as the numpy version."""
    core = lib()
    a = _object_to_world(xf)
    nm = _normal_matrix(a)
    n_tris = ctypes.c_int64()
    rc = core.geo_open(str(path).encode(), _ptr(a, _f32p), _ptr(nm, _f32p),
                       ctypes.byref(n_tris))
    if rc != 0:
        _raise(core, rc, "mesh", path)
    t = n_tris.value
    v = np.empty((t, 3, 3), np.float32)
    n = np.empty((t, 3, 3), np.float32)
    uv = np.empty((t, 3, 2), np.float32)
    core.geo_read_into(_ptr(v, _f32p), _ptr(n, _f32p), _ptr(uv, _f32p))
    return v, n, uv


def vol_load(path: str):
    """A .vol grid through the core: (bounds_min (3,), bounds_max (3,),
    density (Z, Y, X)) float32."""
    core = lib()
    header = np.zeros(9, np.float64)
    rc = core.vol_open(str(path).encode(), _ptr(header, _f64p))
    if rc != 0:
        _raise(core, rc, "volume", path)
    rx, ry, rz = (int(x) for x in header[6:9])
    density = np.empty((rz, ry, rx), np.float32)
    core.vol_read_into(_ptr(density, _f32p))
    return (header[0:3].astype(np.float32), header[3:6].astype(np.float32),
            density)


def _n_leaves(t: int, leaf_size: int) -> int:
    """The LBVH's leaf count: the power of two >= ceil(t / leaf_size)."""
    return 1 << max(0, math.ceil(math.log2(max(1, -(-t // leaf_size)))))


def lbvh_build(tri_v, leaf_size: int = 8) -> dict:
    """The LBVH build through the core: bvh.build_bvh_arrays' dict (node_lo,
    node_hi, order int32, tri_v, n_leaves, leaf_size, depth), its bits."""
    tri_v = np.ascontiguousarray(tri_v, np.float32)
    if tri_v.ndim != 3 or tri_v.shape[1:] != (3, 3) or len(tri_v) < 1:
        raise ValueError(f"tri_v must be (T >= 1, 3, 3) (got {tri_v.shape})")
    if int(leaf_size) < 1:
        raise ValueError(f"leaf_size must be >= 1 (got {leaf_size})")
    t, leaf_size = len(tri_v), int(leaf_size)
    n_leaves = _n_leaves(t, leaf_size)
    slots = n_leaves * leaf_size
    out = dict(node_lo=np.empty((2 * n_leaves - 1, 3), np.float32),
               node_hi=np.empty((2 * n_leaves - 1, 3), np.float32),
               order=np.empty(slots, np.int32),
               tri_v=np.empty((slots, 3, 3), np.float32))
    core = lib()
    rc = core.lbvh_build(_ptr(tri_v, _f32p), t, leaf_size, n_leaves,
                         _ptr(out["node_lo"], _f32p),
                         _ptr(out["node_hi"], _f32p),
                         _ptr(out["order"], _i32p),
                         _ptr(out["tri_v"], _f32p))
    if rc != 0:
        raise ValueError(f"lbvh_build: {core.core_last_error().decode()}")
    out.update(n_leaves=n_leaves, leaf_size=leaf_size,
               depth=n_leaves.bit_length() - 1)
    return out

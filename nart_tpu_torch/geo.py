""".geo mesh loading: parse, fan-triangulate, transform to world space.

Counterpart of ``nart_tpu/geo.py``'s pure-Python loader (``_load_geo_py``;
reference src/core/scene.cpp:77-343).  The .geo format is whitespace-
separated text: numFaces, faceVertCount[], vertIndex[], vertCoord[],
normIndex[], normCoord[], then optionally uvIndex[] and uvCoord[].
Points transform as A @ [p, 1], normals as inverse(A).T @ [n, 0].

``load_geo`` parses with the port's C++ core (native.geo_load,
csrc/core.cpp; nart_tpu/_native.py's route); ``load_geo_plain`` is its
numpy version, the plain reference the tests hold it to, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import native

# default UVs when a mesh has none: Triangle ctor defaults (geometry.h:58-60)
_DEFAULT_UVS = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)


@dataclass
class MeshArrays:
    """Fan-triangulated world-space triangle soup (SoA, numpy)."""

    v: np.ndarray  # (T, 3, 3) vertices
    n: np.ndarray  # (T, 3, 3) shading normals
    uv: np.ndarray  # (T, 3, 2)


def load_geo(path: str, object_to_world: np.ndarray) -> MeshArrays:
    """The fan-triangulated world-space mesh of a .geo file, by the C++
    core.  Raises ValueError on a malformed file."""
    return MeshArrays(*native.geo_load(path, object_to_world))


def _indices(idx, path):
    """An index section as int64 (truncated), refused unless every index
    lies in [0, 2^32), as csrc/core.cpp refuses it."""
    if idx.size and not (idx.min() >= 0 and idx.max() < 2.0 ** 32):
        raise ValueError(f"mesh file {path}: an index is not in [0, 2^32)")
    return idx.astype(np.int64)


def load_geo_plain(path: str, object_to_world: np.ndarray) -> MeshArrays:
    """load_geo's numpy version."""
    nums = np.fromfile(path, dtype=np.float64, sep=" ")
    if nums.size == 0:
        raise ValueError(f"mesh file {path} could not be read")
    pos = 0

    def take(n):
        nonlocal pos
        out = nums[pos : pos + n]
        if out.size != n:
            raise ValueError(f"mesh file {path} truncated")
        pos += n
        return out

    num_faces = int(_indices(take(1), path)[0])
    face_counts = _indices(take(num_faces), path)
    nvi = int(face_counts.sum())
    if nvi == 0:
        raise ValueError(f"mesh file {path}: the mesh has no face corners")
    vert_idx = _indices(take(nvi), path)
    verts = take((vert_idx.max() + 1) * 3).astype(np.float32).reshape(-1, 3)
    norm_idx = _indices(take(nvi), path)
    norms = take((norm_idx.max() + 1) * 3).astype(np.float32).reshape(-1, 3)

    no_uvs = pos >= nums.size
    if not no_uvs:
        uv_idx = _indices(take(nvi), path)
        uvs = take((uv_idx.max() + 1) * 2).astype(np.float32).reshape(-1, 2)

    # float32 arithmetic one operation at a time, in the order of
    # csrc/core.cpp's geo_open (and the JAX package's native loader), so
    # both load the same bits
    a = np.asarray(object_to_world, np.float32).reshape(4, 4)
    x, y, z = verts.T
    verts = np.stack([a[r, 0] * x + a[r, 1] * y + a[r, 2] * z + a[r, 3]
                      for r in range(3)], axis=-1)
    nm = np.asarray(np.linalg.inv(a)[:3, :3].T, np.float32)  # inverse-T
    x, y, z = norms.T
    nx, ny, nz = (nm[r, 0] * x + nm[r, 1] * y + nm[r, 2] * z for r in range(3))
    inv = np.float32(1.0) / np.maximum(np.sqrt(nx * nx + ny * ny + nz * nz),
                                       np.float32(1e-20))
    norms = np.stack([nx * inv, ny * inv, nz * inv], axis=-1)

    # fan triangulation: face (i0, i1, ..., ik) -> (i0, ij+1, ij+2)
    # (scene.cpp:274-282)
    starts = np.concatenate([[0], np.cumsum(face_counts)[:-1]])
    n_tri = np.maximum(face_counts - 2, 0)
    first = np.repeat(starts, n_tri)
    j = np.arange(int(n_tri.sum())) - np.repeat(np.cumsum(n_tri) - n_tri, n_tri)
    tri_corner = np.stack([first, first + j + 1, first + j + 2], axis=-1)

    v = verts[vert_idx[tri_corner]]
    n = norms[norm_idx[tri_corner]]
    if no_uvs:
        uv = np.broadcast_to(_DEFAULT_UVS, (len(tri_corner), 3, 2)).copy()
    else:
        uv = uvs[uv_idx[tri_corner]]
    return MeshArrays(
        v=v.astype(np.float32), n=n.astype(np.float32), uv=uv.astype(np.float32)
    )

"""nart-tpu-torch: the PyTorch + CUDA port of the nart-tpu path tracer.

The JAX package ``nart_tpu`` stays the reference; every module here names
its counterpart there.  This package imports ``torch`` and numpy only — never
``jax`` and never ``nart_tpu`` — so it runs on a machine without JAX.

Layer map (bottom -> top), mirroring ``nart_tpu/__init__.py``:

  rng.py            Xorshift32 streams in int64-masked arithmetic (rng.py)
  sampling.py       sampling warps + Latin-square image samples (sampling.py)
  exr.py            EXR codec: NONE/RLE/ZIPS/ZIP/PIZ reader, ZIPS writer
                    (exr.py; PIZ is new — numpy Huffman + Haar wavelet)
  geo.py, vol.py    .geo mesh / .vol grid parsers (geo.py, vol.py)
  scene.py          JSON scene -> SceneData of tensors, .to(device)
                    (scene.py)
  testing.py        tiny programmatic scenes (testing.py)
  camera.py         pinhole ray generation (camera.py)
  geometry.py       watertight ray-triangle test, brute intersector,
                    packed surface rows (geometry.py)
  cluster_accel.py  cluster build + closest-hit / any-hit traversal: CUDA
                    kernels (csrc/cluster_hit.cu) for CUDA tensors, plain
                    torch versions for CPU tensors (pallas_accel.py,
                    accel.py's kind policy)
  bxdf.py           5 BSDF lobes + aggregation (bxdf.py)
  materials.py      per-hit BSDF descriptors, half textures (materials.py)
  lights.py         disk / ring / env / distant lights, packed area tables
                    (lights.py)
  film.py           Gaussian filter splatting (film.py)
  integrators/      balanced work-queue path integrator (integrators/path.py)
  render.py         sessions, parameter resolution, EXR output (render.py)
"""

__version__ = "0.1.0"

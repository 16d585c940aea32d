"""nart-tpu-torch: the PyTorch + CUDA port of the nart-tpu path tracer.

The JAX package ``nart_tpu`` stays the reference; every module here names
its counterpart there.  This package imports ``torch`` and numpy only — never
``jax`` and never ``nart_tpu`` — so it runs on a machine without JAX.

Layer map (bottom -> top), mirroring ``nart_tpu/__init__.py``:

  rng.py            Xorshift32 streams in int64-masked arithmetic (rng.py)
  sampling.py       sampling warps + Latin-square image samples (sampling.py)
  exr.py            EXR codec: NONE/RLE/ZIPS/ZIP/PIZ reader, ZIPS writer
                    (exr.py; PIZ is new — numpy Huffman + Haar wavelet)
  geo.py, vol.py    .geo mesh / .vol grid parsers (geo.py, vol.py), by
                    the host core; numpy versions as plain references
  native.py         ctypes binding of the host core csrc/core.cpp: the
                    .geo/.vol parsers and the LBVH build in C++, built
                    with g++ at first use, on every device
                    (_native.py, native/core.cpp)
  scene.py          JSON scene -> SceneData of tensors, .to(device)
                    (scene.py)
  testing.py        tiny programmatic scenes (testing.py)
  camera.py         pinhole ray generation (camera.py)
  geometry.py       watertight ray-triangle test, brute intersector,
                    packed surface rows (geometry.py)
  cluster_accel.py  cluster build + closest-hit / any-hit traversal and
                    the walk's visit counters: CUDA kernels
                    (csrc/cluster_hit.cu) for CUDA tensors, plain torch
                    versions for CPU tensors (pallas_accel.py, accel.py's
                    kind policy, tools/kernel_stats.py's kernel)
  bvh.py            LBVH build (the host core) + plain lockstep walk,
                    the "bvh" kind (accel.py)
  select.py         table look-ups: CUDA kernels (csrc/small_lut.cu,
                    csrc/large_lut.cu) forward and backward for float
                    tables on the card, table[idx] on the CPU (select.py)
  bxdf.py           5 BSDF lobes + aggregation (bxdf.py)
  materials.py      per-hit BSDF descriptors, half textures (materials.py)
  lights.py         disk / ring / env / distant lights, packed area tables
                    (lights.py)
  media.py          density grids, packed 8-corner cell lookups, the
                    medium's slab clip (media.py)
  film.py           Gaussian filter splatting (film.py)
  integrators/      path integrator: balanced work queue, lockstep trace,
                    per-pixel sample regeneration, detached-sampling
                    estimator and the path replay trace_balanced_loss
                    (integrators/path.py); volume integrator: delta
                    tracking, lockstep trace / trace_diff, the work queue
                    and the static assignment, their replays
                    (integrators/volume.py; no traversal kernel)
  rounds.py         the round runner: a work-queue machine's rounds, k to
                    a host check, one CUDA graph on the card (the
                    machines' lax.while_loop and render.py's
                    _trace_balanced_jit cache); the replay's runner, whose
                    backward replays one captured round graph a round
  replay.py         the path replay's kept fwd+bwd machine: per-round
                    store, leaf tensors, forward and backward rounds
                    (grad.py's _balanced_grad_jit)
  render.py         sessions, parameter resolution, the "balanced",
                    "regen" and "spp" modes over the grid or a shard's
                    rows, checkpoint/resume, EXR output (render.py)
  checkpoint.py     film + RNG-state NPZ checkpoints (checkpoint.py)
  grad.py           trainable parameters, loss_and_grad,
                    radiance_weighted_loss_and_grad (grad.py)
  sharding.py       torch.distributed: Layout (row ranks x sample slabs),
                    striped-row shards, film and gradient all-reduce
                    (sharding.py)
  cli.py            flag-compatible CLI, one process or one per card:
                    python -m nart_tpu_torch.cli (cli.py)
  scaling_evidence.py  a striped render's ranks one after another on one
                    card: rounds, drain tail, rays, device ms, bytes
                    (tools/scaling_evidence.py)
  kernel_stats.py   traversal counters per ray and the tool that prints
                    them: python -m nart_tpu_torch.kernel_stats
                    (tools/kernel_stats.py)
  lut_runs.py       the large tables' backward look-ups on a per-round
                    fwd+bwd: launches, rows touched, the longest run of
                    one row: python -m nart_tpu_torch.lut_runs (no
                    counterpart)

Entry points (RenderSession, render_scene_file, grad.loss_and_grad,
grad.radiance_weighted_loss_and_grad, kernel_stats.main, cli.main) run on
the card unless the caller names a device, and raise where
there is none (resolve_device); a distributed rank's card is
cuda:{LOCAL_RANK} (sharding.init_distributed); the tests name "cpu".
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device of an entry point: the one the caller names, else the
    card.  With no device named and no CUDA device present this raises; it
    never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: nart_tpu_torch runs on the card unless the "
            "caller names a device (device='cpu')")
    return torch.device("cuda")

"""Build and load the package's CUDA kernels (nvcc -> shared library ->
ctypes), and its host core (g++ -> shared library -> ctypes).

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers that return
``cudaGetLastError()``.  ``load(name)`` compiles the source for Hopper
(sm_90a) at first use into ``build/nart_tpu_torch/`` beside the package —
the file name carries a hash of the source and flags, so an edited source
rebuilds — and returns the ``ctypes.CDLL``.  ``load_host(name)`` does the
same for the host source ``csrc/<name>.cpp`` with g++ (``$CXX`` where it is
set): the runtime core of native.py.  A failed build raises with the
compiler's output.  Nothing is compiled or loaded when the module is
imported.

``launch_counts`` counts the kernels' launches on the card, per wrapper:
the traversal kernels of csrc/cluster_hit.cu (cluster_accel.py), the LBVH
walk of csrc/bvh_walk.cu (bvh.py: "bvh_hit", its closest-hit and any-hit
entries alike), the look-up kernels of csrc/small_lut.cu and
csrc/large_lut.cu (select.py), the BSDF kernels of csrc/bsdf.cu
(bsdf_ops.py: "bsdf_sample", "bsdf_sample_eval", "bsdf_eval",
"bsdf_f_bwd"; X1's and X3's first designs, the references,
"bsdf_sample_reference" and "bsdf_f_bwd_reference") and the volume's
flight-step kernels of csrc/vol_step.cu (vol_ops.py: "vol_steps", V1, a
round's steps forward, and "vol_steps_bwd", V2, their backward; their
first designs, the references, "vol_steps_reference" and
"vol_steps_bwd_reference").  ``load_host_cu(name)`` builds a kernel
source's lane functions as host C++ (``-x c++``, g++'s flags above): the
CPU tests walk lanes through csrc/vol_step.cu that way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "nart_tpu_torch",
)
# --fmad=false: every multiply/add rounds on its own, as in the op-by-op
# PyTorch reference (see csrc/cluster_hit.cu); no fast-math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
# -ffp-contract=off: the host twin of --fmad=false, no multiply and add
# contracted into an FMA on any host (aarch64's g++ would), so the core's
# float32 arithmetic keeps numpy's bits
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_loaded: dict = {}

# kernel launches on the card per wrapper since the last
# reset_launch_counts(): each *_cuda wrapper adds one where it launches its
# kernel, nowhere else.  Called while a CUDA graph is being captured, a
# wrapper launches nothing: the graph launches the kernel at each replay.
# It then adds one to captured_launches instead, and the code that replays
# the graph (rounds.RoundRunner, rounds.ReplayRunner) adds those counts to
# launch_counts at every replay
# (the small-table backward's two-launch route and the first designs of the
# LBVH walk, of the BSDF sample and backward and of the flight steps, the
# references no path launches, count under names of their own:
# "lut_gather_bwd_reference", "bvh_hit_reference", "bsdf_sample_reference",
# "bsdf_f_bwd_reference", "vol_steps_reference", "vol_steps_bwd_reference")
launch_counts = {"closest_hit": 0, "any_hit": 0, "closest_hit_stats": 0,
                 "any_hit_stats": 0, "lut_gather": 0, "lut_gather_bwd": 0,
                 "lut_gather_large_bwd": 0, "lut_gather_bwd_reference": 0,
                 "bvh_hit": 0, "bvh_hit_reference": 0, "bsdf_sample": 0,
                 "bsdf_sample_eval": 0, "bsdf_eval": 0, "bsdf_f_bwd": 0,
                 "bsdf_sample_reference": 0, "bsdf_f_bwd_reference": 0,
                 "vol_steps": 0, "vol_steps_bwd": 0,
                 "vol_steps_reference": 0, "vol_steps_bwd_reference": 0}
captured_launches = dict.fromkeys(launch_counts, 0)


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def reset_captured_launches():
    for k in captured_launches:
        captured_launches[k] = 0


def count_launch(name):
    """One launch of kernel `name` (or, during a capture, one per replay)."""
    if torch.cuda.is_current_stream_capturing():
        captured_launches[name] += 1
    else:
        launch_counts[name] += 1


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _compile(src, flags, compiler):
    """Compile src (if not built yet) into BUILD_DIR; returns the .so
    path.  The file name hashes the source and the flags; the library is
    written to a temporary file and renamed into place, so a process that
    builds beside another never loads a half-written one."""
    with open(src, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(flags).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(BUILD_DIR, f"lib{name}-{key.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{proc.args[0]} failed on {src} (exit {proc.returncode}):"
                f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees a stub
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def build(name: str) -> str:
    """Compile csrc/<name>.cu (if not built yet); returns the .so path."""
    return _compile(os.path.join(SRC_DIR, name + ".cu"), NVCC_FLAGS,
                    nvcc_path)


def cxx_path() -> str:
    """The host compiler: $CXX where it is set, else g++."""
    return os.environ.get("CXX") or "g++"


def build_host(name: str) -> str:
    """Compile the host source csrc/<name>.cpp (if not built yet) with the
    host compiler; returns the .so path."""
    return _compile(os.path.join(SRC_DIR, name + ".cpp"), CXX_FLAGS,
                    cxx_path)


def build_host_cu(name: str) -> str:
    """Compile csrc/<name>.cu as host C++ (its lane functions and host
    entries; the kernels are outside the host build) with the host
    compiler; returns the .so path."""
    return _compile(os.path.join(SRC_DIR, name + ".cu"),
                    ("-x", "c++") + CXX_FLAGS, cxx_path)


def _load(key, path_of):
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(path_of())
        _loaded[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    return _load(name + ".cu", lambda: build(name))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cpp, built on first use."""
    return _load(name + ".cpp", lambda: build_host(name))


def load_host_cu(name: str) -> ctypes.CDLL:
    """The loaded host build of csrc/<name>.cu, built on first use."""
    return _load(name + ".cu host", lambda: build_host_cu(name))

"""Table look-ups: per-lane rows of float tables, differentiable.

Counterpart of ``nart_tpu/select.py``.  There a look-up into a small
table (per-mesh materials, the packed light rows, a texture of a few
texels) is a one-hot product: a handful of vector operations on a TPU,
where a gather is a scalar loop, and it differentiates cleanly, its
transpose ``ohf.T @ g`` being the scatter-add that the gather's backward
needs: a dense reduction over the lanes.  Tables of more than 64 rows
(its ``auto_lut``) are plain gathers there, as are the texture table and
the medium's density cells, whose backward is XLA's scatter-add.

Here every float table's look-up is the autograd Function ``_LutGather``
on every device.  On CUDA tensors its forward is csrc/small_lut.cu's
``nart_lut_gather`` (the rows, the plain gather's bits; rows of 1 to 8
values, any row count), counted in ``cuda_build.launch_counts`` as
"lut_gather"; the table's shape picks its backward.  Tables of up to
AUTO_LUT_ROWS rows of up to 4 values (S1) take ``nart_lut_gather_bwd``
(the per-row sum of the lanes' cotangents in a fixed order: the same bits
every run, no float atomics), counted as "lut_gather_bwd".  The others
(S2: the env map, the texture table, the light atlas, the density cells,
whose rows hold 8 values) take csrc/large_lut.cu's ``nart_lut_large_bwd``
after a stable sort of the lanes by row (a segmented sum over the sorted
lanes in a fixed order), counted as "lut_gather_large_bwd".  Inside a CUDA
graph capture a launch counts at every replay.  PyTorch's own backward of
``table[idx]`` on the card is a sorted ``index_put_(accumulate=True)``
that walks every run of equal indices serially, and the runs are tens of
thousands of lanes long.  On CPU tensors the Function runs the plain
versions, ``table[idx]`` and that ``index_put_``: the bits of
``table[idx]`` under autograd.  There is no fallback between the two: a
CUDA tensor launches the kernels or raises.  Int and bool tables are read
by plain indexing on any device: they carry no gradient, and a gather's
forward is cheap on the card.

``row_pick``/``row_put`` (per-lane picks with no shared table) have no
counterpart here: the nested-dielectric list does them with ``gather`` and
``where`` (``_pick``/``_put``, integrators/path.py).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from . import cuda_build

# the JAX package's auto_lut threshold (tables of more rows are plain
# gathers there), and here the largest table whose backward is the
# small-table kernel's.  On an H100 that kernel beats the large-table one
# (whose stable sort is most of its ~0.1 ms) up to at least 16,384 rows of
# 3 at 65,536 lanes, and loses at 65,536 rows (chip_smoke.py phase 24);
# the line stays at 64, where the small-table kernel's scratch,
# (lanes / 512, n, C) floats, stays small.
AUTO_LUT_ROWS = 64
SMALL_MAX_WIDTH = 4  # the small-table backward's largest row width C
MAX_WIDTH = 8  # the forward's and the large-table backward's


def small_lut(idx, n):
    """Row look-ups into (n, ...) tables for the per-lane index idx, clamped
    to [0, n - 1] as the JAX package's clip (and a gather) clamps, for any
    n: the counterpart of both the JAX package's small_lut and its auto_lut
    (whose plain gather above 64 rows is the same function).  Returns
    lut(table): (n,) -> (N,) or (n, C) -> (N, C)."""
    ci = idx.long().clamp(0, n - 1)

    def lut(table):
        if table.is_floating_point():
            return _LutGather.apply(table, ci)
        return table[ci]

    return lut



class _LutGather(torch.autograd.Function):
    """table[idx] for a float table and an in-range int64 idx: on the card
    (float32 only) the look-up kernels, the backward the small-table one up
    to AUTO_LUT_ROWS rows of up to SMALL_MAX_WIDTH values and the
    large-table one otherwise; their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return lut_gather(table.contiguous(), idx.contiguous())

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return lut_gather_bwd(g.contiguous(), idx, ctx.n), None


# ---------------------------------------------------------------------------
# Plain versions (the CPU's, and the card's reference)
# ---------------------------------------------------------------------------


def lut_gather_plain(table, idx):
    """out[i] = table[idx[i]]."""
    return table[idx]


def lut_gather_bwd_plain(g, idx, n):
    """d_table[r] = the sum of g[i] over the lanes with idx[i] == r: what
    the autograd of table[idx] computes (a serial sum per row on the
    card)."""
    return g.new_zeros((n,) + tuple(g.shape[1:])).index_put_(
        (idx,), g, accumulate=True)


def _large(g, n):
    """Whether the backward of an (n,) or (n, C) table's look-up (g: the
    cotangent) takes the large-table kernel: more than AUTO_LUT_ROWS rows,
    or rows wider than the small-table kernel takes."""
    return n > AUTO_LUT_ROWS or (g.dim() > 1 and g.shape[1] > SMALL_MAX_WIDTH)


def lut_gather(table, idx):
    """The forward look-up: the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if table.device.type == "cuda":
        return lut_gather_cuda(table, idx)
    if table.device.type == "cpu":
        return lut_gather_plain(table, idx)
    raise ValueError(f"no look-up path for device {table.device}")


def lut_gather_bwd(g, idx, n):
    """The backward look-up: a kernel on CUDA tensors (by the table's
    shape), the plain version on CPU tensors."""
    if g.device.type == "cuda":
        if _large(g, n):
            return lut_gather_large_bwd_cuda(g, idx, n)
        return lut_gather_bwd_cuda(g, idx, n)
    if g.device.type == "cpu":
        return lut_gather_bwd_plain(g, idx, n)
    raise ValueError(f"no look-up path for device {g.device}")


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_lib():
    lib = cuda_build.load("small_lut")
    if lib.nart_lut_gather.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.nart_lut_gather.argtypes = [p, p, i64, i64, i, p, p]
        lib.nart_lut_gather.restype = ctypes.c_int
        lib.nart_lut_gather_bwd.argtypes = [p, p, i64, i64, i, p, p, p]
        lib.nart_lut_gather_bwd.restype = ctypes.c_int
        lib.nart_lut_bwd_scratch.argtypes = [i64, i64, i]
        lib.nart_lut_bwd_scratch.restype = ctypes.c_int64
    return lib


def _large_kernel_lib():
    lib = cuda_build.load("large_lut")
    if lib.nart_lut_large_bwd.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.nart_lut_large_bwd.argtypes = [p, p, p, i64, i64, i, p, p, p]
        lib.nart_lut_large_bwd.restype = ctypes.c_int
        lib.nart_lut_large_bwd_scratch.argtypes = [i64, i]
        lib.nart_lut_large_bwd_scratch.restype = ctypes.c_int64
    return lib


def _width(name, x, max_width=SMALL_MAX_WIDTH):
    """C of a contiguous float32 CUDA tensor (n,) or (n, C),
    1 <= C <= max_width."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {x.device})")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32 (got {x.dtype})")
    if x.dim() not in (1, 2) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (n,) or (n, C) "
                         f"tensor (got {tuple(x.shape)})")
    c = 1 if x.dim() == 1 else x.shape[1]
    if not 1 <= c <= max_width:
        raise ValueError(f"{name}: rows of {c} values (the kernels take "
                         f"1 to {max_width})")
    return c


def _check_idx(idx, n_lanes, like):
    if not (idx.is_cuda and idx.dtype == torch.int64 and idx.dim() == 1
            and idx.is_contiguous()):
        raise ValueError("idx must be a contiguous (N,) int64 CUDA tensor")
    if idx.device != like.device:
        raise ValueError("idx and the table must be on one device")
    if n_lanes is not None and idx.shape[0] != n_lanes:
        raise ValueError(f"idx has {idx.shape[0]} lanes, g {n_lanes}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def lut_gather_cuda(table, idx):
    """Launch nart_lut_gather: (n,) or (n, C) float32 table (C <= 8, any
    n), (N,) int64 idx -> (N,) or (N, C)."""
    c = _width("table", table, MAX_WIDTH)
    _check_idx(idx, None, table)
    n, lanes = table.shape[0], idx.shape[0]
    if n < 1:
        raise ValueError("the table has no rows")
    out = torch.empty((lanes,) + tuple(table.shape[1:]), dtype=torch.float32,
                      device=table.device)
    if lanes == 0:
        return out
    rc = _kernel_lib().nart_lut_gather(table.data_ptr(), idx.data_ptr(),
                                       lanes, n, c, out.data_ptr(),
                                       _stream(table))
    if rc != 0:
        raise RuntimeError(f"nart_lut_gather launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather")
    return out


def lut_gather_bwd_cuda(g, idx, n):
    """Launch nart_lut_gather_bwd: (N,) or (N, C) float32 g, (N,) int64
    idx -> (n,) or (n, C), the per-row sums.  Its scratch comes from the
    caching allocator (inside a capture, from the graph's pool)."""
    c = _width("g", g)
    _check_idx(idx, g.shape[0], g)
    if n < 1:
        raise ValueError("the table has no rows")
    lanes = g.shape[0]
    if lanes == 0:
        return g.new_zeros((n,) + tuple(g.shape[1:]))
    lib = _kernel_lib()
    partial = torch.empty(lib.nart_lut_bwd_scratch(lanes, n, c),
                          dtype=torch.float32, device=g.device)
    d_table = torch.empty((n,) + tuple(g.shape[1:]), dtype=torch.float32,
                          device=g.device)
    rc = lib.nart_lut_gather_bwd(g.data_ptr(), idx.data_ptr(), lanes, n, c,
                                 partial.data_ptr(), d_table.data_ptr(),
                                 _stream(g))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_gather_bwd launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather_bwd")
    return d_table


def lut_gather_large_bwd_cuda(g, idx, n):
    """Launch nart_lut_large_bwd: (N,) or (N, C) float32 g (C <= 8), (N,)
    int64 idx -> (n,) or (n, C), the per-row sums.  The lanes are first
    ordered by row with a stable torch.sort of the clamped rows as int32
    (the permutation PyTorch's own backward sorts by).  The sort's outputs
    and the kernels' scratch come from the caching allocator (inside a
    capture, from the graph's pool); nothing is read on the host."""
    c = _width("g", g, MAX_WIDTH)
    _check_idx(idx, g.shape[0], g)
    if not 1 <= n < 2**31:
        raise ValueError(f"the table has {n} rows (the kernels take 1 to "
                         "2^31 - 1)")
    lanes = g.shape[0]
    if lanes == 0:
        return g.new_zeros((n,) + tuple(g.shape[1:]))
    lib = _large_kernel_lib()
    keys, perm = torch.sort(idx.clamp(0, n - 1).to(torch.int32), stable=True)
    scratch = torch.empty(lib.nart_lut_large_bwd_scratch(lanes, c),
                          dtype=torch.float32, device=g.device)
    d_table = torch.empty((n,) + tuple(g.shape[1:]), dtype=torch.float32,
                          device=g.device)
    rc = lib.nart_lut_large_bwd(g.data_ptr(), keys.data_ptr(),
                                perm.data_ptr(), lanes, n, c,
                                scratch.data_ptr(), d_table.data_ptr(),
                                _stream(g))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_large_bwd launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather_large_bwd")
    return d_table

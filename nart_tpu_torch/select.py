"""Table look-ups: per-lane rows of float tables, differentiable.

Counterpart of ``nart_tpu/select.py``.  There a look-up into a small
table (per-mesh materials, the packed light rows, a texture of a few
texels) is a one-hot product: a handful of vector operations on a TPU,
where a gather is a scalar loop, and it differentiates cleanly, its
transpose ``ohf.T @ g`` being the scatter-add that the gather's backward
needs: a dense reduction over the lanes.  Tables of more than 64 rows
(its ``auto_lut``) are plain gathers there, as are the texture table and
the medium's density cells, whose backward is XLA's scatter-add.

Here the float tables of one look-up, ``small_lut(idx, n)(a, b, ...)``,
are read by one application of the autograd Function ``_LutGather`` on
every device.  On CUDA tensors its forward is csrc/small_lut.cu's
``nart_lut_gather_many``: up to MAX_TABLES tables in one launch (the
rows, the plain gather's bits; rows of 1 to 8 values, any row count),
counted in ``cuda_build.launch_counts`` as "lut_gather".  Its backward
sorts the tables that need a gradient by shape.  Those of up to
AUTO_LUT_ROWS rows of up to 4 values (S1) go together to
``lut_gather_bwd_many``, on the card one cooperative launch of
``nart_lut_gather_bwd_many`` for all of them (one graph node), counted as
"lut_gather_bwd": 512-lane blocks of 8 warps sum each row's lanes (a
shuffle tree over each warp's group of 32, added to the warp's slot, the
warps added 0..7 into the block's partial); after a grid-wide barrier the
blocks sum the partials (lane l the blocks l, l + 32, ..., then a shuffle
tree): a fixed order, the same bits every run, no float atomics, the bits
of the two-launch route it replaced, ``nart_lut_gather_bwd``, which stays
as the reference (``lut_gather_bwd_cuda``, counted as
"lut_gather_bwd_reference"; no path calls it).  The kernel's limits are
read from the library at its first load and must be this module's
(MAX_TABLES, AUTO_LUT_ROWS, SMALL_MAX_WIDTH).
The others (S2: the env map, the texture table, the light atlas, the
density cells, whose rows hold 8 values) take csrc/large_lut.cu's
``nart_lut_large_bwd`` one table at a time (a stable radix sort of the
lanes by the rows' own bits, then a segmented sum over the sorted lanes
in a fixed order), counted as "lut_gather_large_bwd".  Inside a CUDA
graph capture a launch counts at every replay.  PyTorch's own backward of
``table[idx]`` on the card is a sorted ``index_put_(accumulate=True)``
that walks every run of equal indices serially, and the runs are tens of
thousands of lanes long.  On CPU tensors the Function runs the plain
versions, ``table[idx]`` and that ``index_put_`` a table: the bits of
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
MAX_TABLES = 16  # tables one launch reads (small_lut.cu kMaxTables)
LARGE_MAX_LANES = 2**30 - 1  # the large-table backward's lanes (large_lut.cu)


def small_lut(idx, n):
    """Row look-ups into (n, ...) tables for the per-lane index idx, clamped
    to [0, n - 1] as the JAX package's clip (and a gather) clamps, for any
    n: the counterpart of both the JAX package's small_lut and its auto_lut
    (whose plain gather above 64 rows is the same function).  Returns
    lut(*tables): each (n,) table -> (N,), (n, C) -> (N, C); one table
    gives its rows, several a tuple.  The float tables of one call are
    read by one look-up (one launch on the card, MAX_TABLES at a time)."""
    ci = idx.long().clamp(0, n - 1)

    def lut(*tables):
        floats = [t for t in tables if t.is_floating_point()]
        rows = iter([out for k in range(0, len(floats), MAX_TABLES)
                     for out in _LutGather.apply(
                         *floats[k:k + MAX_TABLES], ci)])
        outs = tuple(next(rows) if t.is_floating_point() else t[ci]
                     for t in tables)
        return outs[0] if len(outs) == 1 else outs

    return lut



class _LutGather(torch.autograd.Function):
    """(table[idx] for table in tables) for float tables and an in-range
    int64 idx (the last argument): on the card (float32 only) one
    many-table look-up kernel; the backward one many-table launch for the
    tables of up to AUTO_LUT_ROWS rows of up to SMALL_MAX_WIDTH values and
    one large-table launch for each of the others; their plain versions on
    the CPU.  The rows of a table that needs no gradient need none either
    (marked so: else one trainable table among the read ones would make
    autograd trace, and the backward differentiate, everything computed
    from the others), and a table whose rows no gradient reaches gets
    none."""

    @staticmethod
    def forward(ctx, *args):
        *tables, idx = args
        ctx.save_for_backward(idx)
        ctx.rows = [t.shape[0] for t in tables]
        ctx.set_materialize_grads(False)
        outs = tuple(lut_gather_many([t.contiguous() for t in tables],
                                     idx.contiguous()))
        ctx.mark_non_differentiable(*[
            o for o, need in zip(outs, ctx.needs_input_grad) if not need])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        want = [k for k, (g, need) in enumerate(zip(grads,
                                                     ctx.needs_input_grad))
                if g is not None and need]
        small = [k for k in want if not _large(grads[k], ctx.rows[k])]
        out = [None] * (len(grads) + 1)
        if small:
            sums = lut_gather_bwd_many([grads[k].contiguous() for k in small],
                                       idx, [ctx.rows[k] for k in small])
            for k, d in zip(small, sums):
                out[k] = d
        for k in want:
            if out[k] is None:
                out[k] = lut_gather_bwd(grads[k].contiguous(), idx,
                                        ctx.rows[k])
        return tuple(out)


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


RADIX_TILE = 1024  # lanes a radix block ranks (large_lut.cu kTile)


def radix_schedule(n):
    """(B, P, D): the bits of the rows 0 .. n - 1 (at least 1, at most 31),
    the radix passes of at most 8 bits, and the bits of each pass (the
    last takes the rest), as large_lut.cu's schedule_of."""
    bits = min(max(1, (n - 1).bit_length()), 31)
    passes = -(-bits // 8)
    return bits, passes, -(-bits // passes)


def radix_order_plain(idx, n):
    """(keys, lanes): idx's rows clamped to [0, n - 1] as int32, sorted
    stably, and the lane of each sorted position as int32, by the passes
    of nart_lut_large_bwd's radix sort and its counting ranks: a lane's
    place in a pass is the digit's global offset, plus the digit's count in
    the earlier tiles of RADIX_TILE lanes (the look-back), in the earlier
    warps of its tile, and in the earlier lanes of its warp.  The same
    permutation as torch.sort(stable=True)."""
    keys = idx.clamp(0, n - 1).to(torch.int32)
    lanes = torch.arange(keys.shape[0], dtype=torch.int32,
                         device=keys.device)
    bits, passes, width = radix_schedule(n)
    n_pad = -(-keys.shape[0] // RADIX_TILE) * RADIX_TILE
    tiles = n_pad // RADIX_TILE
    for p in range(passes):
        bins = 1 << min(width, bits - p * width)
        d = (keys.long() >> (p * width)) & (bins - 1)
        # past the end: a bin of its own, after the others
        dw = torch.full((n_pad,), bins, dtype=torch.long,
                        device=keys.device)
        dw[:d.shape[0]] = d
        dw = dw.view(tiles, RADIX_TILE // 32, 32)
        earlier = torch.ones(32, 32, dtype=torch.bool,
                             device=keys.device).tril(-1)
        rank = ((dw[..., :, None] == dw[..., None, :]) & earlier).sum(-1)
        warp_hist = torch.zeros(tiles * (RADIX_TILE // 32) * (bins + 1),
                                dtype=torch.long, device=keys.device)
        cell = (torch.arange(tiles * (RADIX_TILE // 32), device=keys.device)
                .view(tiles, -1, 1) * (bins + 1) + dw)
        warp_hist.index_add_(0, cell.reshape(-1),
                             torch.ones_like(cell).reshape(-1))
        warp_hist = warp_hist.view(tiles, RADIX_TILE // 32, bins + 1)
        warp_before = warp_hist.cumsum(1) - warp_hist
        tile_hist = warp_hist.sum(1)
        tile_before = tile_hist.cumsum(0) - tile_hist
        total = tile_hist.sum(0)
        base = total.cumsum(0) - total
        t_i = torch.arange(tiles, device=keys.device).view(-1, 1, 1)
        w_i = torch.arange(RADIX_TILE // 32, device=keys.device).view(1, -1, 1)
        pos = (base[dw] + tile_before[t_i, dw] + warp_before[t_i, w_i, dw]
               + rank).reshape(-1)[:keys.shape[0]]
        keys = torch.empty_like(keys).index_copy_(0, pos, keys)
        lanes = torch.empty_like(lanes).index_copy_(0, pos, lanes)
    return keys, lanes


def _large(g, n):
    """Whether the backward of an (n,) or (n, C) table's look-up (g: the
    cotangent) takes the large-table kernel: more than AUTO_LUT_ROWS rows,
    or rows wider than the small-table kernel takes."""
    return n > AUTO_LUT_ROWS or (g.dim() > 1 and g.shape[1] > SMALL_MAX_WIDTH)


def lut_gather_many(tables, idx):
    """The forward look-up of several tables by one idx: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    dev = idx.device
    if dev.type == "cuda":
        return lut_gather_many_cuda(tables, idx)
    if dev.type == "cpu":
        return [lut_gather_plain(t, idx) for t in tables]
    raise ValueError(f"no look-up path for device {dev}")


def lut_gather(table, idx):
    """The forward look-up of one table (lut_gather_many of one)."""
    return lut_gather_many([table], idx)[0]


def lut_gather_bwd(g, idx, n):
    """The backward look-up of one table: the large-table kernel on CUDA
    tensors, or lut_gather_bwd_many of one for a small table; the plain
    version on CPU tensors."""
    if not _large(g, n):
        return lut_gather_bwd_many([g], idx, [n])[0]
    if g.device.type == "cuda":
        return lut_gather_large_bwd_cuda(g, idx, n)
    if g.device.type == "cpu":
        return lut_gather_bwd_plain(g, idx, n)
    raise ValueError(f"no look-up path for device {g.device}")


def _check_small(grads, rows):
    """What the many-table backward takes: 1 to MAX_TABLES cotangents (N,)
    or (N, C), C <= SMALL_MAX_WIDTH, of tables of 1 to AUTO_LUT_ROWS rows."""
    if not 1 <= len(grads) <= MAX_TABLES or len(rows) != len(grads):
        raise ValueError(f"{len(grads)} tables, {len(rows)} row counts (one "
                         f"launch sums 1 to {MAX_TABLES})")
    for j, (g, n) in enumerate(zip(grads, rows)):
        c = 1 if g.dim() == 1 else g.shape[-1]
        if g.dim() not in (1, 2) or not 1 <= c <= SMALL_MAX_WIDTH:
            raise ValueError(f"grads[{j}]: shape {tuple(g.shape)} (the "
                             f"kernel takes rows of 1 to {SMALL_MAX_WIDTH} "
                             "values)")
        if not 1 <= n <= AUTO_LUT_ROWS:
            raise ValueError(f"grads[{j}]: a table of {n} rows (the kernel "
                             f"takes 1 to {AUTO_LUT_ROWS})")


def lut_gather_bwd_many(grads, idx, rows):
    """The backward look-up of a look-up's small tables, each (rows[k],) or
    (rows[k], C_k) read by idx (g_k its cotangent): one launch of the
    many-table kernel on CUDA tensors, the plain version a table on CPU
    tensors.  Refuses what the kernel does not take on every device (on
    the card, the kernel's wrapper checks)."""
    if idx.device.type == "cuda":
        return lut_gather_bwd_many_cuda(grads, idx, rows)
    _check_small(grads, rows)
    if idx.device.type == "cpu":
        return [lut_gather_bwd_plain(g, idx, n) for g, n in zip(grads, rows)]
    raise ValueError(f"no look-up path for device {idx.device}")


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _kernel_lib():
    lib = cuda_build.load("small_lut")
    if lib.nart_lut_gather_many.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.nart_lut_gather_many.argtypes = [p, p, p, p, i, p, i64, p]
        lib.nart_lut_gather_many.restype = ctypes.c_int
        lib.nart_lut_gather_bwd.argtypes = [p, p, i64, i64, i, p, p, p]
        lib.nart_lut_gather_bwd.restype = ctypes.c_int
        lib.nart_lut_bwd_scratch.argtypes = [i64, i64, i]
        lib.nart_lut_bwd_scratch.restype = ctypes.c_int64
        lib.nart_lut_gather_bwd_many.argtypes = [p, p, p, p, i, p, i64, p, i,
                                                 p]
        lib.nart_lut_gather_bwd_many.restype = ctypes.c_int
        lib.nart_lut_bwd_many_scratch.argtypes = [i64, i64]
        lib.nart_lut_bwd_many_scratch.restype = ctypes.c_int64
        limits = [ctypes.c_int() for _ in range(3)]
        lib.nart_lut_bwd_many_limits.argtypes = [p, p, p]
        lib.nart_lut_bwd_many_limits.restype = None
        lib.nart_lut_bwd_many_limits(*[ctypes.byref(x) for x in limits])
        got = tuple(x.value for x in limits)
        want = (MAX_TABLES, AUTO_LUT_ROWS, SMALL_MAX_WIDTH)
        if got != want:
            raise RuntimeError(
                f"nart_lut_gather_bwd_many takes (tables, rows, width) {got}, "
                f"select.py routes {want} to it")
    return lib


def _large_kernel_lib():
    lib = cuda_build.load("large_lut")
    if lib.nart_lut_large_bwd.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.nart_lut_large_bwd.argtypes = [p, p, i64, i64, i, p, p, p]
        lib.nart_lut_large_bwd.restype = ctypes.c_int
        lib.nart_lut_large_bwd_scratch.argtypes = [i64, i64, i]
        lib.nart_lut_large_bwd_scratch.restype = ctypes.c_int64
        lib.nart_lut_large_bwd_order.argtypes = [i64, i64, i, p]
        lib.nart_lut_large_bwd_order.restype = None
        lib.nart_lut_large_bwd_sorted.argtypes = [p, p, p, i64, i64, i, p, p,
                                                  p]
        lib.nart_lut_large_bwd_sorted.restype = ctypes.c_int
        lib.nart_lut_large_bwd_sorted_scratch.argtypes = [i64, i]
        lib.nart_lut_large_bwd_sorted_scratch.restype = ctypes.c_int64
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


def lut_gather_many_cuda(tables, idx):
    """Launch nart_lut_gather_many: 1 to MAX_TABLES (n_k,) or (n_k, C_k)
    float32 tables (C_k <= 8, any n_k) on idx's card, (N,) int64 idx ->
    a list of (N,) or (N, C_k), table_k's rows at idx clamped to
    [0, n_k - 1].  The tables' and outputs' pointers go to the kernel by
    value: nothing is copied to the card."""
    k = len(tables)
    if not 1 <= k <= MAX_TABLES:
        raise ValueError(f"{k} tables (one launch reads 1 to {MAX_TABLES})")
    _check_idx(idx, None, idx)
    for j, t in enumerate(tables):
        if t.device != idx.device:
            raise ValueError(f"tables[{j}] is on {t.device}, idx on "
                             f"{idx.device}")
    widths = [_width(f"tables[{j}]", t, MAX_WIDTH)
              for j, t in enumerate(tables)]
    if any(t.shape[0] < 1 for t in tables):
        raise ValueError("a table has no rows")
    lanes = idx.shape[0]
    outs = [torch.empty((lanes,) + tuple(t.shape[1:]), dtype=torch.float32,
                        device=idx.device) for t in tables]
    if lanes == 0:
        return outs
    ptrs = ctypes.c_void_p * k
    rc = _kernel_lib().nart_lut_gather_many(
        ptrs(*[t.data_ptr() for t in tables]),
        ptrs(*[o.data_ptr() for o in outs]),
        (ctypes.c_int64 * k)(*[t.shape[0] for t in tables]),
        (ctypes.c_int * k)(*widths), k, idx.data_ptr(), lanes, _stream(idx))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_gather_many launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather")
    return outs


def lut_gather_cuda(table, idx):
    """nart_lut_gather_many of one table: (n,) or (n, C) -> (N,) or
    (N, C)."""
    return lut_gather_many_cuda([table], idx)[0]


def lut_gather_bwd_many_cuda(grads, idx, rows):
    """Launch nart_lut_gather_bwd_many: 1 to MAX_TABLES (N,) or (N, C_k)
    contiguous float32 cotangents (C_k <= SMALL_MAX_WIDTH) of tables of
    rows[k] <= AUTO_LUT_ROWS rows, (N,) int64 idx, all on one card -> a
    list of (rows[k],) or (rows[k], C_k), the per-row sums, in one
    cooperative launch (one kernel node), counted as "lut_gather_bwd".  The
    pointers, rows and widths go by value; the scratch comes from the
    caching allocator (inside a capture, from the graph's pool)."""
    _check_idx(idx, None, idx)
    k, lanes, device = len(grads), idx.shape[0], idx.device
    if not 1 <= k <= MAX_TABLES or len(rows) != k:
        raise ValueError(f"{k} tables, {len(rows)} row counts (one launch "
                         f"sums 1 to {MAX_TABLES})")
    widths, outs = [], []
    for j, (g, n) in enumerate(zip(grads, rows)):
        shape = g.shape
        if g.device != device or shape[0] != lanes:
            raise ValueError(f"grads[{j}]: {tuple(shape)} on {g.device}, "
                             f"idx {(lanes,)} on {device}")
        c = _width(f"grads[{j}]", g)
        if not 1 <= n <= AUTO_LUT_ROWS:
            raise ValueError(f"grads[{j}]: a table of {n} rows (the kernel "
                             f"takes 1 to {AUTO_LUT_ROWS})")
        widths.append(c)
        outs.append(torch.empty((n,) + shape[1:], dtype=torch.float32,
                                device=device))
    if lanes == 0:
        return [o.zero_() for o in outs]
    lib = _kernel_lib()
    total = sum(n * c for n, c in zip(rows, widths))
    scratch = torch.empty(lib.nart_lut_bwd_many_scratch(lanes, total),
                          dtype=torch.float32, device=device)
    ptrs = ctypes.c_void_p * k
    rc = lib.nart_lut_gather_bwd_many(
        ptrs(*[g.data_ptr() for g in grads]),
        ptrs(*[o.data_ptr() for o in outs]),
        (ctypes.c_int64 * k)(*rows), (ctypes.c_int * k)(*widths), k,
        idx.data_ptr(), lanes, scratch.data_ptr(), device.index,
        _stream(idx))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_gather_bwd_many launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather_bwd")
    return outs


def lut_gather_bwd_cuda(g, idx, n):
    """Launch nart_lut_gather_bwd, the two-launch route of one table: (N,)
    or (N, C) float32 g (C <= 4, any n), (N,) int64 idx -> (n,) or (n, C),
    the per-row sums.  The reference the many-table kernel is held to (the
    same bits); no path calls it, and its launches count as
    "lut_gather_bwd_reference".  Its scratch comes from the caching
    allocator (inside a capture, from the graph's pool)."""
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
    cuda_build.count_launch("lut_gather_bwd_reference")
    return d_table


def _check_large(g, idx, n):
    c = _width("g", g, MAX_WIDTH)
    _check_idx(idx, g.shape[0], g)
    if not 1 <= n < 2**31:
        raise ValueError(f"the table has {n} rows (the kernels take 1 to "
                         "2^31 - 1)")
    return c


def lut_gather_large_bwd_cuda(g, idx, n):
    """Launch nart_lut_large_bwd: (N,) or (N, C) float32 g (C <= 8), (N,)
    int64 idx (clamped to [0, n - 1] by the kernel) -> (n,) or (n, C), the
    per-row sums: a stable radix sort of the lanes by row, then a
    fixed-order segmented sum, in 1 + radix_schedule(n)[1] graph nodes (a
    memset, a launch a radix pass).
    Its scratch comes from the caching allocator (inside a capture, from
    the graph's pool); nothing is read on the host."""
    c = _check_large(g, idx, n)
    if g.shape[0] == 0:
        return g.new_zeros((n,) + tuple(g.shape[1:]))
    return _large_bwd_launch(g, idx, n, c)[0]


def _large_bwd_launch(g, idx, n, c):
    lanes = g.shape[0]
    if lanes > LARGE_MAX_LANES:
        raise ValueError(f"{lanes} lanes (the kernel takes up to "
                         f"{LARGE_MAX_LANES})")
    lib = _large_kernel_lib()
    scratch = torch.empty(lib.nart_lut_large_bwd_scratch(lanes, n, c),
                          dtype=torch.int32, device=g.device)
    d_table = torch.empty((n,) + tuple(g.shape[1:]), dtype=torch.float32,
                          device=g.device)
    rc = lib.nart_lut_large_bwd(g.data_ptr(), idx.data_ptr(), lanes, n, c,
                                scratch.data_ptr(), d_table.data_ptr(),
                                _stream(g))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_large_bwd launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather_large_bwd")
    return d_table, scratch


def lut_gather_large_bwd_order_cuda(g, idx, n):
    """lut_gather_large_bwd_cuda, and the order its radix sort left in its
    scratch: (d_table, keys, lanes), keys the sorted clamped rows and lanes
    the lane of each sorted position (int32; radix_order_plain's and
    torch.sort(stable=True)'s)."""
    c = _check_large(g, idx, n)
    lanes = g.shape[0]
    if lanes == 0:
        raise ValueError("no lanes to sort")
    d_table, scratch = _large_bwd_launch(g, idx, n, c)
    at = (ctypes.c_int64 * 2)()
    _large_kernel_lib().nart_lut_large_bwd_order(lanes, n, c, at)
    return (d_table, scratch[at[0]:at[0] + lanes],
            scratch[at[1]:at[1] + lanes])


def lut_gather_large_bwd_sorted_cuda(g, keys, perm, n):
    """Launch nart_lut_large_bwd_sorted: the same sums given the lanes'
    clamped rows sorted stably, keys (N,) int32, and the permutation, perm
    (N,) int64 (torch.sort(stable=True)'s): the route before the radix
    sort, the reference nart_lut_large_bwd is held to.  No path calls it;
    its launches count as "lut_gather_large_bwd"."""
    c = _check_large(g, perm, n)
    if not (keys.is_cuda and keys.dtype == torch.int32
            and keys.shape == perm.shape and keys.is_contiguous()
            and keys.device == g.device):
        raise ValueError("keys must be a contiguous (N,) int32 tensor on g's "
                         "card")
    lanes = g.shape[0]
    if lanes == 0:
        return g.new_zeros((n,) + tuple(g.shape[1:]))
    lib = _large_kernel_lib()
    scratch = torch.empty(lib.nart_lut_large_bwd_sorted_scratch(lanes, c),
                          dtype=torch.float32, device=g.device)
    d_table = torch.empty((n,) + tuple(g.shape[1:]), dtype=torch.float32,
                          device=g.device)
    rc = lib.nart_lut_large_bwd_sorted(g.data_ptr(), keys.data_ptr(),
                                       perm.data_ptr(), lanes, n, c,
                                       scratch.data_ptr(), d_table.data_ptr(),
                                       _stream(g))
    if rc != 0:
        raise RuntimeError(
            f"nart_lut_large_bwd_sorted launch failed: CUDA error {rc}")
    cuda_build.count_launch("lut_gather_large_bwd")
    return d_table

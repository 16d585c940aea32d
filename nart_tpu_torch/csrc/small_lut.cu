// Table look-ups: per-lane row reads of float32 tables, and, for tables
// of a few rows, the backward, the per-row sums of the lanes' cotangents.
// nart_tpu_torch/select.py binds the entries:
//   * nart_lut_gather_many      out_k[i, :] = table_k[clamp(idx[i], 0,
//                               n_k - 1), :] for up to 16 tables k read by
//                               one idx, in one launch: every float table,
//                               any n, rows of C = 1 to 8 values (its cost
//                               does not depend on n); one table is k = 1
//   * nart_lut_gather_bwd_many  d_k[r, :] = the sum of g_k[i, :] over the
//                               lanes i with clamp(idx[i], 0, n_k - 1) == r,
//                               for up to 16 tables k read by one idx, in
//                               one launch, tables of n_k <= 64 rows of
//                               C_k = 1 to 4 values (select.py's S1; the
//                               others' backward is csrc/large_lut.cu's)
//   * nart_lut_gather_bwd       one table's d_table in two launches: the
//                               route before the many-table one, kept as
//                               the reference it is held to (same bits)
//
// They stand for the JAX package's one-hot look-up, which has no Pallas
// kernel: nart_tpu/select.py:59 small_lut and nart_tpu/materials.py:96
// mesh_luts.  There the forward is ohf @ table and the backward its
// transpose ohf.T @ g, a dense reduction over the lanes.  The forward also
// stands for XLA's gather behind the JAX package's plain gathers of its
// large tables (nart_tpu/materials.py:60, nart_tpu/lights.py:73,
// nart_tpu/media.py:81).  The port's plain version, table[idx] under
// autograd, differentiates through PyTorch's sorted
// index_put_(accumulate=True), whose indexing_backward kernel walks every
// run of equal indices serially: 65,536 lanes on 3-4 mesh rows, or 131,072
// on one light row, are runs tens of thousands of steps long.
//
// What bounds the forward on an H100: not bytes but launches.  It reads
// idx (8 B a lane) and 4C B of each table a lane, and writes 4C B a lane:
// at N = 65,536 and C = 3 about 1.3 MB, 0.4 us at 3.35 TB/s, far below one
// launch's cost in a CUDA graph (a few us).  A path round reads several
// tables by one index (make_bsdf's per-mesh constants, 5 to 9 fields of
// the packed light rows), and one launch a table read idx again each time
// and paid a launch each time.  So one launch reads all of them: the
// tables' pointers, row counts and widths, and the outputs' pointers, go
// by value in the kernel's parameter struct (a device array built on the
// host would be a host-to-device copy inside the round); a block loads
// 256 lanes' idx into shared memory once, then writes each table's rows
// for those lanes with one thread a (lane, value), so that neighbouring
// threads store neighbouring floats; rows of 4 or 8 floats on 16-byte
// aligned tables move as float4.  It is an exact copy: the plain
// version's bits.
//
// The backward's bytes are as few (idx and each g_k, 8 + 4 sum(C_k) B a
// lane, and the (n_k, C_k) tables): it is bound by launches and by the
// dependent steps of its sums, so it too reads all of a look-up's tables
// in one launch, their pointers, row counts and widths by value.  No
// float atomics: graphed and per-round replays, repeated shards, must give
// the same bits, those of the two-launch route, whose order it keeps.  A
// block sums a fixed range of kLanesPerBlock lanes with 8 warps, warp w
// the groups of 32 lanes w and w + 8.  A group's lanes are split by row (a
// ballot on the first pending lane's row), and each of the row's values
// is summed over the 32 lanes by a shuffle tree (the other lanes add 0)
// and added to the warp's own slot of that value in shared memory (sized
// to the tables' own sum of n_k C_k values).  The block sums its warps'
// slots in warp order 0..7 into its partial, one column of the scratch
// (sum n_k C_k, n_blocks).  Output j's final sum: lane l adds the partials
// of blocks l, l + 32, ... in order, then a shuffle tree.  Where the
// two-launch route ran a tree at a time, this kernel runs the trees of up
// to 16 values (all of a look-up's tables of one row count) at once, one
// shuffle serving two trees at each level (butterfly), and a warp takes
// its two groups' rows together: every add still has the same two
// operands (see butterfly and pass_sums).
//
// The cross-block sum is in the same launch: the launch is cooperative
// (every block resident at once; a block takes ranges b, b + gridDim.x,
// ... where the lanes need more blocks than fit) and its blocks meet at a
// grid-wide barrier, then share the outputs' sums.  It needs no zeroed
// counter, so a look-up's small-table backward is one kernel node in a
// CUDA graph, and it reads nothing on the host.  The grid's cap (the
// card's SMs times the blocks an SM holds) is asked of the runtime once a
// card and size of the warps' slots, not at every launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 64;        // table rows a two-launch block sums
constexpr int kLanesPerBlock = 512;  // lanes a backward block reads
constexpr int kGatherThreads = 256;  // lanes (and threads) a forward block
constexpr int kMaxTables = 16;       // tables one launch reads
constexpr int kMaxRows = 64;         // rows of a many-table backward's table
constexpr int kMaxBwdWidth = 4;      // and values in a row
constexpr int kMaxCols = kMaxTables * kMaxBwdWidth;  // a launch's columns
constexpr int kPassCols = 16;        // columns whose trees run together
// passes: a pass for each row count, and one for each 16 more columns
constexpr int kMaxPasses = kMaxTables + kMaxCols / kPassCols;
constexpr int kFinalOuts = 8;        // outputs a warp sums at once
constexpr int kFinalUnroll = 4;      // and the ranges a lane loads at once
// the warps' slots of a many-table backward: at most 128 KB
constexpr int kMaxSlotBytes =
    (int)sizeof(float) * kWarps * kMaxTables * kMaxRows * kMaxBwdWidth;
constexpr int kMaxDevices = 64;      // cards whose grid caps are kept
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t n) {
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(kFull, s, off);
  }
  return s;  // the total in lane 0
}

// the tables of one many-table look-up, by value (see the note above)
struct GatherArgs {
  const float* table[kMaxTables];
  float* out[kMaxTables];
  int64_t rows[kMaxTables];
  int width[kMaxTables];
  int vec4[kMaxTables];  // rows of 4 or 8 floats, table and out 16-byte
                         // aligned: copied as float4
  int k;
};

// one table's rows for the block's `lanes` lanes (i0 ...): out[i0 * C + e]
// for e < lanes * C, one thread a float (or a float4)
template <int C>
__device__ __forceinline__ void gather_rows(const float* __restrict__ table,
                                            float* __restrict__ out,
                                            int64_t n, bool vec4,
                                            const int64_t* s_idx, int64_t i0,
                                            int lanes) {
  if constexpr (C % 4 == 0) {
    if (vec4) {
      constexpr int kUnits = C / 4;
      const float4* t4 = reinterpret_cast<const float4*>(table);
      float4* o4 = reinterpret_cast<float4*>(out) + i0 * kUnits;
      for (int u = threadIdx.x; u < lanes * kUnits; u += kGatherThreads) {
        const int li = u / kUnits;
        const int q = u - li * kUnits;
        o4[u] = __ldg(t4 + clamp_row(s_idx[li], n) * kUnits + q);
      }
      return;
    }
  }
  float* o = out + i0 * C;
  for (int e = threadIdx.x; e < lanes * C; e += kGatherThreads) {
    const int li = e / C;
    const int c = e - li * C;
    o[e] = __ldg(table + clamp_row(s_idx[li], n) * C + c);
  }
}

__global__ void __launch_bounds__(kGatherThreads)
    lut_gather_many_kernel(const GatherArgs a,
                           const int64_t* __restrict__ idx, int64_t N) {
  __shared__ int64_t s_idx[kGatherThreads];
  const int64_t i0 = (int64_t)blockIdx.x * kGatherThreads;
  const int lanes = (int)(N - i0 < kGatherThreads ? N - i0 : kGatherThreads);
  if ((int)threadIdx.x < lanes) s_idx[threadIdx.x] = idx[i0 + threadIdx.x];
  __syncthreads();
  for (int k = 0; k < a.k; ++k) {
    const float* t = a.table[k];
    float* o = a.out[k];
    const int64_t n = a.rows[k];
    const bool v = a.vec4[k] != 0;
    switch (a.width[k]) {
      case 1: gather_rows<1>(t, o, n, v, s_idx, i0, lanes); break;
      case 2: gather_rows<2>(t, o, n, v, s_idx, i0, lanes); break;
      case 3: gather_rows<3>(t, o, n, v, s_idx, i0, lanes); break;
      case 4: gather_rows<4>(t, o, n, v, s_idx, i0, lanes); break;
      case 5: gather_rows<5>(t, o, n, v, s_idx, i0, lanes); break;
      case 6: gather_rows<6>(t, o, n, v, s_idx, i0, lanes); break;
      case 7: gather_rows<7>(t, o, n, v, s_idx, i0, lanes); break;
      default: gather_rows<8>(t, o, n, v, s_idx, i0, lanes); break;
    }
  }
}

// the two-launch route of one table (the reference): a block's partial of
// one tile of kRowTile rows, then lut_final_kernel's sums of the partials
template <int C>
__global__ void __launch_bounds__(kThreads)
    lut_partial_kernel(const float* __restrict__ g,
                       const int64_t* __restrict__ idx, int64_t N, int64_t n,
                       float* __restrict__ partial) {
  __shared__ float acc[kWarps][kRowTile * C];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kWarps * kRowTile * C; k += kThreads) {
    (&acc[0][0])[k] = 0.f;
  }
  __syncthreads();
  const int64_t row0 = (int64_t)blockIdx.y * kRowTile;
  const int rows = (int)(n - row0 < kRowTile ? n - row0 : kRowTile);
  const int64_t base = (int64_t)blockIdx.x * kLanesPerBlock;
  for (int grp = warp; grp < kLanesPerBlock / 32; grp += kWarps) {
    const int64_t i = base + grp * 32 + lane;
    int r = -1;  // the lane's row within the tile, -1 outside it
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f;
    if (i < N) {
      const int64_t rr = clamp_row(idx[i], n) - row0;
      if (rr >= 0 && rr < rows) {
        r = (int)rr;
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = g[i * C + c];
      }
    }
    unsigned pending = __ballot_sync(kFull, r >= 0);
    while (pending) {
      const int row = __shfl_sync(kFull, r, __ffs(pending) - 1);
      const bool mine = r == row;
      pending &= ~__ballot_sync(kFull, mine);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float s = warp_sum(mine ? v[c] : 0.f);
        if (lane == 0) acc[warp][row * C + c] += s;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < rows * C; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w][k];
    partial[((int64_t)blockIdx.x * n + row0) * C + k] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    lut_final_kernel(const float* __restrict__ partial, int64_t n_blocks,
                     int64_t width, float* __restrict__ d_table) {
  const int64_t j = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= width) return;  // whole warps leave together
  float s = 0.f;
  for (int64_t b = lane; b < n_blocks; b += 32) s += partial[b * width + j];
  s = warp_sum(s);
  if (lane == 0) d_table[j] = s;
}

// the tables of one many-table backward, by value (as GatherArgs).  Table
// k's n_k C_k sums are values off[k] .. off[k + 1] - 1 of a warp's slots,
// of a block's partial, and of the outputs.  Its C_k values are columns:
// column j (col[j] = 4 k + c) reads the lanes' g[k][i * C_k + c] and sums
// row r into value off[k] + r * C_k + c.  A pass sums up to kPassCols
// columns of tables of one row count together (pass_col0, pass_cols,
// pass_rows): the launcher groups the columns by row count
struct BwdArgs {
  const float* g[kMaxTables];
  float* out[kMaxTables];
  int width[kMaxTables];
  int off[kMaxTables + 1];
  uint8_t col[kMaxCols];
  uint8_t pass_col0[kMaxPasses];
  uint8_t pass_cols[kMaxPasses];
  uint8_t pass_rows[kMaxPasses];
  int n_pass;
  int k;
};

// T (a power of 2) shuffle trees at once: on entry x[t] is this lane's
// term of tree t; on return x[0] holds the total of tree tree_of<T>(lane)
// in every lane.  Each level pairs the registers, and a lane keeps the
// tree whose partner is across the level's offset and sends the other, so
// one shuffle serves two trees; every add is warp_sum's add of the same
// two terms (IEEE addition commutes), so each total has warp_sum's bits
template <int T>
__device__ __forceinline__ void butterfly(float (&x)[T], int lane) {
  int live = T;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (live > 1) {
      const bool hi = (lane & off) != 0;
#pragma unroll
      for (int m = 0; m < T / 2; ++m) {
        if (m < live / 2) {
          const float keep = hi ? x[2 * m + 1] : x[2 * m];
          const float send = hi ? x[2 * m] : x[2 * m + 1];
          x[m] = keep + __shfl_xor_sync(kFull, send, off);
        }
      }
      live /= 2;
    } else {
      x[0] += __shfl_xor_sync(kFull, x[0], off);
    }
  }
}

// the tree whose total butterfly<T> leaves in `lane`: bit j of it is bit
// 4 - j of the lane; the first lane of each tree is the one with the low
// 5 - log2(T) bits clear
template <int T>
__device__ __forceinline__ int tree_of(int lane) {
  int t = 0;
#pragma unroll
  for (int j = 0; (1 << j) < T; ++j) t |= ((lane >> (4 - j)) & 1) << j;
  return t;
}

// one pass's sums over a warp's two groups of 32 lanes (lanes i0 and i1,
// raw rows raw0 and raw1, live if i < N) into the warp's slots, as
// lut_partial_kernel's group loop does for one table: both groups' values
// are loaded first (they do not wait on idx), then a row of each group at
// a time (the rows of the first pending lanes), each column's masked tree
// (the other lanes add 0), added to the row's slot by the lane holding the
// column's total.  The two groups' rows are taken together, so group i1
// may add to a slot before group i0 does: a slot takes at most one add
// from each, onto +0, and (+0 + a) + b is (+0 + b) + a for every float a
// and b (signed zeros included), so the slot has the bits of the
// group-by-group order
template <int T>
__device__ __forceinline__ void pass_sums(const BwdArgs& a, int p,
                                         int64_t raw0, bool live0,
                                         int64_t i0, int64_t raw1,
                                         bool live1, int64_t i1, int lane,
                                         float* slots) {
  const int c0 = a.pass_col0[p];
  const int nc = a.pass_cols[p];
  const int n = a.pass_rows[p];
  float v0[T], v1[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int col = t < nc ? a.col[c0 + t] : 0;
    const float* g = a.g[col >> 2] + (col & 3);
    const int stride = a.width[col >> 2];
    v0[t] = t < nc && live0 ? g[i0 * stride] : 0.f;
    v1[t] = t < nc && live1 ? g[i1 * stride] : 0.f;
  }
  const int r0 = live0 ? (int)clamp_row(raw0, n) : -1;
  const int r1 = live1 ? (int)clamp_row(raw1, n) : -1;
  const int t = tree_of<T>(lane);
  const bool writer = (lane & (32 / T - 1)) == 0 && t < nc;
  // the writer's column: value off[k] + c of row 0, rows C_k apart
  const int col = writer ? a.col[c0 + t] : 0;
  const int base = a.off[col >> 2] + (col & 3);
  const int stride = a.width[col >> 2];
  unsigned pending0 = __ballot_sync(kFull, live0);
  unsigned pending1 = __ballot_sync(kFull, live1);
  while (pending0 | pending1) {
    const int row0 =
        __shfl_sync(kFull, r0, pending0 ? __ffs(pending0) - 1 : 0);
    const int row1 =
        __shfl_sync(kFull, r1, pending1 ? __ffs(pending1) - 1 : 0);
    const bool mine0 = pending0 && r0 == row0;
    const bool mine1 = pending1 && r1 == row1;
    const bool has0 = pending0 != 0;
    const bool has1 = pending1 != 0;
    pending0 &= ~__ballot_sync(kFull, mine0);
    pending1 &= ~__ballot_sync(kFull, mine1);
    float x0[T], x1[T];
#pragma unroll
    for (int q = 0; q < T; ++q) {
      x0[q] = mine0 ? v0[q] : 0.f;
      x1[q] = mine1 ? v1[q] : 0.f;
    }
    butterfly<T>(x0, lane);
    butterfly<T>(x1, lane);
    if (writer) {
      if (has0) slots[base + row0 * stride] += x0[0];
      if (has1) slots[base + row1 * stride] += x1[0];
    }
  }
}

// the partial of the 512-lane range b of every table, as column b of
// partial (sum n_k C_k rows of n_blocks): the warps' slots in acc
// (kWarps x sum n_k C_k floats) zeroed, filled pass by pass (warp w the
// groups w and w + kWarps; a slot belongs to one pass), summed in warp
// order
__device__ __forceinline__ void block_partial(
    const BwdArgs& a, const int64_t* __restrict__ idx, int64_t N, int64_t b,
    int64_t n_blocks, float* acc, float* __restrict__ partial) {
  static_assert(kLanesPerBlock == 2 * 32 * kWarps, "two groups a warp");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int total = a.off[a.k];
  const int64_t i0 = b * kLanesPerBlock + warp * 32 + lane;
  const int64_t i1 = i0 + kWarps * 32;
  const bool live0 = i0 < N;
  const bool live1 = i1 < N;
  const int64_t raw0 = live0 ? idx[i0] : 0;
  const int64_t raw1 = live1 ? idx[i1] : 0;
  for (int e = threadIdx.x; e < kWarps * total; e += kThreads) acc[e] = 0.f;
  __syncthreads();
  float* slots = acc + warp * total;
  for (int p = 0; p < a.n_pass; ++p) {
    const int nc = a.pass_cols[p];
    if (nc > 8) {
      pass_sums<16>(a, p, raw0, live0, i0, raw1, live1, i1, lane, slots);
    } else if (nc > 4) {
      pass_sums<8>(a, p, raw0, live0, i0, raw1, live1, i1, lane, slots);
    } else if (nc > 2) {
      pass_sums<4>(a, p, raw0, live0, i0, raw1, live1, i1, lane, slots);
    } else if (nc > 1) {
      pass_sums<2>(a, p, raw0, live0, i0, raw1, live1, i1, lane, slots);
    } else {
      pass_sums<1>(a, p, raw0, live0, i0, raw1, live1, i1, lane, slots);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * total + e];
    partial[(int64_t)e * n_blocks + b] = s;
  }
  __syncthreads();  // acc is zeroed again for the next range
}

// the outputs j0 .. j0 + kFinalOuts - 1 (of sum n_k C_k) by one warp: for
// each, lane l adds the partials of ranges l, l + 32, ... in order (read
// from L2, where other blocks wrote them, kFinalUnroll ranges at a time),
// then its shuffle tree, as lut_final_kernel
__device__ __forceinline__ void final_sums(const BwdArgs& a,
                                           const float* __restrict__ partial,
                                           int64_t n_blocks, int j0,
                                           int lane) {
  const int total = a.off[a.k];
  float s[kFinalOuts];
#pragma unroll
  for (int u = 0; u < kFinalOuts; ++u) s[u] = 0.f;
  for (int64_t b0 = lane; b0 < n_blocks; b0 += 32 * kFinalUnroll) {
    float v[kFinalOuts][kFinalUnroll];
#pragma unroll
    for (int u = 0; u < kFinalOuts; ++u) {
#pragma unroll
      for (int q = 0; q < kFinalUnroll; ++q) {
        const int64_t b = b0 + 32 * q;
        v[u][q] = j0 + u < total && b < n_blocks
                      ? __ldcg(partial + (int64_t)(j0 + u) * n_blocks + b)
                      : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kFinalOuts; ++u) {
#pragma unroll
      for (int q = 0; q < kFinalUnroll; ++q) {
        if (b0 + 32 * q < n_blocks) s[u] += v[u][q];
      }
    }
  }
  butterfly<kFinalOuts>(s, lane);
  const int u = tree_of<kFinalOuts>(lane);
  const int j = j0 + u;
  if ((lane & (32 / kFinalOuts - 1)) == 0 && j < total) {
    int k = 0;
    while (j >= a.off[k + 1]) ++k;
    a.out[k][j - a.off[k]] = s[0];
  }
}

// block_partial over the ranges blockIdx.x, + gridDim.x, ...; then, after
// a grid-wide barrier (a cooperative launch: at most as many blocks as fit
// the card at once), when every partial is written, the outputs' sums,
// kFinalOuts to a warp, shared over the blocks
__global__ void __launch_bounds__(kThreads)
    lut_bwd_many_kernel(const BwdArgs a, const int64_t* __restrict__ idx,
                        int64_t N, int64_t n_blocks,
                        float* __restrict__ partial) {
  extern __shared__ float acc[];
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    block_partial(a, idx, N, b, n_blocks, acc, partial);
  }
  cooperative_groups::this_grid().sync();
  const int warp = threadIdx.x >> 5;
  for (int j0 = (blockIdx.x * kWarps + warp) * kFinalOuts; j0 < a.off[a.k];
       j0 += gridDim.x * kWarps * kFinalOuts) {
    final_sums(a, partial, n_blocks, j0, threadIdx.x & 31);
  }
}

int64_t n_blocks_of(int64_t N) {
  return (N + kLanesPerBlock - 1) / kLanesPerBlock;
}

// the forward takes rows of up to 8 values, the backward of up to 4
bool bad_args(int64_t N, int64_t n, int C, int max_c) {
  return N <= 0 || n <= 0 || C < 1 || C > max_c;
}

template <int C>
void launch_partial(const float* g, const int64_t* idx, int64_t N, int64_t n,
                    float* partial, cudaStream_t stream) {
  const dim3 grid((unsigned)n_blocks_of(N),
                  (unsigned)((n + kRowTile - 1) / kRowTile));
  lut_partial_kernel<C><<<grid, kThreads, 0, stream>>>(g, idx, N, n,
                                                        partial);
}

}  // namespace

// floats of scratch nart_lut_gather_bwd needs: (n_blocks, n, C)
extern "C" int64_t nart_lut_bwd_scratch(int64_t N, int64_t n, int C) {
  return n_blocks_of(N) * n * C;
}

// tables[k], outs[k], rows[k], widths[k] for k < n_tables; every table
// float32 (rows[k], widths[k]) contiguous, every out (N, widths[k])
extern "C" int nart_lut_gather_many(const float* const* tables,
                                    float* const* outs,
                                    const int64_t* rows, const int* widths,
                                    int n_tables, const int64_t* idx,
                                    int64_t N, cudaStream_t stream) {
  if (N <= 0 || n_tables < 1 || n_tables > kMaxTables) {
    return (int)cudaErrorInvalidValue;
  }
  GatherArgs a;
  a.k = n_tables;
  for (int k = 0; k < n_tables; ++k) {
    if (bad_args(N, rows[k], widths[k], 8)) return (int)cudaErrorInvalidValue;
    a.table[k] = tables[k];
    a.out[k] = outs[k];
    a.rows[k] = rows[k];
    a.width[k] = widths[k];
    a.vec4[k] = widths[k] % 4 == 0 &&
                (reinterpret_cast<uintptr_t>(tables[k]) & 15) == 0 &&
                (reinterpret_cast<uintptr_t>(outs[k]) & 15) == 0;
  }
  const int64_t blocks = (N + kGatherThreads - 1) / kGatherThreads;
  lut_gather_many_kernel<<<(unsigned)blocks, kGatherThreads, 0, stream>>>(
      a, idx, N);
  return (int)cudaGetLastError();
}

extern "C" int nart_lut_gather_bwd(const float* g, const int64_t* idx,
                                   int64_t N, int64_t n, int C,
                                   float* partial, float* d_table,
                                   cudaStream_t stream) {
  if (bad_args(N, n, C, 4)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: launch_partial<1>(g, idx, N, n, partial, stream); break;
    case 2: launch_partial<2>(g, idx, N, n, partial, stream); break;
    case 3: launch_partial<3>(g, idx, N, n, partial, stream); break;
    default: launch_partial<4>(g, idx, N, n, partial, stream); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t width = n * C;
  const int64_t blocks = (width * 32 + kThreads - 1) / kThreads;
  lut_final_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      partial, n_blocks_of(N), width, d_table);
  return (int)cudaGetLastError();
}

namespace {

// BwdArgs of the launchers' arguments, or false where the kernel does not
// take them: the columns grouped by their tables' row count (in the order
// each count first appears), in passes of at most kPassCols
bool bwd_args(const float* const* grads, float* const* outs,
              const int64_t* rows, const int* widths, int n_tables,
              int64_t N, BwdArgs* a) {
  if (N <= 0 || n_tables < 1 || n_tables > kMaxTables) return false;
  a->k = n_tables;
  a->off[0] = 0;
  for (int k = 0; k < n_tables; ++k) {
    if (rows[k] < 1 || rows[k] > kMaxRows || widths[k] < 1 ||
        widths[k] > kMaxBwdWidth) {
      return false;
    }
    a->g[k] = grads[k];
    a->out[k] = outs[k];
    a->width[k] = widths[k];
    a->off[k + 1] = a->off[k] + (int)rows[k] * widths[k];
  }
  bool done[kMaxTables] = {};
  int cols = 0;
  a->n_pass = 0;
  for (int k0 = 0; k0 < n_tables; ++k0) {
    if (done[k0]) continue;
    int in_pass = kPassCols;  // columns in the open pass: none open
    for (int k = k0; k < n_tables; ++k) {
      if (done[k] || rows[k] != rows[k0]) continue;
      done[k] = true;
      for (int c = 0; c < widths[k]; ++c, ++cols, ++in_pass) {
        if (in_pass == kPassCols) {
          a->pass_col0[a->n_pass] = (uint8_t)cols;
          a->pass_cols[a->n_pass] = 0;
          a->pass_rows[a->n_pass] = (uint8_t)rows[k0];
          ++a->n_pass;
          in_pass = 0;
        }
        ++a->pass_cols[a->n_pass - 1];
        a->col[cols] = (uint8_t)(4 * k + c);
      }
    }
  }
  return true;
}

// the grid cap of a launch on card `dev` whose warps' slots take `bytes`:
// the card's SMs times the blocks an SM holds, for slots rounded up to
// whole KB (a cap that fits the rounded slots fits the real ones, and the
// blocks' number does not change the bits).  Asked of the runtime at the
// first launch of each (card, KB), with the card current, and kept; that
// first launch also opts the kernel in to slots above 48 KB on the card
// (the attribute is the card's own).  Racing first launches ask twice and
// keep the same answer
std::atomic<int> g_grid_cap[kMaxDevices][kMaxSlotBytes / 1024 + 1];

cudaError_t grid_cap(int dev, size_t bytes, int64_t* cap) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int kb = (int)((bytes + 1023) / 1024);
  int c = g_grid_cap[dev][kb].load(std::memory_order_acquire);
  if (c == 0) {
    int cur = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return err;
    if (cur != dev) err = cudaSetDevice(dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(lut_bwd_many_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSlotBytes);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lut_bwd_many_kernel, kThreads, (size_t)kb * 1024);
    }
    if (cur != dev) {
      const cudaError_t back = cudaSetDevice(cur);
      if (err == cudaSuccess) err = back;
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    c = sms * per_sm;
    g_grid_cap[dev][kb].store(c, std::memory_order_release);
  }
  *cap = c;
  return cudaSuccess;
}

}  // namespace

// floats of scratch nart_lut_gather_bwd_many needs for N lanes and
// `total` = sum n_k C_k sums: the partials (total, n_blocks)
extern "C" int64_t nart_lut_bwd_many_scratch(int64_t N, int64_t total) {
  return n_blocks_of(N) * total;
}

// what nart_lut_gather_bwd_many takes: tables a launch, rows a table and
// values a row (select.py holds its own limits to these)
extern "C" void nart_lut_bwd_many_limits(int* tables, int* rows, int* width) {
  *tables = kMaxTables;
  *rows = kMaxRows;
  *width = kMaxBwdWidth;
}

// grads[k] (N, widths[k]) float32 contiguous, outs[k] (rows[k],
// widths[k]) for k < n_tables; rows[k] <= 64, widths[k] <= 4; idx and
// every tensor on card `device`, the current one; scratch of
// nart_lut_bwd_many_scratch floats
extern "C" int nart_lut_gather_bwd_many(const float* const* grads,
                                        float* const* outs,
                                        const int64_t* rows, const int* widths,
                                        int n_tables, const int64_t* idx,
                                        int64_t N, float* scratch, int device,
                                        cudaStream_t stream) {
  BwdArgs a;
  if (!bwd_args(grads, outs, rows, widths, n_tables, N, &a)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = sizeof(float) * kWarps * a.off[a.k];
  int64_t grid = 0;
  const cudaError_t err = grid_cap(device, bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_blocks = n_blocks_of(N);
  if (grid > n_blocks) grid = n_blocks;
  // every block resident at once: the grid-wide barrier waits for all
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, lut_bwd_many_kernel, a, idx, N,
                                 n_blocks, scratch);
}

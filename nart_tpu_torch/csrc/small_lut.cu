// Table look-ups: per-lane row reads of float32 tables, and, for a table
// of a few rows, the backward, the per-row sum of the lanes' cotangents.
// nart_tpu_torch/select.py binds both entries:
//   * nart_lut_gather_many  out_k[i, :] = table_k[clamp(idx[i], 0,
//                           n_k - 1), :] for up to 16 tables k read by one
//                           idx, in one launch: every float table, any n,
//                           rows of C = 1 to 8 values (its cost does not
//                           depend on n); one table is the case k = 1
//   * nart_lut_gather_bwd   d_table[r, :] = the sum of g[i, :] over the
//                           lanes i with clamp(idx[i], 0, n - 1) == r, for
//                           rows of C = 1 to 4 values (select.py takes it
//                           for tables of at most 64 rows; the others'
//                           backward is csrc/large_lut.cu's)
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
// The backward's bytes are as few (idx and g, 8 + 4C B a lane, and the
// (n, C) table): it is two launches, with no float atomics (graphed and
// per-round replays, repeated shards, must give the same bits).  A block
// owns a fixed range of kLanesPerBlock lanes and one tile of kRowTile table
// rows (grid.y covers tables of more rows).  A warp reads 32 lanes at a
// time, groups them by row (a ballot on the first pending lane's row) and
// sums each group's cotangents with a shuffle-down tree over all 32 lanes
// (the other lanes add 0); lane 0 adds the total to the warp's own slots of
// that row in shared memory.  The block then sums its warps' slots in warp
// order into its partial, one (n, C) slab of the scratch (n_blocks, n, C).
// The second launch gives each output one warp: lane l sums the partials
// of blocks l, l + 32, ... in order, then a shuffle-down tree.  Every sum
// runs in a fixed order, so every run gives the same bits (not those of a
// serial sum: another order, within float32 rounding of it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 64;        // table rows a backward block sums
constexpr int kLanesPerBlock = 512;  // lanes a backward block reads
constexpr int kGatherThreads = 256;  // lanes (and threads) a forward block
constexpr int kMaxTables = 16;       // tables one forward launch reads
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

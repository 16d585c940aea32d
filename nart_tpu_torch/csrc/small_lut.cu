// Table look-ups: a per-lane row read of a float32 table, and, for a table
// of a few rows, its backward, the per-row sum of the lanes' cotangents.
// nart_tpu_torch/select.py binds both entries:
//   * nart_lut_gather      out[i, :] = table[clamp(idx[i], 0, n - 1), :],
//                          for every float table: any n, rows of C = 1 to
//                          8 values (its cost does not depend on n)
//   * nart_lut_gather_bwd  d_table[r, :] = the sum of g[i, :] over the
//                          lanes i with clamp(idx[i], 0, n - 1) == r, for
//                          rows of C = 1 to 4 values (select.py takes it
//                          for tables of at most 64 rows; the others'
//                          backward is csrc/large_lut.cu's)
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
// What bounds it on an H100: bytes.  The forward reads idx (8 B a lane)
// and 4C B of the table a lane, and writes 4C B a lane; the backward reads
// idx and g (8 + 4C B a lane) and writes the (n, C) table.  At N = 65,536
// and C = 3 that is about 1.3 MB, 0.4 us at 3.35 TB/s: far below one
// launch's latency (a few us).  So each entry is simple: the forward one
// launch, the backward two.  Tensor cores and TMA have nothing to do here.
//
// The forward is an exact copy: the plain version's bits.
//
// The backward is deterministic, with no float atomics (graphed and
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

template <int C>
__global__ void __launch_bounds__(kThreads)
    lut_gather_kernel(const float* __restrict__ table,
                      const int64_t* __restrict__ idx, int64_t N, int64_t n,
                      float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < N;
       i += stride) {
    const int64_t r = clamp_row(idx[i], n);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      out[i * C + c] = __ldg(table + r * C + c);
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
void launch_gather(const float* table, const int64_t* idx, int64_t N,
                   int64_t n, float* out, cudaStream_t stream) {
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop does the rest
  lut_gather_kernel<C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, idx, N, n, out);
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

extern "C" int nart_lut_gather(const float* table, const int64_t* idx,
                               int64_t N, int64_t n, int C, float* out,
                               cudaStream_t stream) {
  if (bad_args(N, n, C, 8)) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 1: launch_gather<1>(table, idx, N, n, out, stream); break;
    case 2: launch_gather<2>(table, idx, N, n, out, stream); break;
    case 3: launch_gather<3>(table, idx, N, n, out, stream); break;
    case 4: launch_gather<4>(table, idx, N, n, out, stream); break;
    case 5: launch_gather<5>(table, idx, N, n, out, stream); break;
    case 6: launch_gather<6>(table, idx, N, n, out, stream); break;
    case 7: launch_gather<7>(table, idx, N, n, out, stream); break;
    default: launch_gather<8>(table, idx, N, n, out, stream); break;
  }
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

// Large-table look-ups' backward (S2): the per-row sum of the lanes'
// cotangents for a float32 table of any number of rows.
// nart_tpu_torch/select.py binds it and uses it for tables of more than
// select.AUTO_LUT_ROWS (64) rows, or of rows wider than 4 values; their
// forward is csrc/small_lut.cu's nart_lut_gather, whose cost does not
// depend on n:
//   * nart_lut_large_bwd  d_table[r, :] = the sum of g[i, :] over the
//                         lanes i with clamp(idx[i], 0, n - 1) == r,
//                         given those rows sorted (see below)
// Rows hold C = 1 to 8 values.
//
// It stands for XLA's transpose of a gather, the scatter-add, behind the
// JAX package's plain gathers of its large tables, which have no Pallas
// kernel: the texture table (nart_tpu/materials.py:60 tex_fetch), the
// env map and light textures of more than 64 texels
// (nart_tpu/lights.py:73, the JAX package's auto_lut) and the medium's packed
// density cells (nart_tpu/media.py:81).  The port's plain version,
// table[idx] under autograd, differentiates through PyTorch's sorted
// index_put_(accumulate=True), whose indexing_backward kernel walks every
// run of equal indices serially: lanes that share a texel or a density
// cell (a sky texel seen by many pixels, lanes whose look-up is masked out
// later) make runs tens of thousands of lanes long.
//
// What bounds it on an H100: bytes.  It reads idx and g (8 + 4C B a lane)
// and writes the dense (n, C) table: for the 9,047,075-texel texture that
// is 108.6 MB, whose zero-fill alone takes about 32 us at 3.35 TB/s and
// bounds the launch; for the 8,192-texel env map the lanes' 1.3 MB bound
// it below a launch's latency.
//
// It is deterministic, with no float atomics (graphed and per-round
// replays, repeated shards, must give the same bits), and reads nothing on
// the host, so that it runs inside a captured CUDA graph: every
// size follows from N, n and C.  Its cost follows the lanes, not the rows
// nor the runs:
//   0. the caller orders the lanes by row, stably: keys (the clamped rows
//      as int32) and perm from torch.sort(stable=True), the same
//      permutation PyTorch's own backward sorts by.  The sort is not the
//      function computed here, and a radix sort is what a hand-written pass
//      would be too; what this file replaces is the serial walk over each
//      run that follows it.
//   1. d_table is zero-filled (rows with no lanes are 0).
//   2. lut_seg_kernel: a block owns kSeg = 1,024 consecutive sorted
//      positions, one a thread; thread p holds g[perm[p], :].  A segmented
//      inclusive scan with head flags (a new row, or the block's first
//      position) sums each run left to right in a fixed tree: five
//      shuffle-up steps within a warp, then the same scan over the 32
//      warps' totals in shared memory, whose exclusive prefix each warp
//      adds where its run began before it.  At the last position of each
//      run in the block, a run that begins and ends in the block is
//      written to d_table by that thread; the block's first and last runs'
//      partial sums go to head_part[b] and tail_part[b] (at most two pieces
//      a block).
//   3. lut_carry_kernel: one warp a block b whose last run begins in b and
//      goes on past it.  It finds the run's last position by a binary
//      search over the sorted keys, and sums tail_part[b] and head_part[j]
//      of the blocks j the run covers after b (lane l takes j = b + 1 + l,
//      b + 33 + l, ... in order), then a shuffle-down tree.  A run of R
//      lanes costs a warp R / 1,024 loads, not R serial steps.
// Every sum runs in a fixed order, so every run gives the same bits (not
// those of a serial sum: another order, within float32 rounding of it).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // the carry's blocks
constexpr int kSeg = 1024;     // sorted positions a backward block sums
constexpr int kSegWarps = kSeg / 32;
constexpr int kMaxC = 8;
constexpr unsigned kFull = 0xffffffffu;

// one step of a segmented inclusive scan over the 32 lanes: a lane that
// has seen no head yet adds the value `off` lanes before it (earlier terms
// first) and inherits that lane's flag
template <int C>
__device__ __forceinline__ void seg_scan_warp(int lane, int& flag,
                                              float (&v)[C]) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int f_up = __shfl_up_sync(kFull, flag, off);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float up = __shfl_up_sync(kFull, v[c], off);
      if (lane >= off && !flag) v[c] = up + v[c];
    }
    if (lane >= off) flag |= f_up;
  }
}

template <int C>
__global__ void __launch_bounds__(kSeg)
    lut_seg_kernel(const float* __restrict__ g,
                   const int32_t* __restrict__ keys,
                   const int64_t* __restrict__ perm, int64_t N,
                   float* __restrict__ d_table, float* __restrict__ head_part,
                   float* __restrict__ tail_part) {
  __shared__ float w_sum[kSegWarps][C];
  __shared__ int w_flag[kSegWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t base = (int64_t)blockIdx.x * kSeg;
  const int64_t end = base + kSeg < N ? base + kSeg : N;
  const int64_t p = base + t;
  const bool valid = p < end;
  // positions past the end hold key -1 (no row) and add 0
  const int key = valid ? keys[p] : -1;
  float v[C];
  if (valid) {
    const int64_t i = perm[p];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = g[i * C + c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f;
  }
  int flag = t == 0 || !valid || keys[p - 1] != key;
  seg_scan_warp<C>(lane, flag, v);

  // the warps' totals (the sum of each warp's last run, and whether the
  // warp holds a head), scanned the same way by warp 0
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < C; ++c) w_sum[warp][c] = v[c];
    w_flag[warp] = flag;
  }
  __syncthreads();
  if (warp == 0) {
    int f = w_flag[lane];
    float s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = w_sum[lane][c];
    seg_scan_warp<C>(lane, f, s);
    // exclusive: warp w takes the scan of warps 0 .. w - 1
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float s_ex = __shfl_up_sync(kFull, s[c], 1);
      w_sum[lane][c] = lane == 0 ? 0.f : s_ex;
    }
  }
  __syncthreads();
  if (!flag) {  // the run began in an earlier warp
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = w_sum[warp][c] + v[c];
  }
  if (!valid) return;

  // the last position of a run, within the block
  const bool last_in_block = p + 1 == end;
  const bool run_ends = p + 1 == N || keys[p + 1] != key;
  if (!(last_in_block || run_ends)) return;
  const bool first_run = key == keys[base];
  const bool run_begins = !first_run || base == 0 || keys[base - 1] != key;
  if (run_begins && run_ends) {
#pragma unroll
    for (int c = 0; c < C; ++c) d_table[(int64_t)key * C + c] = v[c];
  }
  if (first_run) {
#pragma unroll
    for (int c = 0; c < C; ++c) head_part[(int64_t)blockIdx.x * C + c] = v[c];
  }
  if (last_in_block) {
#pragma unroll
    for (int c = 0; c < C; ++c) tail_part[(int64_t)blockIdx.x * C + c] = v[c];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    lut_carry_kernel(const int32_t* __restrict__ keys, int64_t N,
                     int64_t n_blocks, const float* __restrict__ head_part,
                     const float* __restrict__ tail_part,
                     float* __restrict__ d_table) {
  const int64_t b = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= n_blocks) return;  // whole warps leave together
  const int64_t base = b * kSeg;
  const int64_t last = (base + kSeg < N ? base + kSeg : N) - 1;
  const int key = keys[last];
  // the block's last run must go on past it, and begin in it
  if (last + 1 == N || keys[last + 1] != key) return;
  if (keys[base] == key && base > 0 && keys[base - 1] == key) return;
  // the run's last position: keys are sorted, keys[last + 1] == key
  int64_t lo = last + 1, hi = N - 1;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo + 1) / 2;
    if (keys[mid] == key) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t b_end = lo / kSeg;
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;
  for (int64_t j = b + 1 + lane; j <= b_end; j += 32) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += head_part[j * C + c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[c] += __shfl_down_sync(kFull, s[c], off);
    }
    if (lane == 0) {
      d_table[(int64_t)key * C + c] = tail_part[b * C + c] + s[c];
    }
  }
}

int64_t n_blocks_of(int64_t N) { return (N + kSeg - 1) / kSeg; }

bool bad_args(int64_t N, int64_t n, int C) {
  return N <= 0 || n <= 0 || n > INT32_MAX || C < 1 || C > kMaxC;
}

// f(std::integral_constant<int, C>()) for the row width C, 1 to 8
template <typename F>
cudaError_t by_width(int C, F&& f) {
  switch (C) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    default: return f(std::integral_constant<int, 8>());
  }
}

template <int C>
cudaError_t launch_bwd(const float* g, const int32_t* keys,
                       const int64_t* perm, int64_t N, float* scratch,
                       float* d_table, cudaStream_t stream) {
  const int64_t nb = n_blocks_of(N);
  float* head_part = scratch;
  float* tail_part = scratch + nb * C;
  lut_seg_kernel<C><<<(unsigned)nb, kSeg, 0, stream>>>(
      g, keys, perm, N, d_table, head_part, tail_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (nb * 32 + kThreads - 1) / kThreads;
  lut_carry_kernel<C><<<(unsigned)blocks, kThreads, 0, stream>>>(
      keys, N, nb, head_part, tail_part, d_table);
  return cudaGetLastError();
}

}  // namespace

// floats of scratch nart_lut_large_bwd needs: head_part and tail_part,
// (n_blocks, C) each
extern "C" int64_t nart_lut_large_bwd_scratch(int64_t N, int C) {
  return 2 * n_blocks_of(N) * C;
}

// keys: the lanes' rows, clamped to [0, n - 1], sorted ascending; perm:
// the lane of each sorted position (a stable sort's indices)
extern "C" int nart_lut_large_bwd(const float* g, const int32_t* keys,
                                  const int64_t* perm, int64_t N, int64_t n,
                                  int C, float* scratch, float* d_table,
                                  cudaStream_t stream) {
  if (bad_args(N, n, C)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(
      d_table, 0, (size_t)n * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)by_width(C, [&](auto w) {
    return launch_bwd<decltype(w)::value>(g, keys, perm, N, scratch, d_table,
                                          stream);
  });
}

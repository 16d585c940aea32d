// Large-table look-ups' backward (S2): the per-row sum of the lanes'
// cotangents for a float32 table of any number of rows.
// nart_tpu_torch/select.py binds it and uses it for tables of more than
// select.AUTO_LUT_ROWS (64) rows, or of rows wider than 4 values; their
// forward is csrc/small_lut.cu's nart_lut_gather_many, whose cost does not
// depend on n:
//   * nart_lut_large_bwd         d_table[r, :] = the sum of g[i, :] over the
//                                lanes i with clamp(idx[i], 0, n - 1) == r
//   * nart_lut_large_bwd_sorted  the same, given those rows already sorted
//                                stably with their permutation (from
//                                torch.sort): the route before the radix
//                                sort below, kept as the reference that
//                                nart_lut_large_bwd is held to, bit for bit
// Rows hold C = 1 to 8 values.
//
// It stands for XLA's transpose of a gather, the scatter-add, behind the
// JAX package's plain gathers of its large tables, which have no Pallas
// kernel: the texture table (nart_tpu/materials.py:60 tex_fetch), the
// env map and light textures of more than 64 texels
// (nart_tpu/lights.py:73, the JAX package's auto_lut) and the medium's
// packed density cells (nart_tpu/media.py:81).  The port's plain version,
// table[idx] under autograd, differentiates through PyTorch's sorted
// index_put_(accumulate=True), whose indexing_backward kernel walks every
// run of equal indices serially: lanes that share a texel or a density
// cell (a sky texel seen by many pixels, lanes whose look-up is masked out
// later) make runs tens of thousands of lanes long.
//
// It is deterministic, with no float atomics (graphed and per-round
// replays, repeated shards, must give the same bits), and reads nothing on
// the host, so that it runs inside a captured CUDA graph: every size
// follows from N, n and C.  Its cost follows the lanes, not the runs.
//
// What bounds it on an H100.  Bytes only for the 9,047,075-texel texture:
// it writes the dense (n, C) table, 108.6 MB, whose zero-fill alone takes
// about 32 us at 3.35 TB/s.  For the 8,192-texel env map and the 29,791
// density cells the bytes (idx, g and the table: about 1.4 MB) take under
// 1 us, and what a call costs is its graph nodes and their latency: a
// torch.sort of the clamped rows over all 32 key bits carrying int64
// indices (about six sort kernels), the clamp and the cast before it, a
// memset, and a segmented sum whose carry launch found each crossing run's
// end by a binary search (fifteen dependent loads).  So the sort here is
// written for the rows' own bits and the rest is fused, in 1 + P graph
// nodes (a memset, then one launch a radix pass: 3 for the env map and the
// cells, 4 for the texture):
//   0. a memset zeroes the small counters (tickets, the digit counts, the
//      look-back words, the segment flags).
//   1. P = ceil(B / 8) passes of a stable LSD radix sort over the B =
//      ceil(log2 n) bits of the clamped rows (digits of at most 8 bits:
//      13 bits of the env map and 15 of the cells are 2 passes, 24 of the
//      texture 3).  A launch's blocks take their roles from an atomic
//      ticket, in this order, so that a block waits only on blocks that
//      took earlier tickets and are therefore running (no deadlock
//      whatever the scheduler does):
//      - the first launch only: one block a tile of 1,024 lanes reads the
//        int64 idx, clamps it and counts every pass's digits (per warp
//        with __match_any_sync, then shared and global integer atomics);
//      - one block a tile ranks its 1,024 lanes by this pass's digit: a
//        warp ranks its 32 lanes with __match_any_sync and a population
//        count, the warps are added in warp order, the digit's global
//        offset comes from the counts, and its count in the earlier tiles
//        from a look-back over words that hold a flag and a count (a digit
//        and tile each): the last 64 tiles' own counts are read at once, a
//        few threads a digit, and only beyond them the inclusive count of
//        one tile, so that the look-back is not one dependent load a
//        tile; each lane is written to its place, row and lane number as
//        int32 (the first pass reads and clamps idx itself);
//      - the first launch only: blocks that zero-fill d_table;
//      - the last launch only: the segmented sum (below) over 1,024 sorted
//        positions a block, once every ranking block is done.
//      Only integer counts decide a place, so the order is exactly a
//      stable sort's: torch.sort(stable=True)'s.
//   2. the segmented sum (as nart_lut_large_bwd_sorted's lut_seg_kernel):
//      thread p holds g[lane of sorted position p, :].  A segmented
//      inclusive scan with head flags (a new row, or the block's first
//      position) sums each run left to right in a fixed tree: five
//      shuffle-up steps within a warp, then the same scan over the 32
//      warps' totals in shared memory, whose exclusive prefix each warp
//      adds where its run began before it.  At the last position of each
//      run in the block, a run that begins and ends in the block is
//      written to d_table by that thread; the block's first and last runs'
//      partial sums go to head_part[b] and tail_part[b] (at most two
//      pieces a block), and the block raises its flag.
//   3. the carry, by the block where a run that crossed blocks ends (the
//      sorted route's lut_carry_kernel did it in a launch of its own, from
//      the block where the run begins, after a binary search for its
//      end): one warp finds the block b where the run began from the
//      blocks' first rows, 32 blocks a step, waits for the flags of blocks
//      b to itself, and sums tail_part[b] and head_part[j] of the blocks j
//      after b (lane l takes j = b + 1 + l, b + 33 + l, ... in order),
//      then a shuffle-down tree: the same terms in the same order as the
//      sorted route's carry.  A run of R lanes costs a warp R / 1,024
//      loads, not R serial steps.
// Every sum runs in a fixed order, so every run gives the same bits (not
// those of a serial sum: another order, within float32 rounding of it),
// and, as the permutation is the same, the bits of the sorted route.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // the sorted route's carry blocks
constexpr int kSeg = 1024;      // sorted positions a segmented-sum block sums
constexpr int kSegWarps = kSeg / 32;
constexpr int kTile = kSeg;     // lanes a radix block ranks, one a thread
constexpr int kBins = 256;      // digits of at most 8 bits
constexpr int kMaxPasses = 4;   // 32 key bits at most
constexpr int kWindow = 64;     // earlier tiles a ranking block sums itself
constexpr int kZeroFloats = 4 * 4 * kTile;  // floats a zero-fill block writes
constexpr int kMaxC = 8;
constexpr int64_t kMaxLanes = (1 << 30) - 1;  // counts fit a look-back word
constexpr unsigned kFull = 0xffffffffu;
// a look-back word: a flag in the top two bits, a count below them
constexpr unsigned kAggregate = 1u << 30;  // the tile's own count
constexpr unsigned kInclusive = 2u << 30;  // the count of tiles 0 .. this
constexpr unsigned kCountMask = kAggregate - 1;
// the counters at the head of the zeroed scratch: a ticket counter a
// launch (pass), then the blocks done of each kind
constexpr int kHistDone = kMaxPasses;
constexpr int kZeroDone = kMaxPasses + 1;
constexpr int kPassDone = kMaxPasses + 2;
constexpr int kCounters = kMaxPasses + 4;

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

// a sorted position's lane, read through L2: torch.sort's int64
// permutation, or the radix route's int32 lanes
__device__ __forceinline__ int64_t ld_lane(const int64_t* p) {
  return __ldcg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int64_t ld_lane(const int32_t* p) {
  return __ldcg(p);
}

// the segmented sum of block b over sorted positions b * kSeg ...: keys
// (the sorted rows) and lanes (the lane of each sorted position) are read
// through L2 (__ldcg): in the radix route other blocks of the same launch
// wrote them
template <int C, typename Lane>
__device__ __forceinline__ void seg_block(const float* __restrict__ g,
                                          const int32_t* keys,
                                          const Lane* lanes, int64_t N,
                                          int64_t b, float* d_table,
                                          float* head_part,
                                          float* tail_part) {
  __shared__ float w_sum[kSegWarps][C];
  __shared__ int w_flag[kSegWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t base = b * kSeg;
  const int64_t end = base + kSeg < N ? base + kSeg : N;
  const int64_t p = base + t;
  const bool valid = p < end;
  // positions past the end hold key -1 (no row) and add 0
  const int key = valid ? __ldcg(keys + p) : -1;
  float v[C];
  if (valid) {
    const int64_t i = ld_lane(lanes + p);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = g[i * C + c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f;
  }
  int flag = t == 0 || !valid || __ldcg(keys + p - 1) != key;
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
  const bool run_ends = p + 1 == N || __ldcg(keys + p + 1) != key;
  if (!(last_in_block || run_ends)) return;
  const bool first_run = key == __ldcg(keys + base);
  const bool run_begins =
      !first_run || base == 0 || __ldcg(keys + base - 1) != key;
  if (run_begins && run_ends) {
#pragma unroll
    for (int c = 0; c < C; ++c) d_table[(int64_t)key * C + c] = v[c];
  }
  if (first_run) {
#pragma unroll
    for (int c = 0; c < C; ++c) head_part[b * C + c] = v[c];
  }
  if (last_in_block) {
#pragma unroll
    for (int c = 0; c < C; ++c) tail_part[b * C + c] = v[c];
  }
}

// d_table[key, :] = tail_part[b, :] + the sum of head_part[j, :] for j in
// b + 1 .. b_end: lane l sums j = b + 1 + l, b + 33 + l, ... in order, then
// a shuffle-down tree (one warp)
template <int C>
__device__ __forceinline__ void carry_sum(const float* head_part,
                                          const float* tail_part, int64_t b,
                                          int64_t b_end, int key,
                                          float* d_table) {
  const int lane = threadIdx.x & 31;
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;
  for (int64_t j = b + 1 + lane; j <= b_end; j += 32) {
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] += __ldcg(head_part + j * C + c);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[c] += __shfl_down_sync(kFull, s[c], off);
    }
    if (lane == 0) {
      d_table[(int64_t)key * C + c] = __ldcg(tail_part + b * C + c) + s[c];
    }
  }
}

// ---------------------------------------------------------------------------
// The sorted route: torch.sort's keys and permutation given
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kSeg)
    lut_seg_kernel(const float* __restrict__ g, const int32_t* keys,
                   const int64_t* perm, int64_t N, float* d_table,
                   float* head_part, float* tail_part) {
  seg_block<C>(g, keys, perm, N, blockIdx.x, d_table, head_part, tail_part);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    lut_carry_kernel(const int32_t* __restrict__ keys, int64_t N,
                     int64_t n_blocks, const float* head_part,
                     const float* tail_part, float* d_table) {
  const int64_t b = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
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
  carry_sum<C>(head_part, tail_part, b, lo / kSeg, key, d_table);
}

// ---------------------------------------------------------------------------
// The radix route
// ---------------------------------------------------------------------------

struct SortArgs {
  const float* g;
  const int64_t* idx;
  int64_t N, n;
  int passes, bits, digit_bits;  // P, B = ceil(log2 n), bits a pass
  int pass;                      // this launch's pass
  int64_t nb;                    // tiles (and segmented-sum blocks)
  int64_t nz;                    // zero-fill blocks
  unsigned* ctr;                 // kCounters counters
  unsigned* counts;              // (P, kBins) digit counts
  unsigned* status;              // (P, 2, nb, kBins) look-back words
  unsigned* seg_flag;            // (nb,) segmented-sum blocks done
  int32_t* keys[2];              // pass p writes keys[p & 1], lanes[p & 1]
  int32_t* lanes[2];
  float* head_part;              // (nb, C)
  float* tail_part;              // (nb, C)
  float* d_table;                // (n, C)
};

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void st_volatile(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// the count of a look-back word, once its flag is up
__device__ __forceinline__ unsigned wait_word(const unsigned* p,
                                              unsigned flag) {
  unsigned w;
  while (!((w = ld_volatile(p)) & flag)) {
  }
  return w & kCountMask;
}

// one thread waits until *p reaches `target` (blocks that took earlier
// tickets count it up), then orders its later reads after theirs
__device__ __forceinline__ void wait_count(const unsigned* p,
                                           int64_t target) {
  while ((int64_t)ld_volatile(p) < target) __nanosleep(64);
  __threadfence();
}

__device__ __forceinline__ int row_of(int64_t r, int64_t n) {
  return (int)(r < 0 ? 0 : (r >= n ? n - 1 : r));
}

__device__ __forceinline__ int digit_width(const SortArgs& a, int p) {
  const int rest = a.bits - p * a.digit_bits;
  return rest < a.digit_bits ? rest : a.digit_bits;
}

// a block has raised its counter once its writes are visible to all
__device__ __forceinline__ void block_done(unsigned* counter) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1u);
}

// every pass's digit counts of one tile of lanes, added to the global ones
__device__ void hist_tile(const SortArgs& a, int64_t tile) {
  __shared__ unsigned s_hist[kMaxPasses * kBins];
  for (int k = threadIdx.x; k < kMaxPasses * kBins; k += kTile) s_hist[k] = 0;
  __syncthreads();
  const int64_t i = tile * kTile + threadIdx.x;
  const bool valid = i < a.N;
  const int key = valid ? row_of(a.idx[i], a.n) : 0;
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < a.passes; ++p) {
    const int d = valid ? (key >> (p * a.digit_bits)) &
                              ((1 << digit_width(a, p)) - 1)
                        : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && lane == __ffs(peers) - 1) {
      atomicAdd(&s_hist[p * kBins + d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.passes * kBins; k += kTile) {
    if (s_hist[k]) atomicAdd(&a.counts[k], s_hist[k]);
  }
  block_done(&a.ctr[kHistDone]);
}

// one tile of this pass: each lane to its place in the pass's order
__device__ void rank_tile(const SortArgs& a, int64_t tile) {
  __shared__ unsigned s_wh[kTile / 32][kBins];  // a warp's digit counts
  __shared__ unsigned s_base[kBins];  // a digit's global offset
  __shared__ unsigned s_excl[kBins];  // a digit's count in earlier tiles
  __shared__ unsigned s_wtot[kBins / 32];
  __shared__ unsigned s_cnt[kBins];   // a digit's count in this tile
  __shared__ unsigned s_part[kTile];  // look-back partial sums
  const int p = a.pass;
  // the pass's look-back words: each tile's own counts, and the counts of
  // tiles 0 .. tile (only read kWindow tiles on)
  unsigned* agg = a.status + (int64_t)p * 2 * a.nb * kBins;
  unsigned* inc = agg + a.nb * kBins;
  const int shift = p * a.digit_bits;
  const int n_bins = 1 << digit_width(a, p);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < (kTile / 32) * kBins; k += kTile) {
    (&s_wh[0][0])[k] = 0;
  }
  if (p == 0 && threadIdx.x == 0) wait_count(&a.ctr[kHistDone], a.nb);
  __syncthreads();

  const int64_t i = tile * kTile + threadIdx.x;
  const bool valid = i < a.N;
  int key = 0, ln = 0;
  if (valid) {
    if (p == 0) {
      key = row_of(a.idx[i], a.n);
      ln = (int)i;
    } else {
      key = a.keys[(p - 1) & 1][i];
      ln = a.lanes[(p - 1) & 1][i];
    }
  }
  const int d = valid ? (key >> shift) & (n_bins - 1) : -1;
  const unsigned peers = __match_any_sync(kFull, d);
  const unsigned rank = __popc(peers & ((1u << lane) - 1u));
  if (valid && rank == 0) s_wh[warp][d] = __popc(peers);
  // the digits' global offsets: an exclusive scan of the pass's counts
  if (threadIdx.x < kBins) {
    const unsigned c =
        (int)threadIdx.x < n_bins ? __ldcg(&a.counts[p * kBins + threadIdx.x])
                                  : 0u;
    unsigned s = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += up;
    }
    if (lane == 31) s_wtot[warp] = s;
    s_base[threadIdx.x] = s - c;
  }
  __syncthreads();
  if ((int)threadIdx.x < n_bins) {
    const int dg = threadIdx.x;
    for (int w = 0; w < (dg >> 5); ++w) s_base[dg] += s_wtot[w];
    // the warps in warp order
    unsigned run = 0;
    for (int w = 0; w < kTile / 32; ++w) {
      const unsigned c = s_wh[w][dg];
      s_wh[w][dg] = run;
      run += c;
    }
    // publish the tile's own counts
    st_volatile(agg + tile * kBins + dg, kAggregate | run);
    s_cnt[dg] = run;
  }
  // the earlier tiles' counts: the last kWindow tiles' own counts summed
  // here, slot s of a digit taking tiles tile - 1 - s, tile - 1 - s -
  // slots, ..., and before them the inclusive count of tile lo - 1
  const int slots = kTile / n_bins < kWindow ? kTile / n_bins : kWindow;
  const int64_t lo = tile > kWindow ? tile - kWindow : 0;
  {
    const int dg = threadIdx.x & (n_bins - 1);
    const int slot = threadIdx.x / n_bins;
    unsigned part = 0;
    if (slot < slots) {
      for (int64_t j = tile - 1 - slot; j >= lo; j -= slots) {
        part += wait_word(agg + j * kBins + dg, kAggregate);
      }
    }
    s_part[threadIdx.x] = part;
  }
  __syncthreads();
  if ((int)threadIdx.x < n_bins) {
    const int dg = threadIdx.x;
    unsigned before = 0;
    for (int k = 0; k < slots; ++k) before += s_part[k * n_bins + dg];
    if (lo > 0) before += wait_word(inc + (lo - 1) * kBins + dg, kInclusive);
    st_volatile(inc + tile * kBins + dg, kInclusive | (before + s_cnt[dg]));
    s_excl[dg] = before;
  }
  __syncthreads();
  if (valid) {
    const unsigned pos = s_base[d] + s_excl[d] + s_wh[warp][d] + rank;
    a.keys[p & 1][pos] = key;
    a.lanes[p & 1][pos] = ln;
  }
  if (p == a.passes - 1) block_done(&a.ctr[kPassDone]);
}

// zero-fill kZeroFloats floats of d_table (16-byte aligned) from z
__device__ void zero_chunk(const SortArgs& a, int64_t z, int C) {
  const int64_t total = a.n * C;
  const int64_t lo = z * kZeroFloats;
  const int64_t hi = lo + kZeroFloats < total ? lo + kZeroFloats : total;
  for (int64_t k = lo + 4 * threadIdx.x; k < hi; k += 4 * kTile) {
    if (k + 4 <= hi) {
      *reinterpret_cast<float4*>(a.d_table + k) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int64_t m = k; m < hi; ++m) a.d_table[m] = 0.f;
    }
  }
  block_done(&a.ctr[kZeroDone]);
}

// the segmented sum of sorted positions s * kSeg ..., then, by one warp,
// the carry of a run that began in an earlier block and ends in this one
template <int C>
__device__ void sum_block(const SortArgs& a, int64_t s) {
  if (threadIdx.x == 0) {
    wait_count(&a.ctr[kPassDone], a.nb);
    if (a.pass == 0) wait_count(&a.ctr[kZeroDone], a.nz);
  }
  __syncthreads();
  const int32_t* keys = a.keys[a.pass & 1];
  seg_block<C>(a.g, keys, a.lanes[a.pass & 1], a.N, s, a.d_table,
               a.head_part, a.tail_part);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_volatile(&a.seg_flag[s], 1u);
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const int64_t base = s * kSeg;
  const int64_t last = (base + kSeg < a.N ? base + kSeg : a.N) - 1;
  const int key = __ldcg(keys + base);
  // the block's first run began in an earlier block ...
  if (base == 0 || __ldcg(keys + base - 1) != key) return;
  // ... and ends in this one
  if (last + 1 < a.N && __ldcg(keys + last) == key &&
      __ldcg(keys + last + 1) == key) {
    return;
  }
  // the block b where it began: after the last block before s whose first
  // row is another, or in that block if its last position holds the row
  int64_t b = 0;
  for (int64_t hi = s - 1; hi >= 0; hi -= 32) {
    const int64_t j = hi - lane;
    const unsigned other =
        __ballot_sync(kFull, j >= 0 && __ldcg(keys + j * kSeg) != key);
    if (other) {
      const int64_t jo = hi - (__ffs(other) - 1);
      b = __ldcg(keys + (jo + 1) * kSeg - 1) == key ? jo : jo + 1;
      break;
    }
  }
  for (int64_t j = b + lane; j < s; j += 32) {
    while (!ld_volatile(&a.seg_flag[j])) __nanosleep(64);
  }
  __threadfence();
  __syncwarp();
  carry_sum<C>(a.head_part, a.tail_part, b, s, key, a.d_table);
}

// one launch (pass) of the radix route; its blocks' roles by ticket: the
// first launch's digit counts, this pass's ranks, the first launch's
// zero-fill, the last launch's segmented sums
template <int C>
__global__ void __launch_bounds__(kTile) lut_sort_kernel(const SortArgs a) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(&a.ctr[a.pass], 1u);
  __syncthreads();
  int64_t t = s_ticket;
  const bool first = a.pass == 0;
  if (first) {
    if (t < a.nb) {
      hist_tile(a, t);
      return;
    }
    t -= a.nb;
  }
  if (t < a.nb) {
    rank_tile(a, t);
    return;
  }
  t -= a.nb;
  if (first) {
    if (t < a.nz) {
      zero_chunk(a, t, C);
      return;
    }
    t -= a.nz;
  }
  sum_block<C>(a, t);
}

int64_t n_blocks_of(int64_t N) { return (N + kSeg - 1) / kSeg; }

int64_t round4(int64_t x) { return (x + 3) / 4 * 4; }

bool bad_args(int64_t N, int64_t n, int C) {
  return N <= 0 || n <= 0 || n > INT32_MAX || C < 1 || C > kMaxC;
}

// the radix schedule: B bits of the rows 0 .. n - 1 (at least 1), P passes
// of at most 8 bits, D bits each (the last pass the rest)
struct Schedule {
  int bits, passes, digit_bits;
};

Schedule schedule_of(int64_t n) {
  int bits = 1;
  while (bits < 31 && ((int64_t)1 << bits) < n) ++bits;
  const int passes = (bits + 7) / 8;
  return {bits, passes, (bits + passes - 1) / passes};
}

// the scratch, in 4-byte words: the zeroed head (counters, digit counts,
// look-back words, segment flags), the ping-pong keys and lanes, the
// segment parts
struct Layout {
  int64_t counts, status, seg_flag, zeroed, keys0, lanes0, keys1, lanes1,
      head, tail, total;
};

Layout layout_of(int64_t N, int64_t n, int C) {
  const Schedule s = schedule_of(n);
  const int64_t nb = n_blocks_of(N);
  Layout l;
  l.counts = kCounters;
  l.status = l.counts + (int64_t)s.passes * kBins;
  l.seg_flag = l.status + (int64_t)s.passes * 2 * nb * kBins;
  l.zeroed = round4(l.seg_flag + nb);
  l.keys0 = l.zeroed;
  l.lanes0 = l.keys0 + round4(N);
  l.keys1 = l.lanes0 + round4(N);
  l.lanes1 = l.keys1 + round4(N);
  l.head = l.lanes1 + round4(N);
  l.tail = l.head + nb * C;
  l.total = l.tail + nb * C;
  return l;
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
cudaError_t launch_sorted(const float* g, const int32_t* keys,
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

template <int C>
cudaError_t launch_radix(const float* g, const int64_t* idx, int64_t N,
                         int64_t n, unsigned* scratch, float* d_table,
                         cudaStream_t stream) {
  const Schedule s = schedule_of(n);
  const Layout l = layout_of(N, n, C);
  SortArgs a;
  a.g = g;
  a.idx = idx;
  a.N = N;
  a.n = n;
  a.passes = s.passes;
  a.bits = s.bits;
  a.digit_bits = s.digit_bits;
  a.nb = n_blocks_of(N);
  a.nz = (n * C + kZeroFloats - 1) / kZeroFloats;
  a.ctr = scratch;
  a.counts = scratch + l.counts;
  a.status = scratch + l.status;
  a.seg_flag = scratch + l.seg_flag;
  a.keys[0] = reinterpret_cast<int32_t*>(scratch + l.keys0);
  a.lanes[0] = reinterpret_cast<int32_t*>(scratch + l.lanes0);
  a.keys[1] = reinterpret_cast<int32_t*>(scratch + l.keys1);
  a.lanes[1] = reinterpret_cast<int32_t*>(scratch + l.lanes1);
  a.head_part = reinterpret_cast<float*>(scratch + l.head);
  a.tail_part = reinterpret_cast<float*>(scratch + l.tail);
  a.d_table = d_table;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)l.zeroed * 4, stream);
  if (err != cudaSuccess) return err;
  for (int p = 0; p < s.passes; ++p) {
    a.pass = p;
    const int64_t grid = (p == 0 ? a.nb + a.nz : 0) + a.nb +
                         (p == s.passes - 1 ? a.nb : 0);
    lut_sort_kernel<C><<<(unsigned)grid, kTile, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// 4-byte words of scratch nart_lut_large_bwd needs
extern "C" int64_t nart_lut_large_bwd_scratch(int64_t N, int64_t n, int C) {
  return layout_of(N, n, C).total;
}

// where nart_lut_large_bwd's radix sort leaves the sorted rows and the
// lane of each sorted position in its scratch: at[0], at[1] (4-byte words)
extern "C" void nart_lut_large_bwd_order(int64_t N, int64_t n, int C,
                                         int64_t* at) {
  const Layout l = layout_of(N, n, C);
  const bool odd = (schedule_of(n).passes - 1) & 1;
  at[0] = odd ? l.keys1 : l.keys0;
  at[1] = odd ? l.lanes1 : l.lanes0;
}

// g (N, C), idx (N,) int64 (clamped to [0, n - 1] here), scratch of
// nart_lut_large_bwd_scratch words, d_table (n, C) 16-byte aligned
extern "C" int nart_lut_large_bwd(const float* g, const int64_t* idx,
                                  int64_t N, int64_t n, int C, void* scratch,
                                  float* d_table, cudaStream_t stream) {
  if (bad_args(N, n, C) || N > kMaxLanes ||
      (reinterpret_cast<uintptr_t>(d_table) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)by_width(C, [&](auto w) {
    return launch_radix<decltype(w)::value>(
        g, idx, N, n, static_cast<unsigned*>(scratch), d_table, stream);
  });
}

// floats of scratch nart_lut_large_bwd_sorted needs: head_part and
// tail_part, (n_blocks, C) each
extern "C" int64_t nart_lut_large_bwd_sorted_scratch(int64_t N, int C) {
  return 2 * n_blocks_of(N) * C;
}

// keys: the lanes' rows, clamped to [0, n - 1], sorted ascending; perm:
// the lane of each sorted position (a stable sort's indices)
extern "C" int nart_lut_large_bwd_sorted(const float* g, const int32_t* keys,
                                         const int64_t* perm, int64_t N,
                                         int64_t n, int C, float* scratch,
                                         float* d_table,
                                         cudaStream_t stream) {
  if (bad_args(N, n, C)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(
      d_table, 0, (size_t)n * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)by_width(C, [&](auto w) {
    return launch_sorted<decltype(w)::value>(g, keys, perm, N, scratch,
                                             d_table, stream);
  });
}

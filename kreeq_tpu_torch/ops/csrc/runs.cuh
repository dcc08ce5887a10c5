// Shared device code of the run kernels (count_runs.cu, merge_sorted.cu)
// and the probes (probe_qv.cu, probe_select.cu, probe_sorted.cu): the key
// and counter conventions, binary search, the probes' counter selection,
// and the three-pass "run head" scan that gives each run of equal keys
// its output slot.
//
// Conventions (kreeq_tpu_torch/constants.py): a key is int64 holding
// u64 ^ 2^63, so signed order is the packed k-mer order and the
// SENTINEL (no key) is INT64_MAX.  Counters are int64 in [0, 2^32 - 1].
// Every index is int64: row counts pass 2^31 in later slices.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace kq {
// Internal linkage: every .cu file of the library includes this header.
namespace {

constexpr int64_t SENT = INT64_MAX;
constexpr int64_t LARGEST = 0xFFFFFFFFll;

// Records per block of the run kernels: one record per thread.
constexpr int TILE = 256;
constexpr int SCAN_THREADS = 1024;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ int64_t lower_bound(const int64_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The edge counter a probe's ctx selector names: 1-4 = fw0-3, 5-8 =
// bw0-3 of table row `row` (fw, bw are [t, 4] row-major).
__device__ __forceinline__ int64_t selected(const int64_t* fw,
                                            const int64_t* bw, int64_t row,
                                            int sel) {
  return sel <= 4 ? fw[4 * row + sel - 1] : bw[4 * row + sel - 5];
}

__device__ __forceinline__ int64_t upper_bound(const int64_t* a, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A run head is the first row of a run of equal non-SENTINEL keys.
__device__ __forceinline__ bool is_head(const int64_t* keys, int64_t i) {
  int64_t key = keys[i];
  return key != SENT && (i == 0 || keys[i - 1] != key);
}

// Pass 1: the number of run heads in each TILE-row block.
__global__ void head_counts(const int64_t* __restrict__ keys, int64_t n,
                            int64_t* __restrict__ block_counts) {
  int64_t i = (int64_t)blockIdx.x * TILE + threadIdx.x;
  int c = __syncthreads_count(i < n && is_head(keys, i));
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

// Pass 2: exclusive scan of the block counts, in place, by one block
// that walks them SCAN_THREADS at a time; the grand total (the number of
// output rows) goes to *total.
__global__ void scan_blocks(int64_t* __restrict__ counts, int64_t nblocks,
                            int64_t* __restrict__ total) {
  __shared__ int64_t warp_sums[SCAN_THREADS / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nblocks; base += SCAN_THREADS) {
    int64_t i = base + threadIdx.x;
    int64_t v = i < nblocks ? counts[i] : 0;
    int64_t x = v;
    for (int off = 1; off < 32; off <<= 1) {
      int64_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t w = warp_sums[lane];
      for (int off = 1; off < 32; off <<= 1) {
        int64_t y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    int64_t incl = carry + x + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < nblocks) counts[i] = incl - v;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == SCAN_THREADS - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

// Pass 3 helper: the number of run heads before row i (all of the
// grid's), given this block's exclusive offset.  Every thread of the
// block must call it.
__device__ __forceinline__ int64_t heads_before(bool flag,
                                                int64_t block_offset) {
  __shared__ int warp_heads[TILE / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_heads[warp] = __popc(m);
  __syncthreads();
  int before = __popc(m & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += warp_heads[w];
  return block_offset + before;
}

// Rows [*start, n) (all rows when start is null) become SENTINEL rows
// with zero counters.
__global__ void fill_rows(int64_t* __restrict__ keys,
                          int64_t* __restrict__ cov,
                          int64_t* __restrict__ fw, int64_t* __restrict__ bw,
                          int64_t n, const int64_t* __restrict__ start) {
  int64_t s = start ? *start : 0;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i < s) continue;
    keys[i] = SENT;
    cov[i] = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      fw[4 * i + w] = 0;
      bw[4 * i + w] = 0;
    }
  }
}

inline void launch_fill(int64_t* keys, int64_t* cov, int64_t* fw,
                        int64_t* bw, int64_t n, const int64_t* start,
                        cudaStream_t stream) {
  if (n == 0) return;
  int64_t blocks = ceil_div(n, 256);
  if (blocks > 65536) blocks = 65536;
  fill_rows<<<(unsigned)blocks, 256, 0, stream>>>(keys, cov, fw, bw, n, start);
}

// Passes 1 and 2 over keys[0, n): block_offsets[b] = run heads before
// block b, *total = all run heads.  block_offsets holds
// ceil(n / TILE) entries.
inline void launch_head_scan(const int64_t* keys, int64_t n,
                             int64_t* block_offsets, int64_t* total,
                             cudaStream_t stream) {
  int64_t nblocks = ceil_div(n, TILE);
  if (nblocks > 0)
    head_counts<<<(unsigned)nblocks, TILE, 0, stream>>>(keys, n,
                                                        block_offsets);
  scan_blocks<<<1, SCAN_THREADS, 0, stream>>>(block_offsets, nblocks, total);
}

}  // namespace
}  // namespace kq

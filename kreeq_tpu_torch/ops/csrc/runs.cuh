// Shared device code of the run kernels (count_runs.cu, merge_sorted.cu)
// and the probes (probe_qv.cu, probe_select.cu, probe_sorted.cu): the key
// and counter conventions, the search through a table's bucket
// directory, the probes' counter selection, a block-wide scan,
// the one-block scan of per-tile counts that gives
// each tile its first output row, the asynchronous shared-memory copy
// and the SENTINEL fill of an output's tail.
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
constexpr unsigned FULL = 0xffffffffu;

constexpr int SCAN_THREADS = 1024;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Keys of a bucket read in one round trip by bucket_find.
constexpr int BUCKET_SCAN = 8;

// The row of `key` in a sorted table (keys 16-byte aligned) through its
// bucket directory (kreeq_tpu_torch/ops/index.py): starts [nb + 1], the
// bucket of a key its top bits, (u64)(key ^ INT64_MIN) >> shift.
// Returns -1 when the table does not hold the key (a SENTINEL key
// never matches).  One load pair of the directory (L2-resident), then
// the bucket's keys in aligned 16-byte loads issued together; a bucket
// longer than BUCKET_SCAN (a poly-A pile, low complexity) is bisected
// down to that first, with no bound on the steps.
__device__ __forceinline__ int64_t bucket_find(
    const int64_t* __restrict__ keys, const int64_t* __restrict__ starts,
    int64_t nb, int shift, int64_t key) {
  uint64_t b = (static_cast<uint64_t>(key) ^ (1ull << 63)) >> shift;
  if (key == SENT || b >= static_cast<uint64_t>(nb)) return -1;
  int64_t lo = __ldg(starts + b), hi = __ldg(starts + b + 1);
  while (hi - lo > BUCKET_SCAN) {
    int64_t mid = lo + ((hi - lo) >> 1);
    int64_t v = __ldg(keys + mid);
    if (v == key) return mid;
    if (v < key) lo = mid + 1; else hi = mid;
  }
  // rows [lo, hi) in pairs from the even row at or below lo: a key of
  // another bucket, or the SENTINEL filler past hi, never equals `key`,
  // so a match needs no range test.  Nothing at or past hi is read (hi
  // may be the table's end).
  const longlong2* pairs = reinterpret_cast<const longlong2*>(keys);
  const int64_t p0 = lo >> 1;
  longlong2 v[BUCKET_SCAN / 2 + 1];
#pragma unroll
  for (int j = 0; j < BUCKET_SCAN / 2 + 1; ++j) {
    int64_t i = 2 * (p0 + j);
    if (i + 1 < hi)
      v[j] = __ldg(pairs + p0 + j);
    else
      v[j] = make_longlong2(i < hi ? __ldg(keys + i) : SENT, SENT);
  }
  int64_t row = -1;
#pragma unroll
  for (int j = 0; j < BUCKET_SCAN / 2 + 1; ++j) {
    int64_t i = 2 * (p0 + j);
    if (v[j].x == key) row = i;
    if (v[j].y == key) row = i + 1;
  }
  return row;
}

// The edge counter a probe's ctx selector names: 1-4 = fw0-3, 5-8 =
// bw0-3 of table row `row` (fw, bw are [t, 4] row-major).  A streaming
// load (evict first): a random row is read once, and must not push the
// bucket directory out of L2.
__device__ __forceinline__ int64_t selected(const int64_t* fw,
                                            const int64_t* bw, int64_t row,
                                            int sel) {
  return __ldcs(sel <= 4 ? fw + 4 * row + sel - 1 : bw + 4 * row + sel - 5);
}

__device__ __forceinline__ int64_t add_sat(int64_t a, int64_t b) {
  int64_t s = a + b;
  return s < LARGEST ? s : LARGEST;
}

// Exclusive scan of one value per thread over a block of NT threads
// (a multiple of 32); *total gets the block's sum.  Every thread must
// call it; `tmp` is NT / 32 entries of shared memory.
template <int NT, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total, T* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  T before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    T s = tmp[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();  // tmp may be reused
  *total = all;
  return before + x - v;
}

// Exclusive scan of per-tile counts, in place, by one block that walks
// them SCAN_THREADS at a time; the grand total (the number of output
// rows) goes to *total.
__global__ void scan_blocks(int64_t* __restrict__ counts, int64_t nblocks,
                            int64_t* __restrict__ total) {
  __shared__ int64_t tmp[SCAN_THREADS / 32];
  int64_t carry = 0;
  for (int64_t base = 0; base < nblocks; base += SCAN_THREADS) {
    int64_t i = base + threadIdx.x;
    int64_t v = i < nblocks ? counts[i] : 0, sum;
    int64_t before = block_exclusive_scan<SCAN_THREADS>(v, &sum, tmp);
    if (i < nblocks) counts[i] = carry + before;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

// 8-byte asynchronous copy from device memory to shared memory; the
// copies of a thread complete at cp_async_wait_all.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows [*start, n) (all rows when start is null) become SENTINEL rows
// with zero counters.  Every store is coalesced: keys and cov 8 bytes a
// thread, fw and bw (16-byte aligned, as allocated by the wrappers) 16.
__global__ void fill_rows(int64_t* __restrict__ keys,
                          int64_t* __restrict__ cov,
                          int64_t* __restrict__ fw, int64_t* __restrict__ bw,
                          int64_t n, const int64_t* __restrict__ start) {
  int64_t s = start ? *start : 0;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = s + t; i < n; i += stride) {
    keys[i] = SENT;
    cov[i] = 0;
  }
  longlong2* fw2 = reinterpret_cast<longlong2*>(fw);
  longlong2* bw2 = reinterpret_cast<longlong2*>(bw);
  const longlong2 zero = make_longlong2(0, 0);
  for (int64_t i = 2 * s + t; i < 2 * n; i += stride) {
    fw2[i] = zero;
    bw2[i] = zero;
  }
}

inline void launch_fill(int64_t* keys, int64_t* cov, int64_t* fw,
                        int64_t* bw, int64_t n, const int64_t* start,
                        cudaStream_t stream) {
  if (n == 0) return;
  int64_t blocks = ceil_div(n, 256);
  if (blocks > 132 * 16) blocks = 132 * 16;
  fill_rows<<<(unsigned)blocks, 256, 0, stream>>>(keys, cov, fw, bw, n, start);
}

}  // namespace
}  // namespace kq

// count_runs: run-aggregation of key-sorted k-mer records into a sorted
// unique table.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_kernel` (:59, launched by
// `_run_pallas_x32` :221, wrapped by `count_sorted_pallas`), the contract of
// kreeq_tpu/ops/kmers.py `count_sorted` after its sort.  The sort is a
// kernel of its own (sort_records.cu).
//
// Input: P sorted int64 keys (SENTINEL rows last) and P uint8 edge bytes.
// Output: for each distinct key, compacted to the front: the key,
// cov = run length, fw[w] = records with edge bit w, bw[w] = records
// with edge bit 4+w; SENTINEL rows with zero counters after them; and n.
//
// Bound on the H100: memory traffic.  A key read per record (8 B), the
// edge byte of each real record, and 80 B written per output row, P
// rows: at most 89 B x P, 747 MB or 0.22 ms at 3.35 TB/s for an
// 8,388,608-record chunk; there is no arithmetic to speak of.  This
// design moves about 97 B a record: the keys are read twice.
//
// Design: tiles of CTILE records, every real output row written once
// with plain stores, no atomics.
//  - count_heads: each block counts the run heads of its tile (a real
//    key that differs from the key before it); scan_blocks turns the
//    counts into each tile's first output row and n.
//  - count_write: each block stages its tile's keys and edge bytes in
//    shared memory, flags the heads, and scans the flags and the edge
//    bits packed four 16-bit fields to a word (fw bits in one word, bw
//    bits in the other; a tile adds at most CTILE per field).  A run's
//    fw/bw counts are the difference of the scanned words at its head
//    and at the next head (or the tile's total for the last run), and
//    cov the distance between the heads (or to the tile's first
//    SENTINEL), so a run inside the tile needs no sum of its own.  The
//    block that holds a run's head owns the run: when the tile's last
//    run reaches the tile's end, the block reads on from there in steps
//    of CT records growing fourfold to FWD x CT, until the key changes,
//    so a pile of 10^6 records of one key is one block reading about
//    9 MB in about 65 steps.
//    Neighbouring threads write neighbouring rows of okeys and ocov and
//    neighbouring 16-byte halves of the fw and bw rows.
//  - fill_rows writes the SENTINEL tail [n, P) once.
// It replaces a design that filled all P rows first, then added each
// warp's part of a run into its row with up to nine 64-bit atomic adds.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int CT = 256;          // threads of a count tile
constexpr int CI = 4;            // records per thread
constexpr int CTILE = CT * CI;   // records per tile
constexpr int FWD = 64;          // most records per thread in a read-on step
constexpr int BATCH = 16;        // loads per thread in flight while reading on

using u64 = unsigned long long;

// Bits 0-3 of x, one to each 16-bit field of a word.
__device__ __forceinline__ u64 spread4(unsigned x) {
  return (u64)(x & 1u) | (u64)(x >> 1 & 1u) << 16 | (u64)(x >> 2 & 1u) << 32 |
         (u64)(x >> 3 & 1u) << 48;
}

__device__ __forceinline__ int64_t field(u64 w, int f) {
  return (int64_t)(w >> (16 * f) & 0xffffu);
}

__global__ void __launch_bounds__(CT) count_heads(
    const int64_t* __restrict__ skeys, int64_t p,
    int64_t* __restrict__ tile_rows) {
  __shared__ int tmp[CT / 32];
  const int64_t base = (int64_t)blockIdx.x * CTILE;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < CI; ++k) {
    int64_t i = base + threadIdx.x + k * CT;
    if (i < p) {
      int64_t key = skeys[i];
      mine += key != SENT && (i == 0 || skeys[i - 1] != key);
    }
  }
  int all;
  block_exclusive_scan<CT>(mine, &all, tmp);
  if (threadIdx.x == 0) tile_rows[blockIdx.x] = all;
}

__global__ void __launch_bounds__(CT) count_write(
    const int64_t* __restrict__ skeys, const uint8_t* __restrict__ sedges,
    int64_t p, const int64_t* __restrict__ tile_rows,
    int64_t* __restrict__ okeys, int64_t* __restrict__ ocov,
    int64_t* __restrict__ ofw, int64_t* __restrict__ obw) {
  __shared__ int64_t sk[CTILE];
  __shared__ __align__(4) uint8_t head[CTILE];
  __shared__ __align__(4) uint8_t edge[CTILE];  // 0 for SENTINEL records
  // per run, the scanned fw and bw words at its head; [nh]: the tile's
  // totals
  __shared__ u64 cfw[CTILE + 1], cbw[CTILE + 1];
  __shared__ uint16_t hp[CTILE + 1];  // run -> head position; [nh]: nreal
  __shared__ int64_t more[9];  // the last run past the tile: cov, fw, bw
  __shared__ int64_t before_tile;
  __shared__ int itmp[CT / 32];
  __shared__ u64 wtmp[CT / 32];

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * CTILE;
  if (tid == 0) before_tile = base > 0 ? skeys[base - 1] : SENT;
  if (tid < 9) more[tid] = 0;
  int real = 0;
#pragma unroll
  for (int k = 0; k < CI; ++k) {
    int j = tid + k * CT;
    int64_t i = base + j;
    // both loads issued at once: past the input, row base again
    int64_t key = skeys[i < p ? i : base];
    unsigned e = sedges[i < p ? i : base];
    if (i >= p) key = SENT;
    sk[j] = key;
    edge[j] = key != SENT ? e : 0;
    real += key != SENT;
  }
  int nreal;  // real records of the tile; SENTINEL rows come last
  block_exclusive_scan<CT>(real, &nreal, itmp);
#pragma unroll
  for (int k = 0; k < CI; ++k) {
    int j = tid + k * CT;
    int64_t key = sk[j];
    head[j] = key != SENT && key != (j > 0 ? sk[j - 1] : before_tile);
  }
  __syncthreads();

  // this thread's CI consecutive records: heads and edge bits
  const unsigned f4 = *reinterpret_cast<const unsigned*>(&head[CI * tid]);
  const unsigned e4 = *reinterpret_cast<const unsigned*>(&edge[CI * tid]);
  u64 lo = 0, hi = 0, lo_at[CI], hi_at[CI];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < CI; ++k) {
    lo_at[k] = lo;
    hi_at[k] = hi;
    unsigned e = e4 >> (8 * k) & 0xffu;
    lo += spread4(e & 15u);
    hi += spread4(e >> 4);
    mine += f4 >> (8 * k) & 1u;
  }
  int nh;
  u64 lo_all, hi_all;
  int rank = block_exclusive_scan<CT>(mine, &nh, itmp);
  u64 lo_before = block_exclusive_scan<CT>(lo, &lo_all, wtmp);
  u64 hi_before = block_exclusive_scan<CT>(hi, &hi_all, wtmp);
#pragma unroll
  for (int k = 0; k < CI; ++k) {
    if (f4 >> (8 * k) & 1u) {
      hp[rank] = (uint16_t)(CI * tid + k);
      cfw[rank] = lo_before + lo_at[k];
      cbw[rank] = hi_before + hi_at[k];
      ++rank;
    }
  }
  if (tid == 0) {
    hp[nh] = (uint16_t)nreal;
    cfw[nh] = lo_all;
    cbw[nh] = hi_all;
  }
  __syncthreads();

  // the tile's last run goes on past its end: read on until the key
  // changes (the condition is the same in every thread)
  if (nh > 0 && nreal == CTILE && base + CTILE < p) {
    const int64_t key = sk[CTILE - 1];
    int64_t pos = base + CTILE;
    for (int per = 1;; per = per * 4 < FWD ? per * 4 : FWD) {
      int same = 0;
      u64 flo = 0, fhi = 0;
      for (int k0 = 0; k0 < per; k0 += BATCH) {
        // BATCH independent loads of each kind in flight, then the tests
        // (a record past the step or the input loads row `pos` again)
        int64_t kk[BATCH];
        unsigned ee[BATCH];
        bool in[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          int64_t i = pos + tid + (int64_t)(k0 + u) * CT;
          in[u] = k0 + u < per && i < p;
          kk[u] = skeys[in[u] ? i : pos];
          ee[u] = sedges[in[u] ? i : pos];
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          if (in[u] && kk[u] == key) {
            ++same;
            flo += spread4(ee[u] & 15u);
            fhi += spread4(ee[u] >> 4);
          }
        }
      }
      int same_all;
      u64 flo_all, fhi_all;
      block_exclusive_scan<CT>(same, &same_all, itmp);
      block_exclusive_scan<CT>(flo, &flo_all, wtmp);
      block_exclusive_scan<CT>(fhi, &fhi_all, wtmp);
      if (tid == 0) {
        more[0] += same_all;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          more[1 + f] += field(flo_all, f);
          more[5 + f] += field(fhi_all, f);
        }
      }
      pos += (int64_t)per * CT;
      // equal keys are contiguous: a short step is the run's end
      if (same_all < per * CT || pos >= p) break;
    }
    __syncthreads();
  }

  const int64_t off = tile_rows[blockIdx.x];
  for (int r = tid; r < nh; r += CT) {
    okeys[off + r] = sk[hp[r]];
    ocov[off + r] = hp[r + 1] - hp[r] + (r == nh - 1 ? more[0] : 0);
  }
  longlong2* ofw2 = reinterpret_cast<longlong2*>(ofw);
  longlong2* obw2 = reinterpret_cast<longlong2*>(obw);
  for (int q = tid; q < 2 * nh; q += CT) {
    int r = q >> 1, f = 2 * (q & 1);
    u64 dfw = cfw[r + 1] - cfw[r], dbw = cbw[r + 1] - cbw[r];
    int64_t f0 = field(dfw, f), f1 = field(dfw, f + 1);
    int64_t g0 = field(dbw, f), g1 = field(dbw, f + 1);
    if (r == nh - 1) {
      f0 += more[1 + f];
      f1 += more[2 + f];
      g0 += more[5 + f];
      g1 += more[6 + f];
    }
    ofw2[2 * (off + r) + (q & 1)] = make_longlong2(f0, f1);
    obw2[2 * (off + r) + (q & 1)] = make_longlong2(g0, g1);
  }
}

}  // namespace
}  // namespace kq

// Records of a tile; the wrapper sizes the scratch from it.
extern "C" int kq_count_tile() { return kq::CTILE; }

// skeys/sedges: P sorted records.  okeys [P], ocov [P], ofw/obw [P, 4]
// (16-byte aligned): outputs; n_out: one int64; scratch:
// ceil(P / kq_count_tile()) int64.
extern "C" int kq_count_runs(const int64_t* skeys, const uint8_t* sedges,
                             int64_t p, int64_t* okeys, int64_t* ocov,
                             int64_t* ofw, int64_t* obw, int64_t* n_out,
                             int64_t* scratch, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t ntiles = ceil_div(p, CTILE);
  if (ntiles > 0)
    count_heads<<<(unsigned)ntiles, CT, 0, s>>>(skeys, p, scratch);
  scan_blocks<<<1, SCAN_THREADS, 0, s>>>(scratch, ntiles, n_out);
  if (ntiles > 0)
    count_write<<<(unsigned)ntiles, CT, 0, s>>>(skeys, sedges, p, scratch,
                                                okeys, ocov, ofw, obw);
  launch_fill(okeys, ocov, ofw, obw, p, n_out, s);
  return (int)cudaGetLastError();
}

extern "C" const char* kq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

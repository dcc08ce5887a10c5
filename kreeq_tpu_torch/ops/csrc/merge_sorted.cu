// merge_sorted: union of two sorted unique k-mer tables with saturating
// adds.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_merge_kernel2` (:1223,
// launched by `_merge_run2_x32` :1422, wrapped by `merge_sorted_pallas`),
// the contract of kreeq_tpu/ops/kmers.py `merge_sorted`: an output of
// na + nb rows, the merged unique keys first, equal keys summed with
// saturation at 0xFFFFFFFF, then SENTINEL rows with zero counters; plus
// n.  Either input may carry a SENTINEL tail; SENTINEL rows never yield
// a row.
//
// Bound on the H100: memory traffic.  Each input key is read once (8 B),
// the counters of each real input row once (72 B; a SENTINEL row has
// none to read) and each output row written once (80 B): 160 B a row
// of na + nb when both inputs are trimmed.  The 12 Mbp build's largest
// merge (40.6M rows, 15.9M of them a SENTINEL tail) needs 5.35 GB,
// 1.60 ms at 3.35 TB/s.  This design moves 8 B a row more: the keys are
// read twice.
//
// Design (merge path; the TPU kernel's counterpart is the visit list of
// (A tile, B span) pairs that `_merge_prep_t` builds outside it):
//  - merge_partition: one thread per tile of MTILE merged positions
//    finds the tile's start (a_i, b_i) by a binary search along its
//    diagonal; ties go to A, so an equal pair is (A row, B row).  This
//    is the only search in device memory: one per tile, not per row.
//  - merge_tiles<false>: each block copies its tile's contiguous A and B
//    key ranges into shared memory (cp.async), each thread merges MI
//    positions after a short merge-path search in shared memory, and the
//    block counts its run heads: real keys that differ from the merged
//    key before them.  The key before the tile is the larger of the last
//    A and B rows consumed before it, so the B half of a pair that
//    straddles a tile seam is never a head and the pair yields one row.
//  - scan_blocks turns the per-tile head counts into each tile's first
//    output row and n.
//  - merge_tiles<true> repeats the merge and writes each head's row
//    once: an A head sums in the B row that follows it when the keys are
//    equal (in the tile, or the first B row after it at a tile's end).
//    Neighbouring threads write neighbouring rows of okeys and ocov and
//    neighbouring 16-byte halves of the fw and bw rows.
//  - fill_rows writes the SENTINEL tail [n, na + nb) once.
// It replaces a design that placed every row by a binary search over
// the other input into a merged buffer (72 B a row), then compacted it.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int MT = 256;           // threads of a merge tile
constexpr int MI = 8;             // merged positions per thread
constexpr int MTILE = MT * MI;    // merged positions per tile

// Rows of A among the first d merged rows, ties to A: the least i with
// A[i] > B[d - 1 - i] (A[i] then merges after B[d - 1 - i]).
template <typename I>
__device__ __forceinline__ I merge_path(const int64_t* a, I na,
                                        const int64_t* b, I nb, I d) {
  I lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    I mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_partition(const int64_t* __restrict__ ka, int64_t na,
                                const int64_t* __restrict__ kb, int64_t nb,
                                int64_t ntiles, int64_t* __restrict__ part) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  int64_t d = t * MTILE < na + nb ? t * MTILE : na + nb;
  part[t] = merge_path<int64_t>(ka, na, kb, nb, d);
}

template <bool WRITE>
__global__ void __launch_bounds__(MT) merge_tiles(
    const int64_t* __restrict__ ka, const int64_t* __restrict__ cova,
    const int64_t* __restrict__ fwa, const int64_t* __restrict__ bwa,
    int64_t na, const int64_t* __restrict__ kb,
    const int64_t* __restrict__ covb, const int64_t* __restrict__ fwb,
    const int64_t* __restrict__ bwb, int64_t nb,
    const int64_t* __restrict__ part, int64_t* __restrict__ tile_rows,
    int64_t* __restrict__ okeys, int64_t* __restrict__ ocov,
    int64_t* __restrict__ ofw, int64_t* __restrict__ obw) {
  __shared__ int64_t sk[MTILE];     // the tile's A keys, then its B keys
  __shared__ uint16_t src[MTILE];   // merged position -> index in sk
  __shared__ uint16_t hp[MTILE];    // head r of the tile -> its position
  __shared__ int64_t before_tile;   // merged key before the tile
  __shared__ int scan_tmp[MT / 32];

  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * MTILE;
  const int len = (int)(na + nb - d0 < MTILE ? na + nb - d0 : MTILE);
  const int64_t a0 = part[tile], b0 = d0 - a0;
  const int la = (int)(part[tile + 1] - a0), lb = len - la;

  for (int i = tid; i < len; i += MT)
    cp_async8(&sk[i], i < la ? ka + a0 + i : kb + b0 + (i - la));
  if (tid == 0) {
    // SENTINEL before the first tile: the first real key is a head
    int64_t k = SENT;
    if (a0 > 0) k = ka[a0 - 1];
    if (b0 > 0 && (a0 == 0 || kb[b0 - 1] > k)) k = kb[b0 - 1];
    before_tile = k;
  }
  cp_async_wait_all();
  __syncthreads();

  const int64_t* as = sk;
  const int64_t* bs = sk + la;
  const int first = tid * MI;
  int ia = first < len ? merge_path<int>(as, la, bs, lb, first) : la;
  int ib = first - ia;
#pragma unroll
  for (int k = 0; k < MI; ++k) {
    int p = first + k;
    if (p < len) {
      bool take_a = ia < la && (ib >= lb || as[ia] <= bs[ib]);
      src[p] = (uint16_t)(take_a ? ia++ : la + ib++);
    }
  }
  __syncthreads();

  unsigned flags = 0;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < MI; ++k) {
    int p = first + k;
    if (p < len) {
      int64_t key = sk[src[p]];
      int64_t prev = p > 0 ? sk[src[p - 1]] : before_tile;
      if (key != SENT && key != prev) {
        flags |= 1u << k;
        ++mine;
      }
    }
  }
  int nh;
  int rank = block_exclusive_scan<MT>(mine, &nh, scan_tmp);
  if constexpr (!WRITE) {
    if (tid == 0) tile_rows[tile] = nh;
  } else {
#pragma unroll
    for (int k = 0; k < MI; ++k)
      if (flags >> k & 1u) hp[rank++] = (uint16_t)(first + k);
    __syncthreads();

    const int64_t off = tile_rows[tile];
    // the source rows of head r: an A row and the equal B row after it,
    // or a B row alone (-1: none)
    auto rows = [&](int r, int64_t& ra, int64_t& rb) {
      int p = hp[r], s = src[p];
      if (s < la) {
        ra = a0 + s;
        int64_t j = d0 + p - ra;  // B rows merged before position p
        int64_t key = sk[s];
        bool pair = p + 1 < len ? sk[src[p + 1]] == key
                                : (j < nb && kb[j] == key);
        rb = pair ? j : -1;
      } else {
        ra = -1;
        rb = b0 + (s - la);
      }
    };
    for (int r = tid; r < nh; r += MT) {
      int64_t ra, rb;
      rows(r, ra, rb);
      okeys[off + r] = sk[src[hp[r]]];
      ocov[off + r] = add_sat(ra >= 0 ? cova[ra] : 0, rb >= 0 ? covb[rb] : 0);
    }
    longlong2* ofw2 = reinterpret_cast<longlong2*>(ofw);
    longlong2* obw2 = reinterpret_cast<longlong2*>(obw);
    for (int q = tid; q < 2 * nh; q += MT) {
      int r = q >> 1, h = 2 * (q & 1);
      int64_t ra, rb;
      rows(r, ra, rb);
      int64_t f0 = 0, f1 = 0, b0v = 0, b1v = 0;
      if (ra >= 0) {
        f0 = fwa[4 * ra + h];
        f1 = fwa[4 * ra + h + 1];
        b0v = bwa[4 * ra + h];
        b1v = bwa[4 * ra + h + 1];
      }
      if (rb >= 0) {
        f0 = add_sat(f0, fwb[4 * rb + h]);
        f1 = add_sat(f1, fwb[4 * rb + h + 1]);
        b0v = add_sat(b0v, bwb[4 * rb + h]);
        b1v = add_sat(b1v, bwb[4 * rb + h + 1]);
      }
      ofw2[2 * (off + r) + (q & 1)] = make_longlong2(f0, f1);
      obw2[2 * (off + r) + (q & 1)] = make_longlong2(b0v, b1v);
    }
  }
}

}  // namespace
}  // namespace kq

// Merged positions of a tile; the wrapper sizes the scratch from it.
extern "C" int kq_merge_tile() { return kq::MTILE; }

// A: ka [na], cova [na], fwa/bwa [na, 4]; B likewise.  scratch:
// 2 * ceil((na + nb) / kq_merge_tile()) + 1 int64 (tile starts, then
// head counts); okeys [na + nb], ocov, ofw, obw (16-byte aligned):
// outputs; n_out: one int64.
extern "C" int kq_merge_sorted(const int64_t* ka, const int64_t* cova,
                               const int64_t* fwa, const int64_t* bwa,
                               int64_t na, const int64_t* kb,
                               const int64_t* covb, const int64_t* fwb,
                               const int64_t* bwb, int64_t nb,
                               int64_t* scratch, int64_t* okeys,
                               int64_t* ocov, int64_t* ofw, int64_t* obw,
                               int64_t* n_out, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t m = na + nb;
  int64_t ntiles = ceil_div(m, MTILE);
  int64_t* part = scratch;               // ntiles + 1 tile starts in A
  int64_t* tile_rows = scratch + ntiles + 1;
  if (ntiles > 0) {
    merge_partition<<<(unsigned)ceil_div(ntiles + 1, 256), 256, 0, s>>>(
        ka, na, kb, nb, ntiles, part);
    merge_tiles<false><<<(unsigned)ntiles, MT, 0, s>>>(
        ka, cova, fwa, bwa, na, kb, covb, fwb, bwb, nb, part, tile_rows,
        okeys, ocov, ofw, obw);
  }
  scan_blocks<<<1, SCAN_THREADS, 0, s>>>(tile_rows, ntiles, n_out);
  if (ntiles > 0)
    merge_tiles<true><<<(unsigned)ntiles, MT, 0, s>>>(
        ka, cova, fwa, bwa, na, kb, covb, fwb, bwb, nb, part, tile_rows,
        okeys, ocov, ofw, obw);
  launch_fill(okeys, ocov, ofw, obw, m, n_out, s);
  return (int)cudaGetLastError();
}

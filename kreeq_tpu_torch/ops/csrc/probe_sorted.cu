// probe_sorted: the generic batched table lookup, in query order: for
// every query key, found, cov, fw[4] and bw[4] of its table row.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_probe_kernel` (launched by
// `_probe_run_x32`; `_probe_prep` sorts the queries with a 26-bit index
// before it, `_tile_spans` gives each query tile its table chunks, and
// `_probe_post` restores query order after it), wrapped by
// `probe_merge_pallas`, the drop-in of kreeq_tpu/ops/kmers.py
// `probe_merge` / `probe_sorted`.  Callers: the variants scan and
// `KmerTable.probe` (anomalies).
//
// Per query i < q: found = the key is among the table's keys (a
// SENTINEL query is never found; an empty table finds nothing); where
// found, cov, fw[0..3] and bw[0..3] are the row's counters; where not
// found, all nine are 0.
//
// Bound on the H100: latency of dependent loads, as in probe_qv.cu and
// probe_select.cu: a binary search of log2(t) steps per query through a
// table far larger than L2, then one 72-byte row read.  Design: the
// B3/B4 search core (`lower_bound` of runs.cuh), one thread per query,
// which writes its nine counters at its own position, so the writes of a
// warp are contiguous.  Everything around the TPU kernel existed for the
// TPU only and is gone: the query sort and its index packing, the tile
// spans, the u8-limb one-hot contraction on the MXU, the sorted-order
// restore and the packed-table cache.  SENTINEL queries skip the search.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int PROBE_THREADS = 256;

__global__ void probe_sorted(const int64_t* __restrict__ tkeys,
                             const int64_t* __restrict__ tcov,
                             const int64_t* __restrict__ tfw,
                             const int64_t* __restrict__ tbw, int64_t t,
                             const int64_t* __restrict__ qkeys, int64_t q,
                             uint8_t* __restrict__ found,
                             int64_t* __restrict__ cov,
                             int64_t* __restrict__ fw,
                             int64_t* __restrict__ bw) {
  int64_t i = (int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= q) return;
  int64_t key = qkeys[i];
  int64_t row = key == SENT ? t : lower_bound(tkeys, t, key);
  bool f = row < t && tkeys[row] == key;
  int64_t c = 0, vf[4] = {0, 0, 0, 0}, vb[4] = {0, 0, 0, 0};
  if (f) {
    c = tcov[row];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      vf[w] = tfw[4 * row + w];
      vb[w] = tbw[4 * row + w];
    }
  }
  found[i] = f;
  cov[i] = c;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    fw[4 * i + w] = vf[w];
    bw[4 * i + w] = vb[w];
  }
}

}  // namespace
}  // namespace kq

// Table: tkeys [t] sorted unique (a SENTINEL tail is allowed), tcov [t],
// tfw/tbw [t, 4].  Queries: qkeys [q].  Outputs, overwritten: found [q]
// (0/1 bytes), cov [q], fw [q, 4], bw [q, 4].
extern "C" int kq_probe_sorted(const int64_t* tkeys, const int64_t* tcov,
                               const int64_t* tfw, const int64_t* tbw,
                               int64_t t, const int64_t* qkeys, int64_t q,
                               uint8_t* found, int64_t* cov, int64_t* fw,
                               int64_t* bw, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t nblocks = ceil_div(q, PROBE_THREADS);
  if (nblocks > 0)
    probe_sorted<<<(unsigned)nblocks, PROBE_THREADS, 0, s>>>(
        tkeys, tcov, tfw, tbw, t, qkeys, q, found, cov, fw, bw);
  return (int)cudaGetLastError();
}

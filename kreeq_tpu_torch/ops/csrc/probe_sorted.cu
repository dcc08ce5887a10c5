// probe_sorted: the generic batched table lookup, in query order: for
// every query key, found, cov, fw[4] and bw[4] of its table row.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_probe_kernel` (launched by
// `_probe_run_x32`; `_probe_prep` sorts the queries with a 26-bit index
// before it, `_tile_spans` gives each query tile its table chunks, and
// `_probe_post` restores query order after it), wrapped by
// `probe_merge_pallas`, the drop-in of kreeq_tpu/ops/kmers.py
// `probe_merge` / `probe_sorted`.  Callers: the variants scan, the
// anomaly scan and every subgraph probe, through `KmerTable.probe_device`.
//
// Per query i < q: found = the key is among the table's keys (a
// SENTINEL query is never found; an empty table finds nothing); where
// found, cov, fw[0..3] and bw[0..3] are the row's counters; where not
// found, all nine are 0.
//
// Bound on the H100: random 32-byte sectors, in 3 dependent round trips
// a query, as in probe_select.cu: the bucket directory (L2), the
// bucket's keys, then the found row's cov, fw row and bw row; plus 81
// streamed bytes a query (the key in; found, cov, fw, bw out).  Design:
// one thread a query, the B3/B4 search through the table's bucket
// directory (ops/index.py, runs.cuh::bucket_find); a found row's cov and
// its fw and bw rows (32 bytes each, one sector) as one 8-byte and four
// 16-byte streaming loads issued together; the outputs as streaming
// stores (8 bytes of cov, two 16-byte halves of fw and of bw, at the
// query's own position, so a warp's stores cover neighbouring queries).
// Streaming loads and stores keep the 32 MB directory in L2 while the
// random rows and the outputs pass through.  Query keys past the
// directory (the per-position sentinels of the variants scan at k < 32)
// and SENTINEL queries skip the search.  Everything around the TPU
// kernel existed for the TPU only and is gone: the query sort and its
// index packing, the tile spans, the u8-limb one-hot contraction on the
// MXU, the sorted-order restore and the packed-table cache.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int PROBE_THREADS = 256;

__global__ void probe_sorted(const int64_t* __restrict__ tkeys,
                             const int64_t* __restrict__ tcov,
                             const int64_t* __restrict__ tfw,
                             const int64_t* __restrict__ tbw,
                             const int64_t* __restrict__ starts, int64_t nb,
                             int shift, const int64_t* __restrict__ qkeys,
                             int64_t q, uint8_t* __restrict__ found,
                             int64_t* __restrict__ cov,
                             int64_t* __restrict__ fw,
                             int64_t* __restrict__ bw) {
  const int64_t i = (int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= q) return;
  const int64_t row = bucket_find(tkeys, starts, nb, shift, __ldcs(qkeys + i));

  const longlong2* tfw2 = reinterpret_cast<const longlong2*>(tfw);
  const longlong2* tbw2 = reinterpret_cast<const longlong2*>(tbw);
  const longlong2 zero = make_longlong2(0, 0);
  const int64_t c = row >= 0 ? __ldcs(tcov + row) : 0;
  const longlong2 f0 = row >= 0 ? __ldcs(tfw2 + 2 * row) : zero;
  const longlong2 f1 = row >= 0 ? __ldcs(tfw2 + 2 * row + 1) : zero;
  const longlong2 b0 = row >= 0 ? __ldcs(tbw2 + 2 * row) : zero;
  const longlong2 b1 = row >= 0 ? __ldcs(tbw2 + 2 * row + 1) : zero;

  longlong2* fw2 = reinterpret_cast<longlong2*>(fw);
  longlong2* bw2 = reinterpret_cast<longlong2*>(bw);
  __stcs(found + i, static_cast<uint8_t>(row >= 0));
  __stcs(cov + i, c);
  __stcs(fw2 + 2 * i, f0);
  __stcs(fw2 + 2 * i + 1, f1);
  __stcs(bw2 + 2 * i, b0);
  __stcs(bw2 + 2 * i + 1, b1);
}

}  // namespace
}  // namespace kq

// Table: tkeys [t] sorted unique (a SENTINEL tail is allowed), tcov [t],
// tfw/tbw [t, 4], tkeys, tfw and tbw 16-byte aligned; its bucket
// directory (ops/index.py): starts [nb + 1] and shift.  Queries: qkeys
// [q].  Outputs, overwritten: found [q] (0/1 bytes), cov [q], fw [q, 4],
// bw [q, 4] (16-byte aligned).
extern "C" int kq_probe_sorted(const int64_t* tkeys, const int64_t* tcov,
                               const int64_t* tfw, const int64_t* tbw,
                               const int64_t* starts, int64_t nb,
                               int64_t shift, const int64_t* qkeys,
                               int64_t q, uint8_t* found, int64_t* cov,
                               int64_t* fw, int64_t* bw, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t nblocks = ceil_div(q, PROBE_THREADS);
  if (nblocks > 0)
    probe_sorted<<<(unsigned)nblocks, PROBE_THREADS, 0, s>>>(
        tkeys, tcov, tfw, tbw, starts, nb, (int)shift, qkeys, q, found, cov,
        fw, bw);
  return (int)cudaGetLastError();
}

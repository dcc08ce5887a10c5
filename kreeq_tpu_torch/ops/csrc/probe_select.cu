// probe_select: table lookup of assembly k-mer positions with the two
// ctx-selected edge counters, in position order (per-base tracks).
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_probe_kernel_sel2`
// (launched by `_probe_run_sel2_x32`; `_probe_prep_sel` sorts the
// queries before it and `_probe_post_sel2` restores query order after
// it), wrapped by kreeq_tpu/ops/validate.py `validate_positions_pallas`.
//
// Per position i < q: found = the key is among the table's keys (a
// SENTINEL query, i.e. an invalid window, is never found; an empty
// table finds nothing); where found, cov = the row's cov, right / left =
// the counters named by the ctx selectors (bits 0-3 / 4-7: 1-4 = fw0-3,
// 5-8 = bw0-3, 0 = none, giving 0); where not found, all three are 0.
// The classification into missing / edge-missing stays in PyTorch
// (ops/validate.py _classify_sel).
//
// Bound on the H100: random 32-byte sectors, in 3 dependent round trips
// a position, as in probe_qv.cu: the bucket directory (L2), the bucket's
// keys, then the row's cov and its two selected counters.  Design: the
// probe_qv search, one thread per position through the table's bucket
// directory (ops/index.py, runs.cuh::bucket_find), then cov and both
// selected counters in streaming loads issued together, so that they
// cost one round trip and do not evict the directory; no query sort and
// no restore (the TPU kernel sorted the queries so that table tiles
// stream, contracted u8/u16 limbs on the MXU and restored query order
// with a keyed sort; none of that is needed when every thread searches
// the table itself).  Writes are coalesced: thread i writes element i of
// each output.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int SELECT_THREADS = 256;

__global__ void probe_select(const int64_t* __restrict__ tkeys,
                             const int64_t* __restrict__ tcov,
                             const int64_t* __restrict__ tfw,
                             const int64_t* __restrict__ tbw,
                             const int64_t* __restrict__ starts, int64_t nb,
                             int shift, const int64_t* __restrict__ qkeys,
                             const uint8_t* __restrict__ qctx, int64_t q,
                             uint8_t* __restrict__ found,
                             int64_t* __restrict__ cov,
                             int64_t* __restrict__ right,
                             int64_t* __restrict__ left) {
  int64_t i = (int64_t)blockIdx.x * SELECT_THREADS + threadIdx.x;
  if (i >= q) return;
  int64_t key = qkeys[i];
  int ctx = qctx[i];
  int64_t row = bucket_find(tkeys, starts, nb, shift, key);
  int64_t c = 0, r = 0, l = 0;
  if (row >= 0) {
    int sel_r = ctx & 15, sel_l = ctx >> 4;
    c = __ldcs(tcov + row);
    r = sel_r ? selected(tfw, tbw, row, sel_r) : 0;
    l = sel_l ? selected(tfw, tbw, row, sel_l) : 0;
  }
  found[i] = row >= 0;
  cov[i] = c;
  right[i] = r;
  left[i] = l;
}

}  // namespace
}  // namespace kq

// Table: tkeys [t] sorted unique, 16-byte aligned (a SENTINEL tail is
// allowed), tcov [t], tfw [t, 4], tbw [t, 4]; its bucket directory
// (ops/index.py): starts [nb + 1] and shift.  Queries: qkeys [q], qctx
// [q].  Outputs [q] each, overwritten: found (0/1 bytes), cov, right,
// left.
extern "C" int kq_probe_select(const int64_t* tkeys, const int64_t* tcov,
                               const int64_t* tfw, const int64_t* tbw,
                               const int64_t* starts, int64_t nb,
                               int64_t shift, const int64_t* qkeys,
                               const uint8_t* qctx, int64_t q,
                               uint8_t* found, int64_t* cov, int64_t* right,
                               int64_t* left, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t nblocks = ceil_div(q, SELECT_THREADS);
  if (nblocks > 0)
    probe_select<<<(unsigned)nblocks, SELECT_THREADS, 0, s>>>(
        tkeys, tcov, tfw, tbw, starts, nb, (int)shift, qkeys, qctx, q,
        found, cov, right, left);
  return (int)cudaGetLastError();
}

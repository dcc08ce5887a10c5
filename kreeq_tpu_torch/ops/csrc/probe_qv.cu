// probe_qv: table lookup plus QV classification of assembly k-mer
// positions, reduced to (#missing, #edge-missing).
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_probe_kernel_ind`
// (launched by `_probe_run_ind_x32`; `_probe_prep_sel` sorts the queries
// before it and `_post_qv` classifies and sums after it), wrapped by
// kreeq_tpu/ops/validate.py `validate_qv_sums_pallas`.
//
// Per position lead <= i < hi: found = the key is among the table's
// keys (a SENTINEL query, i.e. an invalid window, is never found);
// ok = found and cov >= covmin, where covmin = max(cutoff, 1); a
// position that is not ok is missing.  An ok position is edge-missing
// when, on each side whose ctx selector is non-zero, the selected
// counter (1-4 = fw0-3, 5-8 = bw0-3) is zero; a selector of 0 means no
// neighbour base, and that side does not count against it.
//
// Bound on the H100: latency of dependent loads.  Each position walks a
// binary search of log2(t) steps (25 at 27M rows) through a table far
// larger than L2; the top levels of the search stay in L2, the last ones
// go to device memory.  Design: no query sort (the TPU kernel needed one
// to stream table tiles): one thread per position searches the table
// directly, and enough threads are in flight (4M per window) to hide the
// latency.  Counts reduce per warp with shuffles, then per block in
// shared memory, then one atomicAdd per counter per block.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int PROBE_THREADS = 256;

__global__ void probe_qv(const int64_t* __restrict__ tkeys,
                         const int64_t* __restrict__ tcov,
                         const int64_t* __restrict__ tfw,
                         const int64_t* __restrict__ tbw, int64_t t,
                         const int64_t* __restrict__ qkeys,
                         const uint8_t* __restrict__ qctx, int64_t lead,
                         int64_t count, int64_t covmin,
                         unsigned long long* __restrict__ out) {
  __shared__ unsigned long long sums[2][PROBE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t i = (int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x;
  unsigned miss = 0, edge = 0;
  if (i < count) {
    int64_t pos = lead + i;
    int64_t key = qkeys[pos];
    int64_t row = key == SENT ? t : lower_bound(tkeys, t, key);
    bool ok = row < t && tkeys[row] == key && tcov[row] >= covmin;
    if (!ok) {
      miss = 1;
    } else {
      int ctx = qctx[pos];
      int sel_r = ctx & 15, sel_l = ctx >> 4;
      bool no_right = sel_r != 0 && selected(tfw, tbw, row, sel_r) == 0;
      bool no_left = sel_l != 0 && selected(tfw, tbw, row, sel_l) == 0;
      edge = no_right && no_left;
    }
  }
  miss = __reduce_add_sync(0xffffffffu, miss);
  edge = __reduce_add_sync(0xffffffffu, edge);
  if (lane == 0) {
    sums[0][warp] = miss;
    sums[1][warp] = edge;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long m = 0, e = 0;
    for (int w = 0; w < PROBE_THREADS / 32; ++w) {
      m += sums[0][w];
      e += sums[1][w];
    }
    if (m) atomicAdd(out, m);
    if (e) atomicAdd(out + 1, e);
  }
}

}  // namespace
}  // namespace kq

// Table: tkeys [t] sorted unique (a SENTINEL tail is allowed), tcov [t],
// tfw/tbw [t, 4].  Queries: qkeys [q], qctx [q]; positions
// [lead, lead + count) are classified.  out: int64[2], overwritten.
extern "C" int kq_probe_qv(const int64_t* tkeys, const int64_t* tcov,
                           const int64_t* tfw, const int64_t* tbw, int64_t t,
                           const int64_t* qkeys, const uint8_t* qctx,
                           int64_t lead, int64_t count, int64_t covmin,
                           int64_t* out, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(int64_t), s);
  if (err != cudaSuccess) return (int)err;
  int64_t nblocks = ceil_div(count, PROBE_THREADS);
  if (nblocks > 0)
    probe_qv<<<(unsigned)nblocks, PROBE_THREADS, 0, s>>>(
        tkeys, tcov, tfw, tbw, t, qkeys, qctx, lead, count, covmin,
        reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

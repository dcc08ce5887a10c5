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
// Bound on the H100: random 32-byte sectors of a table far larger than
// L2, in 3 dependent round trips a position: the bucket directory's two
// entries (L2), the bucket's keys, then the row's cov and right counter
// (the left one only where the right one is zero).  The time follows
// the random places a position reads, more than its bytes.  Design: one
// thread per position, no query sort (the TPU kernel needed one to
// stream table tiles), and the table's bucket directory (ops/index.py,
// built once per table, 32 MB at 2^22 buckets): it confines the search
// to about 6 rows, read by runs.cuh::bucket_find in independent 16-byte
// loads, instead of a global binary search of 25 dependent loads.  cov
// and the right counter are loaded together, as streaming loads, so
// that they do not evict the directory from L2.  Counts reduce per warp
// with shuffles, then per block in shared memory, then one atomicAdd per
// counter per block.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int PROBE_THREADS = 256;

__global__ void probe_qv(const int64_t* __restrict__ tkeys,
                         const int64_t* __restrict__ tcov,
                         const int64_t* __restrict__ tfw,
                         const int64_t* __restrict__ tbw,
                         const int64_t* __restrict__ starts, int64_t nb,
                         int shift, const int64_t* __restrict__ qkeys,
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
    int ctx = qctx[pos];
    int64_t row = bucket_find(tkeys, starts, nb, shift, key);
    if (row < 0) {
      miss = 1;
    } else {
      int sel_r = ctx & 15, sel_l = ctx >> 4;
      int64_t c = __ldcs(tcov + row);
      int64_t r = sel_r ? selected(tfw, tbw, row, sel_r) : 1;
      if (c < covmin)
        miss = 1;
      else if (sel_r != 0 && r == 0 && sel_l != 0)
        edge = selected(tfw, tbw, row, sel_l) == 0;
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

// Table: tkeys [t] sorted unique, 16-byte aligned (a SENTINEL tail is
// allowed), tcov [t], tfw [t, 4], tbw [t, 4]; its bucket directory
// (ops/index.py): starts [nb + 1] and shift.  Queries: qkeys [q], qctx
// [q]; positions [lead, lead + count) are classified.  out: int64[2],
// overwritten.
extern "C" int kq_probe_qv(const int64_t* tkeys, const int64_t* tcov,
                           const int64_t* tfw, const int64_t* tbw,
                           const int64_t* starts, int64_t nb, int64_t shift,
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
        tkeys, tcov, tfw, tbw, starts, nb, (int)shift, qkeys, qctx, lead,
        count, covmin, reinterpret_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}

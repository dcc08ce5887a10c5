// merge_sorted: union of two sorted unique k-mer tables with saturating
// adds.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_merge_kernel2` (launched
// by `_merge_run2_x32`, wrapped by `merge_sorted_pallas`), the contract
// of kreeq_tpu/ops/kmers.py `merge_sorted`: an output of na + nb rows,
// the merged unique keys first, equal keys summed with saturation at
// 0xFFFFFFFF, then SENTINEL rows with zero counters; plus n.  Either
// input may carry a SENTINEL tail; SENTINEL rows never yield a row.
//
// Bound on the H100: memory traffic, about 250 B per row (read both
// inputs, write and re-read the merged buffer, write the output).  The
// binary searches add log2(n) dependent loads per row, most of them hits
// in L2 for the upper levels of the search.  Design: each input is
// sorted and unique, so a key occurs at most twice and every row's place
// in the merged order is known from one search: row i of A goes to
// i + lower_bound(B, a_i), row j of B to j + upper_bound(A, b_j).  That
// fills the merged buffer with no collisions and no atomics.  The run
// head scan of runs.cuh then gives each head its output slot; a head
// whose successor holds the same key adds it in with saturation.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int NV = 9;  // cov, fw0-3, bw0-3

__global__ void merge_scatter(const int64_t* __restrict__ ka,
                              const int64_t* __restrict__ cova,
                              const int64_t* __restrict__ fwa,
                              const int64_t* __restrict__ bwa, int64_t na,
                              const int64_t* __restrict__ kb,
                              const int64_t* __restrict__ covb,
                              const int64_t* __restrict__ fwb,
                              const int64_t* __restrict__ bwb, int64_t nb,
                              int64_t* __restrict__ mkeys,
                              int64_t* __restrict__ mvals) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= na + nb) return;
  const int64_t *cov, *fw, *bw;
  int64_t i, pos, key;
  if (r < na) {
    i = r;
    key = ka[i];
    pos = i + lower_bound(kb, nb, key);
    cov = cova; fw = fwa; bw = bwa;
  } else {
    i = r - na;
    key = kb[i];
    pos = i + upper_bound(ka, na, key);
    cov = covb; fw = fwb; bw = bwb;
  }
  mkeys[pos] = key;
  int64_t* v = mvals + NV * pos;
  v[0] = cov[i];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    v[1 + w] = fw[4 * i + w];
    v[5 + w] = bw[4 * i + w];
  }
}

__global__ void merge_compact(const int64_t* __restrict__ mkeys,
                              const int64_t* __restrict__ mvals, int64_t m,
                              const int64_t* __restrict__ block_offsets,
                              int64_t* __restrict__ okeys,
                              int64_t* __restrict__ ocov,
                              int64_t* __restrict__ ofw,
                              int64_t* __restrict__ obw) {
  int64_t i = (int64_t)blockIdx.x * TILE + threadIdx.x;
  bool head = i < m && is_head(mkeys, i);
  int64_t slot = heads_before(head, block_offsets[blockIdx.x]);
  if (!head) return;
  int64_t key = mkeys[i];
  const int64_t* v = mvals + NV * i;
  int64_t out[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) out[c] = v[c];
  if (i + 1 < m && mkeys[i + 1] == key) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      int64_t sum = out[c] + v[NV + c];
      out[c] = sum < LARGEST ? sum : LARGEST;
    }
  }
  okeys[slot] = key;
  ocov[slot] = out[0];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    ofw[4 * slot + w] = out[1 + w];
    obw[4 * slot + w] = out[5 + w];
  }
}

}  // namespace
}  // namespace kq

// A: ka [na], cova [na], fwa/bwa [na, 4]; B likewise.  mkeys [na + nb]
// and mvals [na + nb, 9]: the merged buffer; block_scratch:
// ceil((na + nb) / kq_tile()) int64; okeys [na + nb], ocov, ofw, obw:
// outputs; n_out: one int64.
extern "C" int kq_merge_sorted(const int64_t* ka, const int64_t* cova,
                               const int64_t* fwa, const int64_t* bwa,
                               int64_t na, const int64_t* kb,
                               const int64_t* covb, const int64_t* fwb,
                               const int64_t* bwb, int64_t nb, int64_t* mkeys,
                               int64_t* mvals, int64_t* block_scratch,
                               int64_t* okeys, int64_t* ocov, int64_t* ofw,
                               int64_t* obw, int64_t* n_out, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t m = na + nb;
  int64_t nblocks = ceil_div(m, TILE);
  if (nblocks > 0)
    merge_scatter<<<(unsigned)nblocks, TILE, 0, s>>>(
        ka, cova, fwa, bwa, na, kb, covb, fwb, bwb, nb, mkeys, mvals);
  launch_head_scan(mkeys, m, block_scratch, n_out, s);
  if (nblocks > 0)
    merge_compact<<<(unsigned)nblocks, TILE, 0, s>>>(
        mkeys, mvals, m, block_scratch, okeys, ocov, ofw, obw);
  launch_fill(okeys, ocov, ofw, obw, m, n_out, s);
  return (int)cudaGetLastError();
}

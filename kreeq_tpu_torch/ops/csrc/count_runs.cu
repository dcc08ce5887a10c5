// count_runs: run-aggregation of key-sorted k-mer records into a sorted
// unique table.
//
// Replaces: kreeq_tpu/ops/pallas_kernels.py `_kernel` (launched by
// `_run_pallas_x32`, wrapped by `count_sorted_pallas`), the contract of
// kreeq_tpu/ops/kmers.py `count_sorted` after its sort.  The sort stays
// outside the kernel (torch.sort plus a gather of the edge bytes).
//
// Input: P sorted int64 keys (SENTINEL rows last) and P uint8 edge bytes.
// Output: for each distinct key, compacted to the front: the key,
// cov = run length, fw[w] = records with edge bit w, bw[w] = records
// with edge bit 4+w; SENTINEL rows with zero counters after them; and n.
//
// Bound on the H100: memory traffic.  The kernel reads 9 B per record
// (17 B with the neighbour key), writes all P output rows of 80 B once
// to clear them and the real ones again through atomics: about 1.2 GB
// for an 8.4M-record chunk, some 0.4 ms at 3.35 TB/s; there is no
// arithmetic to speak of.
//
// Design: one record per thread and three passes over the keys (head
// counts per block, one scan of the block counts, then the scatter), so
// every block works on its own and none waits on another.  Runs may
// span any number of blocks (a poly-A pile gives one key millions of
// records): each warp sums its part of a run with a segmented shuffle
// scan of the nine counts packed 6 bits apiece in one 64-bit word (a
// warp adds at most 32 per field), and the last lane of each segment
// adds the sums into the run's slot with one atomicAdd per non-zero
// field.  Counts are exact int64; there is no 2^24 cap.

#include "runs.cuh"

namespace kq {
namespace {

__global__ void count_scatter(const int64_t* __restrict__ skeys,
                              const uint8_t* __restrict__ sedges, int64_t p,
                              const int64_t* __restrict__ block_offsets,
                              int64_t* __restrict__ okeys,
                              int64_t* __restrict__ ocov,
                              int64_t* __restrict__ ofw,
                              int64_t* __restrict__ obw) {
  const int lane = threadIdx.x & 31;
  int64_t i = (int64_t)blockIdx.x * TILE + threadIdx.x;
  bool in = i < p;
  int64_t key = in ? skeys[i] : SENT;
  bool head = in && is_head(skeys, i);
  // slot of the run this record belongs to = run heads up to and
  // including it, less one (a run continued from an earlier block gets
  // the last slot opened before this block)
  int64_t slot = heads_before(head, block_offsets[blockIdx.x]) + head - 1;
  if (head) okeys[slot] = key;

  uint64_t packed = 0;
  if (key != SENT) {
    uint32_t e = sedges[i];
    packed = 1;  // field 0: cov
#pragma unroll
    for (int b = 0; b < 8; ++b)
      packed |= (uint64_t)((e >> b) & 1u) << (6 * (b + 1));
  }
  // segmented inclusive scan over lanes holding the same key (keys are
  // sorted, so equal keys are contiguous)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    uint64_t y = __shfl_up_sync(0xffffffffu, packed, off);
    int64_t ky = __shfl_up_sync(0xffffffffu, key, off);
    if (lane >= off && ky == key) packed += y;
  }
  int64_t knext = __shfl_down_sync(0xffffffffu, key, 1);
  bool last = lane == 31 || knext != key;
  if (!last || key == SENT) return;
  using u64 = unsigned long long;
  atomicAdd(reinterpret_cast<u64*>(ocov + slot), (u64)(packed & 63u));
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    u64 v = (packed >> (6 * (1 + w))) & 63u;
    if (v) atomicAdd(reinterpret_cast<u64*>(ofw + 4 * slot + w), v);
    v = (packed >> (6 * (5 + w))) & 63u;
    if (v) atomicAdd(reinterpret_cast<u64*>(obw + 4 * slot + w), v);
  }
}

}  // namespace
}  // namespace kq

// skeys/sedges: P sorted records.  okeys [P], ocov [P], ofw/obw [P, 4]:
// outputs; n_out: one int64; block_scratch: ceil(P / kq_tile()) int64.
extern "C" int kq_count_runs(const int64_t* skeys, const uint8_t* sedges,
                             int64_t p, int64_t* okeys, int64_t* ocov,
                             int64_t* ofw, int64_t* obw, int64_t* n_out,
                             int64_t* block_scratch, void* stream) {
  using namespace kq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_fill(okeys, ocov, ofw, obw, p, nullptr, s);
  launch_head_scan(skeys, p, block_scratch, n_out, s);
  int64_t nblocks = ceil_div(p, TILE);
  if (nblocks > 0)
    count_scatter<<<(unsigned)nblocks, TILE, 0, s>>>(
        skeys, sedges, p, block_scratch, okeys, ocov, ofw, obw);
  return (int)cudaGetLastError();
}

extern "C" int kq_tile() { return kq::TILE; }

extern "C" const char* kq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

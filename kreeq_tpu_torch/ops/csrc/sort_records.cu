// sort_records: stable LSD radix sort of a chunk's (key, edge byte)
// records, the sort of the count step.
//
// Replaces: `jax.lax.sort` in kreeq_tpu/ops/kmers.py `_sort_keys_edges`
// (:158, called from `count_sorted` :198), an XLA sort, not a
// `pl.pallas_call`.  As there, the edge byte rides with its key through
// the sort: no index and no gather.  Its plain PyTorch version is
// ops/kmers.sort_keys_edges (a stable torch.sort, then the gather).
//
// Input: P biased int64 keys (kreeq_tpu_torch/constants.py), each a
// canonical k-mer key (u64 below 4^k) or SENTINEL, and P uint8 edge
// bytes; 1 <= k <= 32.  Output: the keys in ascending order, each edge
// byte beside its key, equal keys in input order (stable), so the
// output is unique.
//
// Which bits: a canonical key is below 4^k, so only the low 2k bits of
// its unbiased u64 vary; SENTINEL unbiased is all ones, which no
// canonical key is in its low 2k bits (the all-T window's reverse
// complement is 0).  So a stable sort of the unbiased u64 on its low
// ceil(2k / 8) bytes puts every key in order and every SENTINEL last,
// the order torch.sort gives, k = 32 (the bias on the top bit)
// included.  Digits are 8 bits: 6 passes at k = 21, 8 at k = 31.
//
// Bound on the H100: memory traffic.  The histogram reads every key
// once (8 B a record); each pass reads and writes a record (9 + 9 B):
// at k = 31 and P = 8,388,578, 152 B a record, 1.28 GB or 0.381 ms at
// 3.35 TB/s (k = 21: 116 B, 0.291 ms).
//
// Design, onesweep style (one read and one write of the records a
// pass):
//  - sort_histogram: one read of the keys builds every pass's 256-bin
//    digit histogram (shared-memory counts a block, then global atomics).
//  - sort_pass, one launch a pass, STILE records a tile.  A block takes
//    the next tile number from an atomic counter (so every tile before
//    it is resident or done) and loads the tile into registers (a warp
//    32 neighbouring records a round, SI rounds).  It counts the tile's
//    digits at once (shared atomics) and publishes the counts, then
//    every warp ranks its records: per round, eight ballots give the
//    lanes that share a lane's digit, the lanes below it give its rank,
//    and the lowest of them bumps the warp's count for the digit.  Warp
//    order, round order and lane order are input order, so the ranks
//    are stable.  Then the block splits: the first RADIX threads, a
//    thread a digit, look back over the tiles before it (decoupled
//    look-back: a tile's status holds its own count, then the
//    inclusive sum of the tiles up to it; LOOKBACK statuses are read at
//    once) and publish the inclusive sums, while the other RADIX
//    threads scan the tile's counts and the histogram (named barrier 1)
//    and stage their records in shared memory in digit order.  The
//    look-back waits mostly on the tiles just before, which started
//    with this one; placing the tile meanwhile takes that wait off the
//    critical path.  The records leave in staged order: neighbouring
//    threads write neighbouring addresses within each digit's run, at
//    the digit's start from the histogram plus the tiles before.
// The status words carry the pass number, so one memset a sort clears
// them for every pass.  On the H100 a pass takes about two and a half
// times its bytes' time (PERF.md): a tile's phases (load, count,
// look-back, rank, stage, write) run one after another, and two blocks
// a SM overlap too few of them.  Register pressure decides much: 512
// threads of at most 64 registers hold eight records a thread; a
// look-back that reads more than a few statuses at once spills, and so
// do three blocks a SM.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int ST = 512;         // threads of a sort tile
constexpr int SI = 8;           // records a thread
constexpr int STILE = ST * SI;  // records a tile
constexpr int SWARPS = ST / 32;
constexpr int RADIX = 256;      // 8-bit digits
constexpr int MAX_PASSES = 8;
constexpr int LOOKBACK = 4;     // statuses read at once in the look-back
constexpr int HT = 256;         // threads of a histogram block
// the first RADIX threads own a digit each, and so do the rest
static_assert(ST == 2 * RADIX, "a sort tile is two threads a digit");

using u64 = unsigned long long;

// A status word: the pass + 1 in bits 59-63 (0: nothing published for
// this pass yet), bit 58 set once the value is inclusive of every tile
// before, the value in bits 0-57.
constexpr u64 INCLUSIVE = 1ull << 58;
constexpr u64 VALUE = INCLUSIVE - 1;
constexpr int TAG_SHIFT = 59;

// A status word is read and written whole, relaxed at device scope: the
// loads of a look-back spin must not be cached or hoisted.
__device__ __forceinline__ u64 load_status(const u64* at) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* at, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(at), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 unbias(int64_t key) {
  return static_cast<u64>(key) ^ (1ull << 63);
}

__device__ __forceinline__ unsigned digit(int64_t key, int shift) {
  return (unsigned)(unbias(key) >> shift) & (RADIX - 1);
}

// hist [passes][RADIX], zeroed: the count of each digit value of each
// pass over all P keys.
__global__ void __launch_bounds__(HT)
    sort_histogram(const int64_t* __restrict__ keys, int64_t p, int passes,
                   u64* __restrict__ hist) {
  __shared__ unsigned h[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < MAX_PASSES * RADIX; i += HT) h[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * HT;
  for (int64_t i = (int64_t)blockIdx.x * HT + threadIdx.x; i < p;
       i += stride) {
    const u64 u = unbias(__ldg(keys + i));
#pragma unroll
    for (int d = 0; d < MAX_PASSES; ++d)
      if (d < passes) atomicAdd(&h[d * RADIX + ((u >> (8 * d)) & 255)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += HT)
    if (h[i]) atomicAdd(hist + i, (u64)h[i]);
}

// The records of digit t in the tiles before `tile` of this pass: the
// statuses of LOOKBACK tiles are read together, then summed back to the
// first inclusive one; a status not yet published stops the sum, and
// the next batch starts at it.
__device__ __forceinline__ u64 look_back(const u64* status, int tile, int t,
                                         int pass) {
  const u64 tag = (u64)(pass + 1);
  u64 before = 0;
  for (int64_t j = tile - 1;;) {
    u64 v[LOOKBACK];
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q)
      v[q] = j - q >= 0 ? load_status(status + (j - q) * RADIX + t)
                        : tag << TAG_SHIFT | INCLUSIVE;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q) {
      if (!done && used == q && (v[q] >> TAG_SHIFT) == tag) {
        before += v[q] & VALUE;
        done = (v[q] & INCLUSIVE) != 0;
        used = q + 1;
      }
    }
    if (done) return before;
    j -= used;
  }
}

struct PassSmem {
  int64_t keys[STILE];  // the tile in digit order
  uint8_t edges[STILE];
  // a warp's records of a digit, then the staged position of the
  // warp's first record of the digit
  uint16_t warp_at[SWARPS][RADIX];
  unsigned count[RADIX];       // the tile's records of a digit
  int64_t to_global[RADIX];    // a staged position's output offset
  u64 scan[SWARPS];
  int tile;
};

// The threads from RADIX on (ST - RADIX of them) meet at named barrier
// 1, while the first RADIX threads go their own way.
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(ST - RADIX) : "memory");
}

// Exclusive scan of one value a thread over the threads from RADIX on;
// `tmp` holds a value a warp of them.  All of them must call it.
__device__ __forceinline__ u64 group_exclusive_scan(u64 v, u64* tmp) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x - RADIX) >> 5;
  u64 x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) tmp[w] = x;
  group_sync();
  u64 before = 0;
  for (int i = 0; i < w; ++i) before += tmp[i];
  group_sync();  // tmp may be reused
  return before + x - v;
}

// A warp's records into the tile's staging arrays, each at its digit's
// staged position for the warp plus its rank.
__device__ __forceinline__ void stage(PassSmem& sm, const int64_t* key,
                                      const unsigned* edge,
                                      const unsigned* rank, int64_t first,
                                      int64_t p, int warp, int shift) {
#pragma unroll
  for (int r = 0; r < SI; ++r) {
    if (first + 32 * r < p) {
      const unsigned at = sm.warp_at[warp][digit(key[r], shift)] + rank[r];
      sm.keys[at] = key[r];
      sm.edges[at] = (uint8_t)edge[r];
    }
  }
}

// One pass over the digit at bit `shift`: records in (kin, ein) to
// (kout, eout).  hist: this pass's [RADIX] counts; status [tiles][RADIX]
// and *counter: zeroed before the sort's first pass.
__global__ void __launch_bounds__(ST, 2)
    sort_pass(const int64_t* __restrict__ kin, const uint8_t* __restrict__ ein,
              int64_t* __restrict__ kout, uint8_t* __restrict__ eout,
              int64_t p, int shift, int pass, const u64* __restrict__ hist,
              u64* status, unsigned* counter) {
  __shared__ PassSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x;  // threads below RADIX own digit t
  if (t == 0) sm.tile = (int)atomicAdd(counter, 1u);
  for (int i = t; i < SWARPS * RADIX; i += ST) (&sm.warp_at[0][0])[i] = 0;
  if (t < RADIX) sm.count[t] = 0;
  __syncthreads();
  const int tile = sm.tile;
  const int64_t first = (int64_t)tile * STILE + warp * (32 * SI) + lane;

  int64_t key[SI];
  unsigned edge[SI], rank[SI];
#pragma unroll
  for (int r = 0; r < SI; ++r) {
    const int64_t i = first + 32 * r;
    key[r] = i < p ? __ldg(kin + i) : 0;
    edge[r] = i < p ? __ldg(ein + i) : 0;
  }
  // the tile's counts first, so that they are published before the
  // ranking and the tiles after this one find them when they look back
#pragma unroll
  for (int r = 0; r < SI; ++r)
    if (first + 32 * r < p) atomicAdd(&sm.count[digit(key[r], shift)], 1u);
  __syncthreads();
  const u64 tag = (u64)(pass + 1) << TAG_SHIFT;
  u64* mine = status + (int64_t)tile * RADIX + t;
  const unsigned count = t < RADIX ? sm.count[t] : 0;
  if (t < RADIX)
    store_status(mine, tag | (tile == 0 ? INCLUSIVE : 0) | count);

  // every warp ranks its records
  const unsigned below = (1u << lane) - 1;
  uint16_t* wc = sm.warp_at[warp];
#pragma unroll
  for (int r = 0; r < SI; ++r) {
    const unsigned d = digit(key[r], shift);
    unsigned peers = __ballot_sync(FULL, first + 32 * r < p);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const unsigned m = __ballot_sync(FULL, (d >> b) & 1);
      peers &= (d >> b) & 1 ? m : ~m;
    }
    const unsigned at = wc[d];
    __syncwarp();
    if (first + 32 * r < p && (peers & below) == 0)
      wc[d] = (uint16_t)(at + __popc(peers));
    __syncwarp();
    rank[r] = at + __popc(peers & below);
  }
  __syncthreads();

  // The first RADIX threads look back, a thread a digit, while the
  // others (digit t - RADIX) place the tile: each digit's first staged
  // position (the counts scanned), each warp's (the warps before it
  // added), the digit's start in the output (the histogram scanned);
  // they then stage their own records.  Only the output offsets wait
  // for the look-back.
  u64 before = 0;  // this digit's records in the tiles before
  if (t >= RADIX) {
    const int d = t - RADIX;
    const unsigned start =
        (unsigned)group_exclusive_scan((u64)sm.count[d], sm.scan);
    unsigned at = start;
#pragma unroll
    for (int w = 0; w < SWARPS; ++w) {
      const unsigned v = sm.warp_at[w][d];
      sm.warp_at[w][d] = (uint16_t)at;
      at += v;
    }
    const u64 base = group_exclusive_scan(__ldg(hist + d), sm.scan);
    sm.to_global[d] = (int64_t)base - (int64_t)start;
    group_sync();  // every warp's staged positions are in place
    stage(sm, key, edge, rank, first, p, warp, shift);
  } else if (tile > 0) {
    before = look_back(status, tile, t, pass);
    store_status(mine, tag | INCLUSIVE | (before + count));
  }
  __syncthreads();
  if (t < RADIX) {
    sm.to_global[t] += (int64_t)before;
    stage(sm, key, edge, rank, first, p, warp, shift);
  }
  __syncthreads();
  const int64_t m64 = p - (int64_t)tile * STILE;
  const int m = m64 < STILE ? (int)m64 : STILE;
  for (int i = t; i < m; i += ST) {
    const int64_t k = sm.keys[i];
    const int64_t at = sm.to_global[digit(k, shift)] + i;
    kout[at] = k;
    eout[at] = sm.edges[i];
  }
}

inline int passes_for(int64_t k) { return (int)((2 * k + 7) / 8); }

}  // namespace
}  // namespace kq

// Records of a sort tile; the wrapper sizes the scratch from it.
extern "C" int kq_sort_tile() { return kq::STILE; }

// keys/edges: P records (not modified); 1 <= k <= 32.  keys_out /
// edges_out [P]: the sorted records; keys_tmp / edges_tmp [P]: the
// other side of the ping-pong (unused when one pass does); scratch:
// ceil(P / kq_sort_tile()) * 256 + 8 * 256 + 8 int64 (the look-back
// status, the histograms, the tile counters), cleared here.  No launch
// when P == 0.
extern "C" int kq_sort_records(const int64_t* keys, const uint8_t* edges,
                               int64_t p, int64_t k, int64_t* keys_out,
                               uint8_t* edges_out, int64_t* keys_tmp,
                               uint8_t* edges_tmp, int64_t* scratch,
                               void* stream) {
  using namespace kq;
  if (k < 1 || k > 32 || p < 0) return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes = passes_for(k);
  const int64_t tiles = ceil_div(p, STILE);
  u64* status = reinterpret_cast<u64*>(scratch);
  u64* hist = status + tiles * RADIX;
  unsigned* counters = reinterpret_cast<unsigned*>(hist + MAX_PASSES * RADIX);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (tiles * RADIX + MAX_PASSES * RADIX + MAX_PASSES) * 8, s);
  if (err != cudaSuccess) return (int)err;
  int64_t hblocks = ceil_div(p, HT);
  if (hblocks > 4 * (int64_t)sm_count()) hblocks = 4 * sm_count();
  sort_histogram<<<(unsigned)hblocks, HT, 0, s>>>(keys, p, passes, hist);
  // the last pass writes the output: an even count starts in tmp
  const int64_t* kin = keys;
  const uint8_t* ein = edges;
  for (int d = 0; d < passes; ++d) {
    const bool to_out = (passes - d) % 2 == 1;
    int64_t* ko = to_out ? keys_out : keys_tmp;
    uint8_t* eo = to_out ? edges_out : edges_tmp;
    sort_pass<<<(unsigned)tiles, ST, 0, s>>>(kin, ein, ko, eo, p, 8 * d, d,
                                             hist + d * RADIX, status,
                                             counters + d);
    kin = ko;
    ein = eo;
  }
  return (int)cudaGetLastError();
}

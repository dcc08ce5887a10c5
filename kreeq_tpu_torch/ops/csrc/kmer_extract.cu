// kmer_extract: canonical k-mer extraction of one chunk of base codes in
// one pass: every window's key and orientation, its validity, and the
// bases before and after it as edge bits or as probe selectors.
//
// Replaces: the jitted kreeq_tpu/ops/kmers.py `kmer_positions` (:40) and
// the two contexts built on it, kreeq_tpu/ops/validate.py `_extract_ctx`
// (:131, the track probe's) and `_extract_ctx_qv` (:214, the QV probe's).
// These are XLA fusions, not a `pl.pallas_call`.  Their plain PyTorch
// versions stay in ops/kmers.py and ops/validate.py.
//
// Input: codes uint8 [N], 0-3 bases, anything above 3 BAD; 1 <= k <= 32;
// P = N - k + 1 >= 1 windows.  A BAD code inside a window is read as
// `code & 3` and flags the window invalid; the bases before position 0
// and after the last window are BAD.  Keys are int64 holding u64 ^ 2^63
// (kreeq_tpu_torch/constants.py); the u64 work happens in registers and
// the bias only at the store.  Four forms (`form`):
//   0 records: keys (an invalid window keeps the key its codes & 3
//     give), isfw, edges (bit w = fw edge to base w, bit 4+w = bw edge
//     to base w), valid;
//   1 qv: keys (SENTINEL where invalid), ctx (bits 0-3 the right
//     selector, 4-7 the left: 1-4 = fw0-3, 5-8 = bw0-3, 0 = no
//     neighbour base on that side);
//   2 track: keys (SENTINEL where invalid), isfw, valid, ctx (as qv, but
//     a side without a neighbour keeps its selector);
//   3 count: the records the count step sorts, keys (SENTINEL where
//     invalid) and edges (0 where invalid): what ops/kmers.count_records
//     makes of the records form.
// The selectors are the JAX `_classify`'s choice: right = isfw ? fw[nc]
// : bw[3 - nc], left = isfw ? bw[pc] : fw[3 - pc].
//
// Bound on the H100: memory traffic.  N code bytes read, and per window
// 11 B written (records, track) or 9 B (qv, count): for an
// 8,388,608-base chunk at k = 31 about 101 MB (records) or 84 MB
// (count), 0.030 or 0.025 ms at 3.35 TB/s.  The per-window arithmetic
// (a funnel shift, a bit reversal, a mask test) is far below the rate
// that would bound it.
//
// Design: one block a tile of XTILE windows, O(1) work a window.
//  - Staging: the tile's codes with a halo, from 16-31 bytes before the
//    tile (the base before its first window, and the alignment) to 32
//    past its end, in 16-byte loads (bytes outside [0, N) read as BAD).
//    A thread packs each 16 codes into one word of 2-bit bases and one
//    16-bit mask of BAD codes in shared memory (1/4 and 1/8 of a byte a
//    base), as the JAX version packs 16 bases a word once.
//  - Per window: fw is a 64-bit funnel shift of two packed words plus
//    the low bits of a third; rc complements fw and reverses its bit
//    pairs (__brevll, then a swap of the two bits of each pair), as the
//    JAX version does with its log-step reversal; valid is the window's
//    k bits of the BAD masks (three 16-bit masks, one shift); the bases
//    before and after come from the same words.
//  - Stores: thread t takes windows base + t + j * XT, so each warp
//    store is 256 contiguous bytes of keys and 32 of each byte output:
//    whole sectors.
// A persistent design (a few blocks a SM walking tiles, the next tiles'
// codes in flight through a 3-stage cp.async ring) measured no faster on
// the H100, within 3% either way in every form (tools/ab_count.py
// device times), so the simpler one stays.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int XT = 256;          // threads of an extraction tile
constexpr int XI = 8;            // windows per thread
constexpr int XTILE = XT * XI;   // windows per tile
// staged codes a tile, from 16-31 before it to at least 32 past it
constexpr int XREGION = XTILE + 64;
constexpr int XWORDS = XREGION / 16;

constexpr int RECORDS = 0, QV = 1, TRACK = 2, COUNT = 3;

using u64 = unsigned long long;

// x with the order of its 32 two-bit fields reversed.
__device__ __forceinline__ u64 reverse_pairs(u64 x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) |
         ((x & 0x5555555555555555ull) << 1);
}

// One code's contribution to a word of 16 bases: the base (code & 3) at
// bits 2i of *w, BAD (code > 3) at bit i of *b.
__device__ __forceinline__ void pack_code(unsigned code, int i, uint32_t* w,
                                          uint32_t* b) {
  *w |= (code & 3u) << (2 * i);
  *b |= (uint32_t)(code > 3u) << i;
}

template <int FORM>
__global__ void __launch_bounds__(XT)
    extract(const uint8_t* __restrict__ codes, int64_t n, int k,
            int64_t* __restrict__ keys, uint8_t* __restrict__ isfw_out,
            uint8_t* __restrict__ valid_out, uint8_t* __restrict__ byte_out) {
  __shared__ uint32_t packed[XWORDS];  // base i of the word at bits 2i
  __shared__ uint32_t badm[XWORDS];    // bit i: code i is BAD
  const int64_t p = n - k + 1;
  const int64_t base = (int64_t)blockIdx.x * XTILE;
  // codes + s is 16-byte aligned and s <= base - 16
  const int64_t s =
      base - 16 - (int64_t)(reinterpret_cast<uintptr_t>(codes) & 15);
  for (int c = threadIdx.x; c < XWORDS; c += XT) {
    const int64_t g = s + 16 * c;
    uint32_t w = 0, b = 0;
    if (g >= 0 && g + 16 <= n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + g));
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        pack_code((q[i >> 2] >> (8 * (i & 3))) & 0xffu, i, &w, &b);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        pack_code(g + i >= 0 && g + i < n ? codes[g + i] : 4u, i, &w, &b);
    }
    packed[c] = w;
    badm[c] = b;
  }
  __syncthreads();

  const u64 kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const u64 wmask = (1ull << k) - 1;
#pragma unroll
  for (int j = 0; j < XI; ++j) {
    const int64_t i = base + j * XT + threadIdx.x;
    if (i >= p) break;
    const int l = (int)(i - s);  // the window's first code in the stage
    const int c = l >> 4, r = l & 15;
    const u64 lo = packed[c] | (u64)packed[c + 1] << 32;
    u64 fw = r ? (lo >> (2 * r)) | ((u64)packed[c + 2] << (64 - 2 * r)) : lo;
    fw &= kmask;
    const u64 rc = reverse_pairs(~fw) >> (64 - 2 * k);
    const bool fwd = fw <= rc;
    const u64 bad =
        (badm[c] | (u64)badm[c + 1] << 16 | (u64)badm[c + 2] << 32) >> r;
    const bool ok = (bad & wmask) == 0;
    const int lp = l - 1, ln = l + k;  // the bases before and after
    const int pc = (packed[lp >> 4] >> (2 * (lp & 15))) & 3;
    const int nc = (packed[ln >> 4] >> (2 * (ln & 15))) & 3;
    const bool has_prev = !((badm[lp >> 4] >> (lp & 15)) & 1);
    const bool has_next = !((badm[ln >> 4] >> (ln & 15)) & 1);
    const int64_t key = (int64_t)((fwd ? fw : rc) ^ (1ull << 63));
    if constexpr (FORM == RECORDS || FORM == COUNT) {
      const int e_fw = (has_next ? 1 << nc : 0) | (has_prev ? 16 << pc : 0);
      const int e_rc =
          (has_prev ? 1 << (3 - pc) : 0) | (has_next ? 1 << (7 - nc) : 0);
      const int e = fwd ? e_fw : e_rc;
      if constexpr (FORM == RECORDS) {
        keys[i] = key;
        byte_out[i] = (uint8_t)e;
      } else {
        keys[i] = ok ? key : SENT;
        byte_out[i] = ok ? (uint8_t)e : 0;
      }
    } else {
      int sel_r = fwd ? 1 + nc : 8 - nc;
      int sel_l = fwd ? 5 + pc : 4 - pc;
      if constexpr (FORM == QV) {
        if (!has_next) sel_r = 0;
        if (!has_prev) sel_l = 0;
      }
      keys[i] = ok ? key : SENT;
      byte_out[i] = (uint8_t)(sel_r | sel_l << 4);
    }
    if constexpr (FORM == RECORDS || FORM == TRACK) {
      isfw_out[i] = fwd;
      valid_out[i] = ok;
    }
  }
}

}  // namespace
}  // namespace kq

// Windows of a tile (the card tests put P on and around its seams).
extern "C" int kq_extract_tile() { return kq::XTILE; }

// codes [n]; 1 <= k <= 32; form 0 records, 1 qv, 2 track, 3 count.
// Outputs [P], P = n - k + 1, overwritten: keys; bytes
// (edges for records and count, ctx for qv and track); isfw and valid
// (records and track; null for qv and count).  No launch when P <= 0.
extern "C" int kq_extract(const uint8_t* codes, int64_t n, int64_t k,
                          int64_t form, int64_t* keys, uint8_t* isfw,
                          uint8_t* valid, uint8_t* bytes, void* stream) {
  using namespace kq;
  if (k < 1 || k > 32 || form < RECORDS || form > COUNT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t p = n - k + 1;
  if (p <= 0) return 0;
  const unsigned blocks = (unsigned)ceil_div(p, XTILE);
  const int kk = (int)k;
  if (form == RECORDS)
    extract<RECORDS><<<blocks, XT, 0, s>>>(codes, n, kk, keys, isfw, valid,
                                           bytes);
  else if (form == QV)
    extract<QV><<<blocks, XT, 0, s>>>(codes, n, kk, keys, isfw, valid,
                                      bytes);
  else if (form == TRACK)
    extract<TRACK><<<blocks, XT, 0, s>>>(codes, n, kk, keys, isfw, valid,
                                         bytes);
  else
    extract<COUNT><<<blocks, XT, 0, s>>>(codes, n, kk, keys, isfw, valid,
                                         bytes);
  return (int)cudaGetLastError();
}

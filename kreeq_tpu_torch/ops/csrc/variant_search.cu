// variant_search: kreeq's candidate-error search from every branch point
// of one variants scan window, one thread a branch point, against the
// device-form table.
//
// Replaces: no TPU kernel.  The JAX package, and the port on the CPU or
// against a host-resident table, search on the host, one branch point at
// a time: kreeq_tpu_torch/core/variants.py `_search_from_scan` (the
// targets state) -> `search_variants` over core/fibheap.py's
// `FibonacciHeap`, with `KmerTable.lookup` for each new k-mer.  This
// kernel is that code, step for step, so its records are the host's:
//
//   * targets: the queue is the buffer's keys at positions [c + k + 1,
//     min(c + k + max_span + 1, kcount)); a key is in the map unless it
//     also occurs at a position p <= c + k with p >= max(a - max_span +
//     1, k), a being its last queue position (the host's stateless rule
//     of the reference's pop-erases quirk, read off the window's keys);
//   * the heap: the splice order of fibheap.py's insert, extract_min
//     with consolidate, decrease_key with cut and cascading cut, its
//     refusal to raise a key (queued nodes keep priority 0, so no key is
//     ever lowered and the order is the splice mechanics'), and its
//     eviction at 1,000 queued nodes (the last consolidation-table
//     entry to the top, then extract_min; an evicted node is never
//     touched again);
//   * edges: the bw side tests > cutoff, the fw side > 0; the direction
//     is the source's orientation at depth 0, then the extracted node's
//     prev direction; the candidate equal to the next assembly k-mer is
//     left out; canonical keys compare as u64;
//   * lookups: a k-mer of this search's node set that the table already
//     answered is a cache hit (the host's cache holds exactly those, as
//     it is emptied after each search); any other, the source included,
//     is a lookup; an absent k-mer inserts nothing;
//   * paths: for every destination, in order (the same key may come
//     twice), ref_len from its first queue slot, the backtrack through
//     prev (a key's prev is its node's, else its last destination's,
//     else (0, fw = false), as the host's prev_get), COM/SNV/DEL/INS and
//     the bases, written in the sequence's order.
//
// Bound on the H100: the dependent chain of random reads in each search,
// not bandwidth: a lookup is the bucket directory (L2) then the bucket's
// keys (runs.cuh::bucket_find, as probe_sorted.cu), and an extraction
// reads the node's fw and bw rows; a search of the default depth makes
// up to 22 extractions and 88 lookups.  Design: the searches run side
// by side, 32 a block, each node's fields in [node][lane] columns (a
// warp's accesses to one field fall in distinct banks, or one line),
// sized from the depth at launch: at most 1 + 4 (depth + 1) nodes (the
// source, and four new ones an extraction) and no more than the table
// has rows.  Where that is at most 253 nodes (depth 62), node indices
// are bytes and the state lives in shared memory; deeper, indices are
// u32, the state lives in a global buffer the caller gives, a search
// finds its nodes through a hash of its own (slots stamped with the
// search's number, so no buffer is cleared between searches), and the
// searches run in as many launches as the buffer needs.  The keys of
// the window stay in device memory and are read through L1.  A search
// that finds paths reserves its records and bases in two pools with
// atomics; each record carries its position, so the order of the pool
// does not matter; a pool too small is counted, never overrun, and the
// wrapper launches again with the sizes counted.

#include "runs.cuh"

namespace kq {
namespace {

constexpr int VS_LANES = 32;          // searches a block, at most
constexpr int64_t VS_BYTE_NODES = 253;  // byte node indices; 255 is NIL
constexpr int64_t VS_SHARED = 227 * 1024;  // a block's shared memory
constexpr uint32_t VS_HEAP = 1000;    // fibheap.py's max_nodes
constexpr int VS_DEG = 16;            // consolidation table entries
constexpr uint64_t BIAS = 1ull << 63;

// node flags besides the heap's links
constexpr uint8_t HAS_PREV = 1, PREV_FW = 2, CACHED = 4, MARK = 8,
                  EVICTED = 16;

enum PathType { SNV = 0, INS = 1, DEL = 2, COM = 3 };

struct Args {
  const int64_t* tkeys;
  const int64_t* tfw;
  const int64_t* tbw;
  const int64_t* starts;
  int64_t nb;
  int shift;
  const int64_t* keys;  // the window's buffer, positions [lo, lo + nloc)
  const uint8_t* isfw;
  const int64_t* fws;  // the buffer's probe counters [nloc, 4]
  const int64_t* bws;
  int64_t nloc;
  const int64_t* rows;  // the branch points, buffer-relative
  int64_t nsearch;
  int64_t lo, kcount, max_span, cutoff, depth;
  int k;
  int64_t nmax, maxd, hcap;  // a search's nodes, destinations, hash slots
  int64_t bytes;             // a search's state
  uint8_t* state;            // the global state (null: shared memory)
  int64_t* counts;  // [nsearch, 2]: lookups, cache hits
  int64_t* paths;   // [cap_paths, 5]: pos, type, ref_len, bases, offset
  int64_t cap_paths;
  uint8_t* bases;
  int64_t cap_bases;
  unsigned long long* used;  // paths, bases, faults
};

// The state bytes of one search: per node a key, a row, five links and
// four bytes; per destination a slot, a link and a byte; per hash slot
// a node and a stamp; the consolidation table.  A multiple of 8.
template <typename I>
__host__ __device__ constexpr int64_t search_bytes(int64_t nmax,
                                                   int64_t maxd,
                                                   int64_t hcap) {
  return (8 * nmax + 4 * (nmax + maxd + 2 * hcap) +
          static_cast<int64_t>(sizeof(I)) * (5 * nmax + maxd + VS_DEG) +
          4 * nmax + maxd + 7) / 8 * 8;
}

struct Bounds {
  int64_t nmax, maxd, hcap, bytes;
  bool shared;
};

// A search of `depth` against a table of `rows` rows: every node but
// the source is a distinct table row, as is the source, so a search
// extracts at most min(depth + 1, rows) nodes and holds at most four
// destinations an extraction.
Bounds bounds(int64_t depth, int64_t rows) {
  Bounds b;
  const int64_t ext = depth + 1 < rows ? depth + 1 : rows;
  b.nmax = 1 + 4 * ext < rows + 1 ? 1 + 4 * ext : rows + 1;
  b.maxd = 4 * ext;
  b.shared = b.nmax <= VS_BYTE_NODES &&
             VS_LANES * search_bytes<uint8_t>(b.nmax, b.maxd, 0) <=
                 VS_SHARED;
  b.hcap = b.shared ? 0 : 2 * b.nmax;
  b.bytes = b.shared ? search_bytes<uint8_t>(b.nmax, b.maxd, 0)
                     : search_bytes<uint32_t>(b.nmax, b.maxd, b.hcap);
  return b;
}

// One field of this thread's search: element i at p[i * s], s the
// block's lanes.
template <typename T>
struct Col {
  T* p;
  int s;
  __device__ __forceinline__ T& operator[](int64_t i) const {
    return p[i * s];
  }
};

__device__ __forceinline__ uint64_t key_at(const Args& a, int64_t p) {
  return static_cast<uint64_t>(__ldg(a.keys + (p - a.lo))) ^ BIAS;
}

// One search's state and fibheap.py's heap over node indices I.
template <typename I>
struct Search {
  static constexpr uint32_t NIL = static_cast<I>(-1);
  Col<uint64_t> key;  // u64 canonical k-mer
  Col<uint32_t> row;  // table row (the source's counters are its probe's)
  Col<uint32_t> dslot;  // a destination's first queue slot
  Col<uint32_t> hnode, hstamp;  // the hash (u32 indices only)
  Col<I> prev, left, right, parent, child;
  Col<I> dprev;  // a destination's prev
  Col<I> deg;    // consolidation table
  Col<uint8_t> dist, flag, hkey, degree;
  Col<uint8_t> dfw;  // a destination's prev direction
  uint32_t n, nd, hn, hmin, deglen, stamp;
  uint64_t hcap;
  bool fault;

  __device__ Search(uint8_t* base, int lanes, int t, const Args& a,
                    uint32_t stamp_) {
    const int64_t nm = a.nmax * lanes, nd_ = a.maxd * lanes,
                  nh = a.hcap * lanes;
    uint64_t* p64 = reinterpret_cast<uint64_t*>(base) + t;
    key = {p64, lanes};
    uint32_t* p32 = reinterpret_cast<uint32_t*>(p64 - t + nm) + t;
    row = {p32, lanes};
    dslot = {p32 += nm, lanes};
    hnode = {p32 += nd_, lanes};
    hstamp = {p32 += nh, lanes};
    I* pi = reinterpret_cast<I*>(p32 - t + nh) + t;
    prev = {pi, lanes};
    left = {pi += nm, lanes};
    right = {pi += nm, lanes};
    parent = {pi += nm, lanes};
    child = {pi += nm, lanes};
    dprev = {pi += nm, lanes};
    deg = {pi += nd_, lanes};
    uint8_t* p8 = reinterpret_cast<uint8_t*>(pi - t + VS_DEG * lanes) + t;
    dist = {p8, lanes};
    flag = {p8 += nm, lanes};
    hkey = {p8 += nm, lanes};
    degree = {p8 += nm, lanes};
    dfw = {p8 += nm, lanes};
    n = nd = hn = deglen = 0;
    hmin = NIL;
    stamp = stamp_;
    hcap = static_cast<uint64_t>(a.hcap);
    fault = false;
  }

  __device__ __forceinline__ uint64_t slot_of(uint64_t k) const {
    return __umul64hi(k * 0x9E3779B97F4A7C15ull, hcap);
  }

  // The node of key k, or NIL.
  __device__ uint32_t find(uint64_t k) const {
    if constexpr (sizeof(I) == 1) {
      for (uint32_t x = 0; x < n; ++x)
        if (key[x] == k) return x;
      return NIL;
    } else {
      for (uint64_t h = slot_of(k); hstamp[h] == stamp;
           h = h + 1 == hcap ? 0 : h + 1)
        if (key[hnode[h]] == k) return hnode[h];
      return NIL;
    }
  }

  // A new node (the host's dist and vals entries): distance 255.
  __device__ uint32_t add(uint64_t k, uint32_t r) {
    const uint32_t x = n++;
    key[x] = k;
    row[x] = r;
    dist[x] = 255;
    flag[x] = 0;
    if constexpr (sizeof(I) > 1) {
      uint64_t h = slot_of(k);
      while (hstamp[h] == stamp) h = h + 1 == hcap ? 0 : h + 1;
      hnode[h] = x;
      hstamp[h] = stamp;
    }
    return x;
  }

  __device__ __forceinline__ uint64_t key_of(uint32_t x) const {
    return x != NIL ? key[x] : 0;
  }

  // -- the Fibonacci heap (core/fibheap.py) ----------------------------

  __device__ void existing_to_root(uint32_t x) {
    const uint32_t m = hmin;
    parent[x] = NIL;
    flag[x] &= ~MARK;
    if (m != NIL) {
      const uint32_t ml = left[m];
      left[m] = x;
      right[x] = m;
      left[x] = ml;
      right[ml] = x;
      if (hkey[m] > hkey[x]) hmin = x;
    } else {
      hmin = x;
      right[x] = x;
      left[x] = x;
    }
  }

  __device__ void remove_from_root(uint32_t x) {
    const uint32_t r = right[x], l = left[x];
    if (r != x) {
      left[r] = l;
      right[l] = r;
    }
    const uint32_t p = parent[x];
    if (p != NIL) {
      if (degree[p] == 1)
        child[p] = NIL;
      else
        child[p] = r;
      degree[p] -= 1;
    }
  }

  __device__ void add_child(uint32_t p, uint32_t c) {
    if (degree[p] == 0) {
      child[p] = c;
      right[c] = c;
      left[c] = c;
    } else {
      const uint32_t c1 = child[p];
      const uint32_t c1l = left[c1];
      left[c1] = c;
      right[c] = c1;
      left[c] = c1l;
      right[c1l] = c;
    }
    parent[c] = p;
    degree[p] += 1;
  }

  __device__ void insert(uint32_t x, int k) {
    if (hn >= VS_HEAP) {
      // evict: the last consolidation-table entry to the top, then
      // extract it (the host's deg_table[-1] has an entry here)
      if (deglen == 0) {
        fault = true;
        return;
      }
      const uint32_t v = deg[deglen - 1];
      if (v != NIL) decrease_key(v, 0);
      const uint32_t gone = extract_min();
      if (fault || gone == NIL) {
        fault = true;
        return;
      }
      flag[gone] |= EVICTED;
    }
    degree[x] = 0;
    parent[x] = NIL;
    child[x] = NIL;
    left[x] = x;
    right[x] = x;
    flag[x] &= ~MARK;
    hkey[x] = k;
    const uint32_t m = hmin;
    if (m != NIL) {
      const uint32_t ml = left[m];
      left[m] = x;
      right[x] = m;
      left[x] = ml;
      right[ml] = x;
    }
    if (m == NIL || hkey[m] > k) hmin = x;
    hn += 1;
  }

  __device__ void consolidate() {
    if (hn <= 1) return;
    deglen = 0;
    uint32_t curr = hmin, it = hmin, roots = 0;
    do {
      if (++roots > n) {  // a root list that does not close
        fault = true;
        return;
      }
      it = right[it];
    } while (it != hmin);
    for (uint32_t r = 0; r < roots; ++r) {
      uint32_t consol = curr;
      curr = right[curr];
      uint32_t d = degree[consol];
      while (true) {
        if (d >= VS_DEG) {
          fault = true;
          return;
        }
        while (d >= deglen) deg[deglen++] = NIL;
        if (deg[d] == NIL) {
          deg[d] = consol;
          break;
        }
        uint32_t other = deg[d];
        if (hkey[consol] > hkey[other]) {
          const uint32_t tmp = consol;
          consol = other;
          other = tmp;
        }
        if (other == consol) break;
        remove_from_root(other);  // link(other, consol)
        add_child(consol, other);
        flag[other] &= ~MARK;
        deg[d] = NIL;
        ++d;
      }
    }
    hmin = NIL;
    for (uint32_t e = 0; e < deglen; ++e)
      if (deg[e] != NIL) existing_to_root(deg[e]);
  }

  __device__ uint32_t extract_min() {
    const uint32_t m = hmin;
    if (m == NIL) return NIL;
    uint32_t curr = child[m];
    const uint32_t dg = degree[m];
    for (uint32_t t = 0; t < dg; ++t) {
      const uint32_t rem = curr;
      curr = right[curr];
      existing_to_root(rem);
    }
    remove_from_root(m);
    hn -= 1;
    if (hn == 0) {
      hmin = NIL;
    } else {
      hmin = right[m];
      const uint32_t ml = left[m];
      left[hmin] = ml;
      right[ml] = hmin;
      consolidate();
    }
    return m;
  }

  __device__ void cut(uint32_t x) {
    remove_from_root(x);
    existing_to_root(x);
  }

  __device__ void decrease_key(uint32_t x, int k) {
    // an evicted node has left the heap's map; a key is never raised
    if ((flag[x] & EVICTED) || k > hkey[x]) return;
    hkey[x] = k;
    uint32_t p = parent[x];
    if (p != NIL && k < hkey[p]) {
      cut(x);
      // cascading cut from the old parent
      uint32_t y = p;
      while ((p = parent[y]) != NIL) {
        if (!(flag[y] & MARK)) {
          flag[y] |= MARK;
          break;
        }
        cut(y);
        y = p;
      }
    }
    if (hmin != NIL && hkey[x] < hkey[hmin]) hmin = x;
  }

  // The host's prev_get(k) for the node x of k (NIL: none): the prev
  // node; *fw gets its direction.  A node's own prev first, else the
  // last destination of k, else (0, false).
  __device__ uint32_t prev_of(const Args& a, int64_t wlo, uint32_t x,
                              uint64_t k, bool* fw) const {
    if (x != NIL && (flag[x] & HAS_PREV)) {
      *fw = flag[x] & PREV_FW;
      return prev[x];
    }
    for (int64_t e = static_cast<int64_t>(nd) - 1; e >= 0; --e)
      if (key_at(a, wlo + dslot[e]) == k) {
        *fw = dfw[e];
        return dprev[e];
      }
    *fw = false;
    return find(0);
  }
};

// -- keys and the targets state ---------------------------------------

__device__ __forceinline__ uint64_t revcomp(uint64_t key, int k) {
  const uint64_t m = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  uint64_t x = (~key & m) << (64 - 2 * k);
  x = ((x & 0x3333333333333333ull) << 2) | ((x >> 2) & 0x3333333333333333ull);
  x = ((x & 0x0F0F0F0F0F0F0F0Full) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0Full);
  x = ((x & 0x00FF00FF00FF00FFull) << 8) | ((x >> 8) & 0x00FF00FF00FF00FFull);
  x = ((x & 0x0000FFFF0000FFFFull) << 16) |
      ((x >> 16) & 0x0000FFFF0000FFFFull);
  return ((x << 32) | (x >> 32)) & m;
}

// Whether `key` is in the targets map of the branch point at c; *slot
// gets its first queue slot (-1 when the queue lacks it).
__device__ bool in_map(const Args& a, int64_t c, int64_t wlo, int64_t whi,
                       uint64_t key, int64_t* slot) {
  int64_t first = -1, last = -1;
  for (int64_t p = wlo; p < whi; ++p)
    if (key_at(a, p) == key) {
      if (first < 0) first = p - wlo;
      last = p;
    }
  *slot = first;
  if (first < 0) return false;
  int64_t from = last - a.max_span + 1;
  if (from < a.k) from = a.k;
  if (from < a.lo) from = a.lo;
  int64_t to = c + a.k;
  if (to > a.lo + a.nloc - 1) to = a.lo + a.nloc - 1;
  for (int64_t p = to; p >= from; --p)
    if (key_at(a, p) == key) return false;
  return true;
}

// -- the search --------------------------------------------------------

template <typename I>
__global__ void __launch_bounds__(VS_LANES)
    variant_search(const Args a, int64_t j0) {
  using S = Search<I>;
  constexpr uint32_t NIL = S::NIL;
  const int64_t j = j0 + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= a.nsearch) return;
  extern __shared__ uint64_t smem[];
  uint8_t* base =
      a.state ? a.state + static_cast<int64_t>(blockIdx.x) * blockDim.x *
                              a.bytes
              : reinterpret_cast<uint8_t*>(smem);
  S s(base, blockDim.x, threadIdx.x, a, static_cast<uint32_t>(j + 1));

  const int k = a.k;
  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int64_t crel = a.rows[j];
  const int64_t c = crel + a.lo;
  const uint64_t skey = key_at(a, c);
  const bool sfw = a.isfw[crel] != 0;
  const bool has_ref = c + 1 <= a.kcount - 1;
  const uint64_t ref = has_ref ? key_at(a, c + 1) : 0;
  const int64_t wlo = c + k + 1;
  const int64_t whi =
      c + k + a.max_span + 1 < a.kcount ? c + k + a.max_span + 1 : a.kcount;

  s.add(skey, 0);
  s.dist[0] = 1;
  s.insert(0, 1);
  int64_t depth = 0;
  bool dir = true;
  int64_t lookups = 0, hits = 0;
  while (s.hn > 0 && depth < a.depth + 1 && !s.fault) {
    const uint32_t u = s.extract_min();
    if (s.fault) break;
    const uint64_t ukey = s.key[u];
    const int64_t* fp =
        u == 0 ? a.fws + 4 * crel : a.tfw + 4 * static_cast<int64_t>(s.row[u]);
    const int64_t* bp =
        u == 0 ? a.bws + 4 * crel : a.tbw + 4 * static_cast<int64_t>(s.row[u]);
    int64_t f[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __ldg(fp + i);
      b[i] = __ldg(bp + i);
    }
    // at depth 0 the host's prev is empty, and every later node has one
    if (s.flag[u] & HAS_PREV) dir = s.flag[u] & PREV_FW;

    uint64_t ck[4];
    uint8_t cfw[4], cdir[4];
    int ne = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (depth == 0) dir = sfw;
      if (!(dir ? f[i] != 0 : b[i] > a.cutoff)) continue;
      const uint64_t raw = dir ? (ukey >> 2) | ((uint64_t)i << (2 * (k - 1)))
                               : ((ukey << 2) & mask) | (uint64_t)i;
      const uint64_t rc = revcomp(raw, k);
      const bool fw = raw <= rc;
      const uint64_t key = fw ? raw : rc;
      if (has_ref && key == ref) continue;
      ck[ne] = key;
      cfw[ne] = fw;
      cdir[ne] = dir;
      ++ne;
    }
    for (int e = 0; e < ne; ++e) {
      const uint64_t key = ck[e];
      int64_t slot;
      if (in_map(a, c, wlo, whi, key, &slot)) {
        if (s.nd >= a.maxd) {
          s.fault = true;
          break;
        }
        s.dslot[s.nd] = static_cast<uint32_t>(slot);
        s.dprev[s.nd] = u;
        s.dfw[s.nd] = cdir[e];
        ++s.nd;
        continue;
      }
      // check_next
      uint32_t x = s.find(key);
      if (x != NIL && (s.flag[x] & CACHED)) {
        ++hits;
      } else {
        ++lookups;
        const int64_t r = bucket_find(a.tkeys, a.starts, a.nb, a.shift,
                                      static_cast<int64_t>(key ^ BIAS));
        if (r < 0) continue;  // absent: explored, nothing inserted
        if (x != NIL) {
          s.flag[x] |= CACHED;
        } else {
          if (s.n >= a.nmax) {
            s.fault = true;
            break;
          }
          x = s.add(key, static_cast<uint32_t>(r));
          s.flag[x] = CACHED;
          s.insert(x, 0);
          if (s.fault) break;
        }
      }
      int alt = s.dist[u];
      if (alt < 255) ++alt;
      if (alt < s.dist[x]) {
        const bool ndir = cfw[e] ? cdir[e] : !cdir[e];
        s.prev[x] = u;
        s.flag[x] = (s.flag[x] & ~PREV_FW) | HAS_PREV | (ndir ? PREV_FW : 0);
        s.dist[x] = alt;
        s.decrease_key(x, alt);
      }
    }
    ++depth;
  }
  a.counts[2 * j] = lookups;
  a.counts[2 * j + 1] = hits;
  if (s.fault) {
    atomicAdd(a.used + 2, 1ull);
    return;
  }
  if (s.nd == 0) return;

  const unsigned long long p0 = atomicAdd(a.used, (unsigned long long)s.nd);
  for (uint32_t e = 0; e < s.nd; ++e) {
    const int64_t slot = s.dslot[e];
    const uint64_t dkey = key_at(a, wlo + slot);
    bool fw;
    // node = prev_get(destination)[0]; i: its steps to the source
    const uint32_t x0 = s.prev_of(a, wlo, s.find(dkey), dkey, &fw);
    uint32_t x = x0;
    int64_t i = 0;
    while (s.key_of(x) != skey) {
      if (i > s.n) {  // a prev chain that misses the source
        atomicAdd(a.used + 2, 1ull);
        return;
      }
      x = s.prev_of(a, wlo, x, s.key_of(x), &fw);
      ++i;
    }
    const int64_t ref_len = slot + k;
    int type;
    int64_t out_len = 1, bb = i - ref_len;
    x = x0;
    uint32_t nx = s.prev_of(a, wlo, x, s.key_of(x), &fw);
    if (ref_len > k) {
      type = COM;
      out_len = ref_len - k + 1;
      bb = ref_len - k;
    } else if (i == ref_len) {
      type = SNV;
    } else if (i > ref_len) {
      type = DEL;
      --bb;
      x = nx;
      nx = s.prev_of(a, wlo, x, s.key_of(x), &fw);
    } else {
      type = INS;
    }
    const int64_t nbases = bb >= 0 ? bb + 1 : 0;
    const unsigned long long b0 =
        nbases ? atomicAdd(a.used + 1, (unsigned long long)nbases) : 0;
    // the host appends a base a step, then reverses: fill from the end
    for (int64_t t = nbases - 1; t >= 0; --t) {
      const uint64_t xk = s.key_of(x);
      const int code = fw ? (int)(xk & 3) : 3 - (int)((xk >> (2 * (k - 1))) & 3);
      if (b0 + t < (unsigned long long)a.cap_bases) a.bases[b0 + t] = code;
      x = nx;
      nx = s.prev_of(a, wlo, x, s.key_of(x), &fw);
    }
    const unsigned long long pi = p0 + e;
    if (pi < (unsigned long long)a.cap_paths) {
      int64_t* rec = a.paths + 5 * pi;
      rec[0] = c + k;
      rec[1] = type;
      rec[2] = out_len;
      rec[3] = nbases;
      rec[4] = (int64_t)b0;
    }
  }
}

template <typename I>
cudaError_t launch(int64_t blocks, int lanes, int64_t smem,
                   cudaStream_t stream, const Args& a, int64_t j0) {
  variant_search<I><<<(unsigned)blocks, lanes, (size_t)smem, stream>>>(a, j0);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kq

// The state bytes one search of `depth` takes in the global buffer of
// kq_variant_search, against a table of `rows` rows; 0 when the search
// fits shared memory and needs no buffer.
extern "C" int kq_variant_search_bytes(int64_t depth, int64_t rows,
                                       int64_t* bytes) {
  using namespace kq;
  if (depth < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  const Bounds b = bounds(depth, rows);
  *bytes = b.shared ? 0 : b.bytes;
  return 0;
}

// Table (device form): tkeys [t] sorted unique, 16-byte aligned, tfw /
// tbw [t, 4], t < 2^32; its bucket directory (ops/index.py): starts
// [nb + 1] and shift.  The window: keys [nloc] (biased, buffer
// positions lo + i, per-position sentinels where invalid), isfw [nloc]
// (0/1 bytes), fws / bws [nloc, 4] (the scan's probe of keys), rows
// [nsearch] (the branch points, ascending, buffer-relative; each found,
// at or after the buffer's first max_span positions), kcount (the
// segment's k-mer positions), k in 1..32, max_span, cutoff, depth >= 0.
// Outputs: counts [nsearch, 2] (lookups, cache hits); paths [cap_paths,
// 5] and bases [cap_bases] (codes 0-3), filled up to the counts that
// used [3] (zeroed by the caller) gets: path records, bases, and
// searches that broke an invariant (0 unless the kernel is wrong).
// state: zeroed device bytes, at least kq_variant_search_bytes of them
// when that is not 0 (else unused); the more there are, the more
// searches a launch runs.  A launch with nothing to search launches no
// kernel.
extern "C" int kq_variant_search(
    const int64_t* tkeys, const int64_t* tfw, const int64_t* tbw,
    int64_t t, const int64_t* starts, int64_t nb, int64_t shift,
    const int64_t* keys, const uint8_t* isfw, const int64_t* fws,
    const int64_t* bws, int64_t nloc, const int64_t* rows, int64_t nsearch,
    int64_t lo, int64_t kcount, int64_t k, int64_t max_span,
    int64_t cutoff, int64_t depth, int64_t* counts, int64_t* paths,
    int64_t cap_paths, uint8_t* bases, int64_t cap_bases, int64_t* used,
    uint8_t* state, int64_t state_bytes, void* stream) {
  using namespace kq;
  if (depth < 0 || t < 0 || k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  const Bounds b = bounds(depth, t);
  Args a;
  a.tkeys = tkeys;
  a.tfw = tfw;
  a.tbw = tbw;
  a.starts = starts;
  a.nb = nb;
  a.shift = (int)shift;
  a.keys = keys;
  a.isfw = isfw;
  a.fws = fws;
  a.bws = bws;
  a.nloc = nloc;
  a.rows = rows;
  a.nsearch = nsearch;
  a.lo = lo;
  a.kcount = kcount;
  // a span past the segment reads as the whole segment, and keeps the
  // window's ends clear of overflow
  a.max_span = max_span < kcount ? max_span : kcount;
  a.cutoff = cutoff;
  a.depth = depth;
  a.k = (int)k;
  a.nmax = b.nmax;
  a.maxd = b.maxd;
  a.hcap = b.hcap;
  a.bytes = b.bytes;
  a.counts = counts;
  a.paths = paths;
  a.cap_paths = cap_paths;
  a.bases = bases;
  a.cap_bases = cap_bases;
  a.used = reinterpret_cast<unsigned long long*>(used);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsearch <= 0) return (int)cudaSuccess;
  if (b.shared) {
    a.state = nullptr;
    const int64_t smem = VS_LANES * b.bytes;
    cudaError_t err = cudaFuncSetAttribute(
        variant_search<uint8_t>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    return (int)launch<uint8_t>(ceil_div(nsearch, VS_LANES), VS_LANES, smem,
                                s, a, 0);
  }
  if (!state || state_bytes < b.bytes) return (int)cudaErrorInvalidValue;
  a.state = state;
  const int64_t fit = state_bytes / b.bytes;
  const int64_t lanes = fit < VS_LANES ? fit : VS_LANES;
  const int64_t blocks = fit / lanes;
  for (int64_t j0 = 0; j0 < nsearch; j0 += blocks * lanes) {
    const int64_t left = ceil_div(nsearch - j0, lanes);
    const cudaError_t err = launch<uint32_t>(
        left < blocks ? left : blocks, (int)lanes, 0, s, a, j0);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

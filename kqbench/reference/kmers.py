"""Canonical k-mers and their count table, in plain NumPy.

The semantics are kreeq's (github.com/vgl-hub/kreeq): bases A, C, G, T
are 0-3 and any other byte breaks a k-mer; a k-mer and its reverse
complement are one key, the smaller of the two when each is packed with
its first base in the lowest two bits; every occurrence of a key in the
reads adds one to its coverage and, for each neighbour base present,
one to the edge counter toward that base, read in the key's own
orientation (fw: the base after it, bw: the base before it).  Counters
hold 32 bits and saturate.

Nothing here reads what the program under test made: it works from the
base sequences the benchmark generated.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

BAD = 4
U32_MAX = (1 << 32) - 1
# the 8-bit counter of the control (see control.py)
U8_MAX = 255

CTOI = np.full(256, BAD, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    CTOI[_b] = _i
    CTOI[_b + 32] = _i  # lower case

# the narrowest type that holds a packed m-mer, m a power of two
_TYPES = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint16,
          16: np.uint32, 32: np.uint64}


def _packed(c: np.ndarray, k: int, reverse: bool) -> np.ndarray:
    """The k-mer at each window of `c` (base codes 0-3) packed two bits
    a base: forward with the first base in the lowest bits, or, with
    `reverse`, with the first base in the highest bits.  Packed m-mers
    give the 2m-mers by doubling, in the narrowest type that holds
    them, and k is a sum of powers of two."""
    parts = {1: c}
    m = 1
    while 2 * m <= k:
        f = parts[m].astype(_TYPES[2 * m])
        lo, hi = (f[m:], f[:len(f) - m]) if reverse else (f[:len(f) - m],
                                                          f[m:])
        parts[2 * m] = lo | (hi << _TYPES[2 * m](2 * m))
        m *= 2
    p = len(c) - k + 1
    out = np.zeros(p, np.uint64)
    off = 0
    for bit in sorted(parts, reverse=True):
        if k & bit:
            shift = 2 * (k - off - bit) if reverse else 2 * off
            out |= parts[bit][off:off + p].astype(np.uint64) << np.uint64(
                shift)
            off += bit
    return out


@dataclass
class Windows:
    """Every k-mer window of a code array: its canonical key, whether
    the forward strand is the canonical one, whether it holds only
    bases, and the codes of the base before and after it (BAD where
    there is none)."""

    key: np.ndarray  # uint64 [p]
    isfw: np.ndarray  # bool [p]
    valid: np.ndarray  # bool [p]
    prev: np.ndarray  # uint8 [p]
    next: np.ndarray  # uint8 [p]


def windows(codes: np.ndarray, k: int) -> Windows:
    """The windows of `codes` (uint8, 0-3 bases and BAD elsewhere);
    len(codes) >= k."""
    n = len(codes)
    p = n - k + 1
    c = codes & 3
    fw = _packed(c, k, False)
    # the reverse complement packs the complements first base highest
    rc = _packed(c ^ 3, k, True)
    isfw = fw <= rc
    bad = np.zeros(n + 1, np.int64)
    np.cumsum(codes > 3, out=bad[1:])
    prev = np.empty(p, np.uint8)
    prev[0] = BAD
    prev[1:] = codes[:p - 1]
    nxt = np.full(p, BAD, np.uint8)
    nxt[:p - 1] = codes[k:]
    return Windows(np.minimum(fw, rc), isfw, bad[k:] == bad[:p],
                   prev, nxt)


def edge_bits(w: Windows) -> np.ndarray:
    """Bit b of a window's byte: bits 0-3 the fw edge to base b, bits
    4-7 the bw edge to base b - 4, in the canonical orientation."""
    one = np.uint8(1)
    has_p, has_n = w.prev <= 3, w.next <= 3
    pc, nc = w.prev & 3, w.next & 3
    e_fw = (np.where(has_n, one << nc, 0)
            | np.where(has_p, one << (4 + pc), 0))
    e_rc = (np.where(has_p, one << (3 - pc), 0)
            | np.where(has_n, one << (7 - nc), 0))
    return np.where(w.isfw, e_fw, e_rc).astype(np.uint8)


@dataclass
class Table:
    """The sorted table of distinct canonical keys with their counters."""

    k: int
    keys: np.ndarray  # uint64 [n], ascending
    cov: np.ndarray  # uint64 [n]
    fw: np.ndarray  # uint64 [n, 4]
    bw: np.ndarray  # uint64 [n, 4]

    def saturated(self, top: int) -> "Table":
        return Table(self.k, self.keys, *(np.minimum(x, np.uint64(top))
                                          for x in (self.cov, self.fw,
                                                    self.bw)))


# windows worked out at a time inside a block: arrays this small stay
# in cache and reuse freed memory
_SUB = 1 << 18


def _records(codes: np.ndarray, k: int):
    """Sorted distinct (key, edge byte) records of one block of reads,
    packed as key << 8 | edges, with how often each occurs."""
    n = len(codes)
    out = []
    for a in range(0, n - k + 1, _SUB):
        b = min(a + _SUB, n - k + 1)
        # one base before and k after: the windows a..b-1 and their
        # neighbours
        lo = max(a - 1, 0)
        w = windows(codes[lo:min(b + k, n)], k)
        sel = slice(a - lo, a - lo + b - a)
        rec = (w.key[sel] << np.uint64(8)) | edge_bits(w)[sel].astype(
            np.uint64)
        out.append(rec[w.valid[sel]])
    if not out:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    rec = np.sort(np.concatenate(out))
    if len(rec) == 0:
        return rec, np.zeros(0, np.int64)
    head = np.empty(len(rec), bool)
    head[0] = True
    np.not_equal(rec[1:], rec[:-1], out=head[1:])
    at = np.flatnonzero(head)
    return rec[at], np.diff(np.append(at, len(rec)))


def _reduce(rec: np.ndarray, cnt: np.ndarray, k: int):
    """(keys, cov, fw, bw) of sorted distinct records."""
    keys = rec >> np.uint64(8)
    edges = (rec & np.uint64(0xFF)).astype(np.uint8)
    head = np.empty(len(keys), bool)
    if len(keys):
        head[0] = True
    np.not_equal(keys[1:], keys[:-1], out=head[1:])
    at = np.flatnonzero(head)
    cnt = cnt.astype(np.uint64)
    cov = np.add.reduceat(cnt, at) if len(at) else np.zeros(0, np.uint64)
    bits = [np.add.reduceat(cnt * ((edges >> b) & 1), at) if len(at)
            else np.zeros(0, np.uint64) for b in range(8)]
    fw = np.stack(bits[:4], 1) if len(at) else np.zeros((0, 4), np.uint64)
    bw = np.stack(bits[4:], 1) if len(at) else np.zeros((0, 4), np.uint64)
    return keys[at], cov, fw, bw


def _merge(pieces, k: int):
    """Merge one key range's sorted pieces of (record, count)."""
    if not pieces:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                np.zeros((0, 4), np.uint64), np.zeros((0, 4), np.uint64))
    rec = np.concatenate([r for r, _c in pieces])
    cnt = np.concatenate([c for _r, c in pieces])
    # a stable sort merges the sorted runs
    order = np.argsort(rec, kind="stable")
    rec, cnt = rec[order], cnt[order]
    head = np.empty(len(rec), bool)
    if len(rec):
        head[0] = True
    np.not_equal(rec[1:], rec[:-1], out=head[1:])
    at = np.flatnonzero(head)
    if len(at):
        cnt = np.add.reduceat(cnt, at)
    return _reduce(rec[at], cnt, k)


# key ranges the records are split into before the final merges
_PARTS = 64


def count_table(stream: np.ndarray, k: int, blocks, threads=None) -> Table:
    """The table of every valid k-mer of `stream`, a code array of reads
    each followed by a BAD separator.  `blocks` are (start, end) ranges
    of the stream that begin and end at a read boundary; each block is
    counted on its own and the blocks' records merged by key range.
    Needs 2k + 8 <= 64 (k <= 28), so that a key and its edge byte pack
    into one word."""
    if 2 * k + 8 > 64:
        raise ValueError(f"the reference table packs k <= 28, not {k}")
    threads = threads or os.cpu_count() or 1
    shift = max(2 * k - 6, 0)
    bounds = np.array([(p << shift) << 8 for p in range(_PARTS)]
                      + [(1 << 64) - 1], np.uint64)
    parts = [[] for _ in range(_PARTS)]

    def block(r):
        a, b = r
        # a BAD in front: the block's first base has no base before it
        codes = np.empty(b - a + 1, np.uint8)
        codes[0] = BAD
        codes[1:] = stream[a:b]
        return _records(codes, k)

    with ThreadPoolExecutor(threads) as pool:
        for rec, cnt in pool.map(block, blocks):
            cut = np.searchsorted(rec, bounds)
            cut[-1] = len(rec)
            for p in range(_PARTS):
                if cut[p + 1] > cut[p]:
                    parts[p].append((rec[cut[p]:cut[p + 1]],
                                     cnt[cut[p]:cut[p + 1]]))
        merged = list(pool.map(lambda ps: _merge(ps, k), parts))
    keys, cov, fw, bw = (np.concatenate([m[i] for m in merged])
                         for i in range(4))
    top = np.uint64(U32_MAX)
    return Table(k, keys, np.minimum(cov, top), np.minimum(fw, top),
                 np.minimum(bw, top))


def read_blocks(offsets: np.ndarray, bases: int):
    """Ranges of a separated read stream (read i at offsets[i] + i, then
    its separator) holding whole reads of about `bases` bases each."""
    ends = offsets[1:] + np.arange(1, len(offsets))
    out, a = [], 0
    while a < len(ends):
        start = 0 if a == 0 else int(ends[a - 1])
        b = int(np.searchsorted(ends, start + bases, side="left"))
        b = min(max(b, a + 1), len(ends))
        out.append((start, int(ends[b - 1])))
        a = b
    return out


def separated(codes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The reads of `codes` (read i at offsets[i]:offsets[i + 1]) each
    followed by one BAD."""
    return np.append(np.insert(codes, offsets[1:-1], BAD), np.uint8(BAD))

"""Host-side canonical-key arithmetic (counterpart of
kreeq_tpu/core/keys.py, unchanged).

Keys are reversible 2-bit packings (first base in the low bits), so the
reference's string round-trips (reverseHash + re-hash, reference:
src/kreeq.cpp:432-433, src/subgraph.cpp:581-597 buildNextKmer) become
integer shifts here.

Everything here works on the u64 form of keys (Python ints, numpy
uint64), the JAX package's form, not on the port's biased int64:
convert at the boundary with constants.keys_to_u64 / keys_from_u64.
"""

from __future__ import annotations

from typing import Tuple

from ..constants import ITOC


def mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def revcomp_key(key: int, k: int) -> int:
    out = 0
    for i in range(k):
        out = (out << 2) | (3 - ((key >> (2 * i)) & 3))
    return out


def canonical(key: int, k: int) -> Tuple[int, bool]:
    """(canonical key, isFw); isFw = forward packing <= revcomp packing."""
    rc = revcomp_key(key, k)
    return (key, True) if key <= rc else (rc, False)


def key_to_seq(key: int, k: int) -> str:
    """reverseHash equivalent: forward string of a key."""
    return "".join(ITOC[(key >> (2 * i)) & 3] for i in range(k))


def seq_to_key(seq: str) -> int:
    from ..constants import CTOI

    key = 0
    for i, c in enumerate(seq):
        key |= int(CTOI[ord(c)]) << (2 * i)
    return key


def next_key_fw(key: int, base: int, k: int) -> int:
    """Shift one base forward: kmer[1:] + base (reference buildNextKmer
    fw branch)."""
    return (key >> 2) | (base << (2 * (k - 1)))


def next_key_bw(key: int, base: int, k: int) -> int:
    """Shift one base backward: base + kmer[:-1] (reference
    buildNextKmer bw branch)."""
    return ((key << 2) & mask(k)) | base


# -- vectorized (numpy) versions ---------------------------------------------


def revcomp_keys_np(keys, k: int):
    """Vectorized reverse complement of packed u64 keys."""
    import numpy as np

    m = np.uint64((1 << (2 * k)) - 1)
    x = (~keys & m) << np.uint64(64 - 2 * k)
    for sh, mm in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                   (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        mm = np.uint64(mm)
        x = ((x & mm) << np.uint64(sh)) | ((x >> np.uint64(sh)) & mm)
    return ((x << np.uint64(32)) | (x >> np.uint64(32))) & m


def canonical_np(keys, k: int):
    """Vectorized canonical(): (canonical keys, isFw)."""
    import numpy as np

    rc = revcomp_keys_np(keys, k)
    isfw = keys <= rc
    return np.where(isfw, keys, rc), isfw


def neighbors8_np(keys, k: int, rc=None):
    """Canonical neighbour keys of each key, [n, 8] in the scan order
    of the reference's search loops: (fw0, bw0, fw1, bw1, ..., fw3, bw3)
    — i.e. for each base i, the forward then the backward extension
    (reference: src/subgraph.cpp:329-356).

    A neighbour's reverse complement is the key's reverse complement
    shifted one base the other way, so given `rc` (the rc of `keys`,
    computed once per n keys) no per-neighbour bit-reversal is needed
    — 8x less revcomp work than canonical_np on all 8n neighbours.
    """
    import numpy as np

    keys = np.asarray(keys, np.uint64)
    if rc is None:
        rc = revcomp_keys_np(keys, k)
    m = np.uint64((1 << (2 * k)) - 1)
    bases = np.arange(4, dtype=np.uint64)[None, :]
    comp = np.uint64(3) - bases
    top = np.uint64(2 * (k - 1))
    raw_fw = (keys[:, None] >> np.uint64(2)) | (bases << top)
    rc_fw = ((rc[:, None] << np.uint64(2)) & m) | comp
    raw_bw = ((keys[:, None] << np.uint64(2)) & m) | bases
    rc_bw = (rc[:, None] >> np.uint64(2)) | (comp << top)
    out = np.empty((keys.shape[0], 8), np.uint64)
    out[:, 0::2] = np.minimum(raw_fw, rc_fw)
    out[:, 1::2] = np.minimum(raw_bw, rc_bw)
    return out


def isin_sorted_np(sorted_keys, queries):
    """Membership of `queries` in the ascending array `sorted_keys`."""
    import numpy as np

    if sorted_keys.size == 0:
        return np.zeros(np.shape(queries), bool)
    idx = np.searchsorted(sorted_keys, queries)
    idx = np.minimum(idx, sorted_keys.size - 1)
    return sorted_keys[idx] == queries

"""Base-encoding tables shared across the framework.

The 2-bit base alphabet (A=0, C=1, G=2, T=3, complement = 3-x) is pinned
by the reference's edge-complement arithmetic (reference:
src/graph-builder.cpp:107-109) and validated bit-for-bit against the
testFiles/test1.kreeq database fixture.
"""

import numpy as np

# Sentinel code for any non-ACGT byte (N, read separators, ...).  Any
# code > 3 invalidates a k-mer window and breaks edge continuity,
# mirroring the reference's ctoi table semantics (reference:
# src/graph-builder.cpp:79-84).
BAD = 4

LARGEST_U32 = 0xFFFFFFFF  # saturation bound (reference: include/kreeq.h:68)

# char byte -> 2-bit code (case-insensitive); everything else -> BAD
CTOI = np.full(256, BAD, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    CTOI[ord(_b)] = _i
    CTOI[ord(_b.lower())] = _i

ITOC = np.array(list("ACGT"), dtype="U1")

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A",
         "a": "t", "c": "g", "g": "c", "t": "a"}


def revcom(seq: str) -> str:
    """Reverse complement preserving case (reference: gfalibs revCom)."""
    return "".join(_COMP.get(c, c) for c in reversed(seq))


def seq_to_codes(seq: str) -> np.ndarray:
    """Convert a sequence string to a uint8 code array (BAD for non-ACGT)."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return CTOI[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    return "".join(ITOC[c] if c <= 3 else "N" for c in codes)


# ---------------------------------------------------------------------------
# Dtype rule of the port (every module follows it)
#
# Keys.  A key is torch.int64 holding u64 ^ (1 << 63), where u64 is the
# JAX package's packed canonical k-mer.  The map is an order-preserving
# bijection from unsigned to signed order, so sorting, searching and
# comparing int64 keys gives the u64 order at every k <= 32.  The JAX
# SENTINEL 0xFFFF_FFFF_FFFF_FFFF becomes INT64_MAX and still sorts last;
# no canonical key can equal it (TT..T's reverse complement AA..A packs
# to 0, so TT..T is never canonical).
#
# Counters.  cov [n], fw [n, 4] and bw [n, 4] are torch.int64 with values
# in [0, 2^32 - 1]; merges saturate explicitly at LARGEST_U32.
#
# Layout.  Public functions keep the JAX package's layout: keys [n],
# cov [n], fw [n, 4], bw [n, 4], padded to the input length with a
# SENTINEL tail (zero counters), plus the real row count n.

KEY_BIAS = -(1 << 63)  # 1 << 63 as an int64 bit pattern
SENTINEL = (1 << 63) - 1  # INT64_MAX = biased 0xFFFF_FFFF_FFFF_FFFF


def keys_from_u64(keys: np.ndarray) -> np.ndarray:
    """JAX-package u64 keys -> the port's biased int64 keys (numpy)."""
    u = np.ascontiguousarray(keys, dtype=np.uint64)
    return (u ^ np.uint64(1 << 63)).view(np.int64)


def keys_to_u64(keys: np.ndarray) -> np.ndarray:
    """The port's biased int64 keys -> JAX-package u64 keys (numpy)."""
    i = np.ascontiguousarray(keys, dtype=np.int64)
    return i.view(np.uint64) ^ np.uint64(1 << 63)

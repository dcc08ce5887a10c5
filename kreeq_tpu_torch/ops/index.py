"""The bucket directory of a sorted k-mer table: where each key prefix
starts, so that a probe searches one bucket instead of the whole table.

Counterpart of kreeq_tpu/ops/kmers.py `build_bucket_index` and the
capping of kreeq_tpu/core/table.py `_build_bucket`.  A key's bucket is
the top `bits` bits of its 2k-bit packed k-mer, `u64 >> (2k - bits)`;
in the port's biased int64 keys (u64 ^ 2^63, constants.py) that is
`(uint64)(key ^ INT64_MIN) >> shift`.  `starts[b]` is the first table
row whose key lies in bucket b or later, so the rows of bucket b are
`[starts[b], starts[b + 1])`, and a key that the table holds sits
there.  The probes of ops/csrc/probe_qv.cu, probe_select.cu and
probe_sorted.cu read two entries of the directory and search that range
only.

Every entry is capped at the first SENTINEL row, so a SENTINEL tail
lies in no bucket.  The directory is built once per table
(KmerTable.bucket_index caches it) and is the same on both devices.
"""

from __future__ import annotations

import math

import torch

from ..constants import KEY_BIAS, SENTINEL

# The directory's entries are int64 (row counts pass 2^31 in later
# slices), 8 B each: 2^22 buckets are 32 MB, inside the H100's 50 MB
# L2, and about 6 rows a bucket at 24.8M rows.  Each of the three
# probes ran at 22 bits as fast as at 20 and 21, or faster, on the H100
# (PERF.md).
MAX_BITS = 22


def bucket_bits(rows: int, k: int) -> int:
    """Bits of the directory of a table of `rows` rows: one bit past the
    table size (about half a row a bucket, as the JAX package's
    `_build_bucket` takes), at least 8, at most MAX_BITS and 2k."""
    return min(max(8, math.ceil(math.log2(max(rows, 2))) + 1), MAX_BITS,
               2 * k)


def bucket_index(tkeys: torch.Tensor, k: int, bits: int | None = None):
    """(starts int64 [2^bits + 1], shift = 2k - bits) of the sorted keys
    `tkeys` (unique, a SENTINEL tail allowed), on their device.

    One searchsorted of the 2^bits bucket boundaries against the table;
    every entry is capped at the first SENTINEL row, found on the device
    (no host sync).  `bits` defaults to bucket_bits(len(tkeys), k)."""
    if bits is None:
        bits = bucket_bits(tkeys.shape[0], k)
    if not 1 <= bits <= 2 * k <= 64:
        raise ValueError(f"bucket_index: bits {bits} outside [1, 2k] at "
                         f"k = {k}")
    shift = 2 * k - bits
    dev = tkeys.device
    b = torch.arange(1 << bits, dtype=torch.int64, device=dev)
    if 2 * k == 64:
        # INT64_MIN + (b << shift) without overflowing int64 at k = 32
        bounds = (b - (1 << (bits - 1))) << shift
    else:
        bounds = (b << shift) + KEY_BIAS
    last = torch.full((1,), SENTINEL, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(tkeys, torch.cat([bounds, last]))
    return torch.minimum(starts, starts[-1]), shift


def bucket_of(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """The bucket of each (non-SENTINEL) biased key: `(key >> shift) -
    (INT64_MIN >> shift)` with arithmetic shifts, the kernels'
    `(uint64)(key ^ INT64_MIN) >> shift`."""
    return (keys >> shift) - (KEY_BIAS >> shift)

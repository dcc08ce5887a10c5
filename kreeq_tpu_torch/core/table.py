"""KmerTable: the device-resident sorted k-mer count table.

Counterpart of kreeq_tpu/core/table.py for the single-device build: a
sorted structure of arrays {keys, cov, fw[4], bw[4]} of exactly n rows
on one device, in the port's dtypes (constants.py).  The build counts
read chunks and tree-merges the chunk tables on the device through the
kernel wrappers of ops/kernels.py.  The lookups of the variants and
subgraph paths are `probe_device` / `probe` (batched, through
probe_sorted_cuda) and `lookup` (scalar, on a host copy); on the card
every probe, these and the validate probes, searches through the bucket
directory that `bucket_index` builds once per table.

Not yet ported: the host-merge spill for tables beyond device memory,
table windows, build checkpoints and sharded builds.  A merge that
would not fit in device memory raises instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..constants import keys_from_u64, keys_to_u64

MAP_COUNT = 128  # on-disk partition count, pinned by .kreeq/.index files

# device bytes a merge of m rows allocates: the output (80 B; the
# kernel's per-tile scratch is under a byte a row)
_MERGE_BYTES_PER_ROW = 81


def _check_fits(rows: int, device: torch.device) -> None:
    """Raise when a merge of `rows` rows would not fit in device memory
    (the out-of-core build, which spills such merges to the host, is
    not yet ported)."""
    if device.type != "cuda":
        return
    free, _total = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    need = rows * _MERGE_BYTES_PER_ROW
    if need > free:
        raise RuntimeError(
            f"out-of-core build not yet ported: merging {rows} rows needs "
            f"{need} bytes on {device}, {free} are free")


class TreeMerger:
    """Pairwise tree-merge of per-chunk count parts, on the device.

    A part is (keys, cov, fw, bw, n): a sorted table with a SENTINEL
    tail and its real row count n as a 0-d device tensor.  Level i holds
    at most one part, the merge of 2^i chunks, so every merge joins two
    parts of similar size (the JAX TreeMerger's policy, without its
    host spill).  Stored parts are trimmed to their n rows (a copy, so
    the untrimmed buffer is freed) at the next push; fresh parts enter
    merges with their SENTINEL tails."""

    def __init__(self):
        self.levels = []

    @staticmethod
    def _trim(part):
        keys, cov, fw, bw, n = part
        m = int(n)
        if m < keys.shape[0]:
            return (keys[:m].clone(), cov[:m].clone(), fw[:m].clone(),
                    bw[:m].clone(), n)
        return part

    def merge(self, stored, fresh):
        from ..ops.kernels import merge_sorted_cuda

        a = self._trim(stored)[:4]
        b = fresh[:4]
        _check_fits(a[0].shape[0] + b[0].shape[0], a[0].device)
        return merge_sorted_cuda(*a, *b)

    def push(self, part):
        # retrim the stored levels first: untrimmed merge outputs would
        # hold device memory at several times their content
        levels = self.levels
        for j, lv in enumerate(levels):
            if lv is not None:
                levels[j] = self._trim(lv)
        i = 0
        while True:
            if i == len(levels):
                levels.append(part)
                return
            if levels[i] is None:
                levels[i] = part
                return
            part = self.merge(levels[i], part)
            levels[i] = None
            i += 1

    def finalize(self):
        """Reduce the levels to one trimmed (keys, cov, fw, bw), or None
        when no part was pushed."""
        acc = None
        for part in self.levels:
            if part is None:
                continue
            acc = part if acc is None else self.merge(acc, self._trim(part))
        self.levels = []
        return None if acc is None else self._trim(acc)[:4]


@dataclass
class TableStats:
    total: int
    unique: int
    distinct: int
    edges: int
    histogram: Dict[int, int]  # cov -> rows with that cov

    def missing(self, k: int) -> int:
        return 4 ** k - self.distinct


@dataclass
class KmerTable:
    """Sorted unique k-mer table of exactly n rows on one device."""

    k: int
    keys: torch.Tensor  # int64 [n], sorted ascending
    cov: torch.Tensor  # int64 [n]
    fw: torch.Tensor  # int64 [n, 4]
    bw: torch.Tensor  # int64 [n, 4]
    # host copy for lookup(): keys int64 [n], counters u32; made once
    _host: Optional[Tuple[np.ndarray, ...]] = field(
        default=None, init=False, repr=False, compare=False)
    # bucket directory of the CUDA probes: (starts, shift); made once
    _bucket: Optional[Tuple[torch.Tensor, int]] = field(
        default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @classmethod
    def empty(cls, k: int, device) -> "KmerTable":
        z = torch.zeros((0, 4), dtype=torch.int64, device=device)
        return cls(k, torch.zeros(0, dtype=torch.int64, device=device),
                   torch.zeros(0, dtype=torch.int64, device=device), z,
                   z.clone())

    def __len__(self) -> int:
        return self.keys.shape[0]

    @classmethod
    def from_numpy(cls, k: int, keys, cov, fw, bw, device) -> "KmerTable":
        """From the JAX package's table arrays (u64 keys, u32 counters)."""
        def dev(a):
            return torch.from_numpy(
                np.ascontiguousarray(a).astype(np.int64)).to(device)

        return cls(k, torch.from_numpy(keys_from_u64(keys)).to(device),
                   dev(cov), dev(fw), dev(bw))

    def to_numpy(self):
        """(keys u64 [n], cov u32 [n], fw u32 [n, 4], bw u32 [n, 4]) in
        the JAX package's dtypes."""
        return (keys_to_u64(self.keys.cpu().numpy()),
                *(a.cpu().numpy().astype(np.uint32)
                  for a in (self.cov, self.fw, self.bw)))

    @classmethod
    def from_reads(cls, read_files: Iterable[str], k: int, device,
                   chunk: int | None = None) -> "KmerTable":
        """Count the canonical k-mers of all reads on `device`.

        `chunk` (bases per device step) defaults to the KREEQ_TPU_CHUNK
        environment variable, else 8M.  Per chunk: kmer_positions, then
        count_sorted_cuda; chunk tables are tree-merged with
        merge_sorted_cuda (reference build phase:
        src/graph-builder.cpp:34-223)."""
        from ..io.fastx import iter_reads
        from ..ops import kmers as K
        from ..ops.kernels import count_sorted_cuda
        from ..utils import log

        if chunk is None:
            chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
        read_files = list(read_files)

        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        tm = TreeMerger()
        for i, buf in enumerate(K.pack_reads(read_iter(), k, chunk)):
            codes = torch.from_numpy(buf).to(device)
            keys, _isfw, edges, valid = K.kmer_positions(codes, k)
            tm.push(count_sorted_cuda(keys, edges, valid))
            if log.verbose_flag:
                log.verbose(f"counted chunk {i}")
        acc = tm.finalize()
        if acc is None:
            return cls.empty(k, device)
        return cls(k, *acc)

    def probe_device(self, qkeys: torch.Tensor):
        """Batched lookup of int64 keys on the table's device: (found,
        cov, fw, bw) tensors in query order, through probe_sorted_cuda;
        on CUDA with the table's bucket directory (the CPU's plain probe
        needs none, so none is built there)."""
        from ..ops.kernels import probe_sorted_cuda

        index = self.bucket_index() if self.device.type == "cuda" else None
        return probe_sorted_cuda(self.keys, self.cov, self.fw, self.bw,
                                 qkeys, index)

    def probe(self, qkeys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
        """Batched lookup of int64 keys on the table's device: (found
        bool, cov u32, fw u32 [., 4], bw u32 [., 4]) in numpy, the JAX
        package's dtypes."""
        q = qkeys.shape[0]
        if len(self) == 0:
            return (np.zeros(q, bool), np.zeros(q, np.uint32),
                    np.zeros((q, 4), np.uint32),
                    np.zeros((q, 4), np.uint32))
        found, cov, fw, bw = self.probe_device(qkeys)
        return (found.cpu().numpy(),
                *(a.cpu().numpy().astype(np.uint32) for a in (cov, fw, bw)))

    def bucket_index(self) -> Tuple[torch.Tensor, int]:
        """(starts, shift) on the table's device (ops/index.py): the
        bucket directory that the probe_qv, probe_select and
        probe_sorted kernels search through; built at the first call and
        kept, so a run's validate and variants probes share one."""
        if self._bucket is None:
            from ..ops.index import bucket_index

            self._bucket = bucket_index(self.keys, self.k)
        return self._bucket

    def lookup(self, key: int):
        """Scalar host lookup of a u64 key (a Python int, the host
        search's form): (fw u32[4], bw u32[4], cov) or None.  The first
        call copies the table to the host once (keys stay int64 in the
        port's order; about 44 bytes a row), so a search of many lookups
        never waits on the device."""
        if self._host is None:
            from ..utils import log

            with log.phase("table host copy"):
                self._host = (self.keys.cpu().numpy(),
                              *(a.cpu().numpy().astype(np.uint32)
                                for a in (self.cov, self.fw, self.bw)))
        keys, cov, fw, bw = self._host
        # u64 ^ 2^63 as int64 is u64 - 2^63 for every u64
        biased = np.int64(key - (1 << 63))
        i = int(np.searchsorted(keys, biased))
        if i < len(keys) and keys[i] == biased:
            return fw[i], bw[i], int(cov[i])
        return None

    def stats(self) -> TableStats:
        """DBG summary numbers (reference: src/graph-builder.cpp:240-295).

        "Total edges" reproduces the reference's ternary-precedence
        accident: an edge slot counts once if either the fw or bw
        counter is non-zero (reference: src/graph-builder.cpp:253-254).
        """
        vals, counts = torch.unique(self.cov, return_counts=True)
        return TableStats(total=int(self.cov.sum()),
                          unique=int((self.cov == 1).sum()),
                          distinct=len(self),
                          edges=int(((self.fw > 0) | (self.bw > 0)).sum()),
                          histogram=dict(zip(vals.tolist(),
                                             counts.tolist())))

    def merge(self, other: "KmerTable") -> "KmerTable":
        """Union with saturating adds on the table's device (replaces
        `kreeq union`, reference: src/graph-builder.cpp:297-351).  A
        union that would not fit in device memory raises (the sharded
        and host-spill unions are not yet ported)."""
        from ..ops.kernels import merge_sorted_cuda

        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        _check_fits(len(self) + len(other), self.device)
        part = merge_sorted_cuda(self.keys, self.cov, self.fw, self.bw,
                                 other.keys, other.cov, other.fw, other.bw)
        return KmerTable(self.k, *TreeMerger._trim(part)[:4])

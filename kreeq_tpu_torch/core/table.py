"""KmerTable: the sorted k-mer count table, on the card or on the host.

Counterpart of kreeq_tpu/core/table.py: a sorted structure of arrays
{keys, cov, fw[4], bw[4]} of exactly n rows.  The build counts read
chunks and tree-merges the chunk tables through the kernel wrappers of
ops/kernels.py.  The lookups of the variants and subgraph paths are
`probe_device` / `probe` (batched, through probe_sorted_cuda) and
`lookup` (scalar, on a host copy); on the card every probe searches
through a bucket directory (`bucket_index`).

A table lives in one of two forms:
  device - the port's dtypes (constants.py) on the compute device, 80 B
           a row; every table of at most `max_device_rows()` rows;
  host   - a table above that cap (out of core): int64 keys and the
           counters' u32 bit patterns as int32, 44 B a row, in host
           memory (pinned when the compute device is a card).  It is
           probed in disjoint key-range windows of at most the cap
           (`window_ranges`), one window on the device at a time
           (`device_arrays(w)`, widened to the device form at upload),
           each with its own directory (`bucket_index(w)`).
Merges whose result would pass `_host_merge_threshold()` rows run on
the host (`parallel_host_merge`: `host_merge_sorted` on slices of
disjoint key ranges, one thread a core), in the build and in `merge`;
a result above the cap stays on the host.  The JAX package's switches
KREEQ_TPU_MAX_TABLE_ROWS and KREEQ_TPU_HOST_MERGE_ROWS set the two
caps; KREEQ_TPU_BUILD_CKPT makes the build resumable (build_ckpt.py).

Under a torch.distributed group of several ranks (`group`), the build
counts each chunk on its owner ranks (ShardedCounter, through
parallel/sharded.py) and gathers the table to every rank, and a union
merges key-range slice pairs, one a rank (`merge_sharded`): on large
inputs, or on any with KREEQ_TPU_FORCE_SHARDED=1, as the JAX package
shards over its devices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..constants import LARGEST_U32, keys_from_u64, keys_to_u64
from ..utils import log

MAP_COUNT = 128  # on-disk partition count, pinned by .kreeq/.index files

# device bytes of one row of the device form: an int64 key and nine
# int64 counters
_ROW_BYTES = 80
# the largest bucket directory (ops/index.MAX_BITS = 22): 2^22 + 1
# int64 starts, beside the table while the probes run
_DIR_BYTES = 8 * ((1 << 22) + 1)
# device memory assumed where there is no card: the JAX package's
# fallback
_CPU_MEMORY = 16 << 30


def max_device_rows(device: torch.device) -> int:
    """Row cap of one device-resident table or window.

    KREEQ_TPU_MAX_TABLE_ROWS overrides (tests force tiny caps to
    exercise the windows).  Otherwise 45% of the device's memory (the
    JAX package's share, leaving the rest to the probes' queries and
    outputs) less the largest bucket directory, over the port's 80 B
    row; 16 GiB stands for the memory of the CPU."""
    env = os.environ.get("KREEQ_TPU_MAX_TABLE_ROWS")
    if env:
        return max(int(env), 1)
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
    else:
        total = _CPU_MEMORY
    return max((int(total * 0.45) - _DIR_BYTES) // _ROW_BYTES, 1 << 20)


def _host_merge_threshold(device: torch.device) -> int:
    """Merged-row count above which a merge runs on the host.

    A device merge holds its two inputs and its output (160 B a merged
    row), and the build's tree levels below the threshold stay on the
    device too, so the threshold is a quarter of the row cap, as in the
    JAX package.  KREEQ_TPU_HOST_MERGE_ROWS overrides (tests force tiny
    values)."""
    env = os.environ.get("KREEQ_TPU_HOST_MERGE_ROWS")
    if env:
        return max(int(env), 1)
    return max(max_device_rows(device) // 4, 1 << 20)


def device_gather_rows(device: torch.device) -> int:
    """Rows above which a sharded table is gathered into host memory
    (parallel/sharded.gather_table).  A gather on the device holds
    about three device rows a gathered row at its peak (the pieces and
    their concatenation, the sort, the widened result), as a device
    merge holds its inputs and output, so it stays on the device up to
    a quarter of the row cap."""
    return max(max_device_rows(device) // 4, 1)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 holding their u32 bit pattern
    (counters saturate at 0xFFFFFFFF), so a copy moves 4 bytes a value,
    not 8."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 u32 bit patterns -> the device form's int64 values."""
    return x.to(torch.int64) & LARGEST_U32


def _u32(x: torch.Tensor) -> np.ndarray:
    """A counter tensor of either form as a host u32 array."""
    if x.dtype == torch.int64:
        x = u32_bits(x)
    return x.cpu().numpy().view(np.uint32)


def _satadd(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """x + y on u32 arrays, saturating at 0xFFFFFFFF."""
    s = x + y
    s[s < x] = LARGEST_U32
    return s


def host_merge_sorted(ak, ac, af, ab, bk, bc, bf, bb):
    """Union of two sorted unique host tables (int64 keys, u32
    counters) with saturating adds at 0xFFFFFFFF: the out-of-core
    sibling of merge_sorted_cuda, with the result of the JAX
    host_merge_sorted (the port's keys sort in the u64 order).  Two
    searchsorted passes place every row directly, at its final
    position: no sort of the concatenation, and a key of both tables
    takes one row, whose counters are the sums."""
    na, nb = len(ak), len(bk)
    if na == 0:
        return bk.copy(), bc.copy(), bf.copy(), bb.copy()
    if nb == 0:
        return ak.copy(), ac.copy(), af.copy(), ab.copy()
    ia = np.searchsorted(bk, ak)  # b rows below each a row
    ib = np.searchsorted(ak, bk)  # a rows below each b row
    shared_b = ak[np.minimum(ib, na - 1)] == bk
    # shared b rows below each index of b: those rows merge into a rows
    below = np.zeros(nb + 1, np.int64)
    np.cumsum(shared_b, out=below[1:])
    pos_a = np.arange(na) + ia - below[ia]
    only_b = ~shared_b
    pos_b = (np.arange(nb) + ib - below[:-1])[only_b]
    m = na + nb - int(below[-1])
    keys = np.empty(m, np.int64)
    cov = np.empty(m, np.uint32)
    fw = np.empty((m, 4), np.uint32)
    bw = np.empty((m, 4), np.uint32)
    ja = np.nonzero(bk[np.minimum(ia, nb - 1)] == ak)[0]  # shared a rows
    jb = ia[ja]  # their b rows
    for out, xa, xb in ((keys, ak, bk), (cov, ac, bc), (fw, af, bf),
                        (bw, ab, bb)):
        out[pos_a] = xa
        out[pos_b] = xb[only_b]
        if out is not keys:
            out[pos_a[ja]] = _satadd(xa[ja], xb[jb])
    return keys, cov, fw, bw


# merged rows of one slice pair of a parallel host merge, at least
_HOST_MERGE_SLICE = 1 << 20


def parallel_host_merge(a, b):
    """host_merge_sorted of two host tables on every CPU core: both are
    cut at the same keys into slice pairs of disjoint key ranges (a
    searchsorted-left on both sides puts a key of both tables into one
    pair), the pairs merge in threads (numpy leaves the GIL in its
    loops), and the slices' results are concatenated in key order."""
    from concurrent.futures import ThreadPoolExecutor

    rows = len(a[0]) + len(b[0])
    parts = min(len(os.sched_getaffinity(0)),
                max(rows // _HOST_MERGE_SLICE, 1))
    if parts == 1 or not len(a[0]) or not len(b[0]):
        return host_merge_sorted(*a, *b)
    src = a[0] if len(a[0]) >= len(b[0]) else b[0]
    cuts = src[(np.arange(1, parts) * len(src)) // parts]
    ai = np.concatenate(([0], np.searchsorted(a[0], cuts), [len(a[0])]))
    bi = np.concatenate(([0], np.searchsorted(b[0], cuts), [len(b[0])]))

    def merge(p):
        return host_merge_sorted(*(x[ai[p]:ai[p + 1]] for x in a),
                                 *(x[bi[p]:bi[p + 1]] for x in b))

    with ThreadPoolExecutor(parts) as pool:
        outs = list(pool.map(merge, range(parts)))
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(4))


def _host_merge(a, b):
    """parallel_host_merge as the span kq.build.host_merge (counters
    build.host_merge_rows_in, build.host_merge_rows_out)."""
    with log.span("kq.build.host_merge"):
        out = parallel_host_merge(a, b)
    log.count("build.host_merge_rows_in", len(a[0]) + len(b[0]))
    log.count("build.host_merge_rows_out", len(out[0]))
    log.verbose(f"host merge {len(a[0])}+{len(b[0])} -> {len(out[0])} rows")
    return out


def _is_host(part) -> bool:
    return isinstance(part[0], np.ndarray)


def _to_host(part):
    """A trimmed part as host arrays (int64 keys, u32 counters)."""
    if _is_host(part):
        return part[:4]
    return (part[0].cpu().numpy(), *(_u32(x) for x in part[1:4]))


def part_to_rows(part, device):
    """A trimmed part as rows for a collective on `device`: int64 keys
    [m] and the nine counters (cov, fw, bw) as their u32 bit patterns
    in int32 [m, 9], 44 B a row."""
    keys, cov, fw, bw = part[:4]
    if _is_host(part):
        vals = np.concatenate([cov[:, None], fw, bw], 1).view(np.int32)
        return (torch.from_numpy(keys).to(device),
                torch.from_numpy(vals).to(device))
    return (keys.to(device),
            u32_bits(torch.cat([cov[:, None], fw, bw], 1)).to(device))


def rows_to_part(keys, vals):
    """part_to_rows' rows as a trimmed part in the device form."""
    wide = widen_u32(vals)
    return (keys, wide[:, 0].contiguous(), wide[:, 1:5].contiguous(),
            wide[:, 5:9].contiguous())


def rows_to_host_part(keys, vals):
    """part_to_rows' rows in host memory as a trimmed host part (int64
    keys, u32 counters)."""
    v = vals.numpy().view(np.uint32)
    return (keys.numpy(), *(np.ascontiguousarray(x) for x in
                            (v[:, 0], v[:, 1:5], v[:, 5:9])))


def _sharded(group) -> bool:
    """A group of several ranks (None: this process alone)."""
    return group is not None and dist.get_world_size(group) > 1


def _force_sharded() -> bool:
    return os.environ.get("KREEQ_TPU_FORCE_SHARDED") == "1"


def shard_merge(group, rows: int) -> bool:
    """Whether a union of `rows` rows in all runs across the ranks of
    `group` (merge_sharded): under a group of several ranks, above 2^23
    rows or with KREEQ_TPU_FORCE_SHARDED=1 (the JAX package's rule for
    its devices)."""
    return _sharded(group) and (_force_sharded() or rows > (1 << 23))


def _to_device(part, device):
    """A trimmed part as device tensors in the device form."""
    if not _is_host(part):
        return part[:4]
    keys, cov, fw, bw = part[:4]
    return (torch.from_numpy(keys).to(device),
            *(widen_u32(torch.from_numpy(x.view(np.int32)).to(device))
              for x in (cov, fw, bw)))


class TreeMerger:
    """Pairwise tree-merge of per-chunk count parts.

    A part is (keys, cov, fw, bw, n): a sorted table with its real row
    count n, either on the device (a SENTINEL tail allowed, n a 0-d
    tensor) or on the host (trimmed, int64 keys and u32 counters, n an
    int).  Level i holds at most one part, the merge of 2^i chunks, so
    every merge joins two parts of similar size (the JAX TreeMerger's
    policy).  A merge whose operands hold more than
    `_host_merge_threshold()` rows runs on the host and leaves a host
    part; a smaller one runs on the device through merge_sorted_cuda,
    uploading a host operand.  Stored device parts are trimmed to their
    n rows (a copy, so the untrimmed buffer is freed) at the next push;
    fresh parts enter merges with their SENTINEL tails."""

    def __init__(self, device: torch.device):
        self.device = device
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
        """The span kq.build.merge (counters build.host_merges,
        build.device_merges)."""
        from ..ops.kernels import merge_sorted_cuda

        with log.span("kq.build.merge"):
            if int(stored[4]) + fresh[0].shape[0] > _host_merge_threshold(
                    self.device):
                log.count("build.host_merges")
                out = _host_merge(_to_host(self._trim(stored)),
                                  _to_host(self._trim(fresh)))
                return (*out, len(out[0]))
            log.count("build.device_merges")
            a = _to_device(self._trim(stored), self.device)
            b = _to_device(fresh, self.device)
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
        """Reduce the levels to one trimmed (keys, cov, fw, bw), on the
        device or on the host, or None when no part was pushed."""
        acc = None
        for part in self.levels:
            if part is None:
                continue
            acc = part if acc is None else self.merge(acc, self._trim(part))
        self.levels = []
        return None if acc is None else self._trim(acc)[:4]


class ShardedCounter:
    """Chunk counter over a process group (counterpart of the JAX
    ShardedCounter; every rank of `group` holds one).

    Each round, every rank counts one chunk with sharded_count, so each
    rank receives the records of the keys it owns, and tree-merges that
    sub-table into its own TreeMerger; a rank without a chunk that round
    enters the same collectives with an empty one.  drain() gathers
    every rank's shard to every rank.  Two ways to feed it:
      add(buf)  - a stream that every rank reads whole: chunk i is rank
                  i % n's, and a round runs every n chunks;
      step(buf) - this rank's own chunk of a round, or None, when every
                  rank reads its own inputs (multihost.py)."""

    def __init__(self, group, k: int, device):
        self.group = group
        self.k = k
        self.device = torch.device(device)
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.tm = TreeMerger(self.device)
        self.mine = None  # this rank's chunk of the round add() fills
        self.seen = 0  # chunks add() took since the last drain
        self.chunks = 0  # chunks this rank counted

    def add(self, buf) -> None:
        if self.seen % self.n == self.rank:
            self.mine = buf
        self.seen += 1
        if self.seen % self.n == 0:
            self.step(self.mine)
            self.mine = None

    def step(self, buf) -> None:
        from ..parallel.sharded import sharded_count

        if buf is None:
            codes = torch.zeros(0, dtype=torch.uint8, device=self.device)
        else:
            codes = torch.from_numpy(buf).to(self.device)
            self.chunks += 1
        part = sharded_count(codes, self.k, self.group)
        if int(part[4]):
            self.tm.push(part)

    def drain(self):
        """The whole table of what was counted since the last drain, on
        every rank, sorted by key, or None when no rank counted a
        k-mer: each rank's shard is its TreeMerger's result, and
        gather_table gives every rank the union, disjoint by ownership,
        in the device form, or as host arrays above
        device_gather_rows()."""
        from ..parallel.sharded import gather_table

        if self.seen % self.n:
            self.step(self.mine)
        self.mine, self.seen = None, 0
        acc = self.tm.finalize()
        if acc is None:
            e = KmerTable.empty(self.k, self.device)
            acc = (e.keys, e.cov, e.fw, e.bw)
        return gather_table(acc, self.group, self.device, sort=True)


@dataclass
class TableStats:
    total: int
    unique: int
    distinct: int
    edges: int
    histogram: Dict[int, int]  # cov -> rows with that cov

    def missing(self, k: int) -> int:
        return 4 ** k - self.distinct


def _pinned(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not pin:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


@dataclass
class KmerTable:
    """Sorted unique k-mer table of exactly n rows, in the device form
    (int64 tensors on the compute device) or, with `compute` set, in
    the host form (int64 keys, int32 u32-pattern counters in host
    memory; probed on `compute` window by window)."""

    k: int
    keys: torch.Tensor  # int64 [n], sorted ascending
    cov: torch.Tensor  # int64 [n] (host form: int32 u32 patterns)
    fw: torch.Tensor  # int64 [n, 4] (host form: int32)
    bw: torch.Tensor  # int64 [n, 4] (host form: int32)
    # the device a host-form table's windows are probed on; None for
    # the device form
    compute: Optional[torch.device] = field(default=None, repr=False,
                                            compare=False)
    # host copy for lookup(): keys int64 [n], counters u32; made once
    _host: Optional[Tuple[np.ndarray, ...]] = field(
        default=None, init=False, repr=False, compare=False)
    # bucket directory of the CUDA probes: (starts, shift); made once
    _bucket: Optional[Tuple[torch.Tensor, int]] = field(
        default=None, init=False, repr=False, compare=False)
    # the one window on the device: (w, arrays) and (w, directory)
    _win: Optional[tuple] = field(default=None, init=False, repr=False,
                                  compare=False)
    _win_bucket: Optional[tuple] = field(default=None, init=False,
                                         repr=False, compare=False)

    @property
    def on_host(self) -> bool:
        return self.compute is not None

    @property
    def device(self) -> torch.device:
        """The compute device: where queries go and probes run."""
        return self.compute if self.on_host else self.keys.device

    @classmethod
    def empty(cls, k: int, device) -> "KmerTable":
        z = torch.zeros((0, 4), dtype=torch.int64, device=device)
        return cls(k, torch.zeros(0, dtype=torch.int64, device=device),
                   torch.zeros(0, dtype=torch.int64, device=device), z,
                   z.clone())

    def __len__(self) -> int:
        return self.keys.shape[0]

    @classmethod
    def host_form(cls, k: int, keys, cov, fw, bw, device) -> "KmerTable":
        """A host-resident table from host arrays (int64 keys in the
        port's order, u32 counters), probed on `device`; pinned when
        `device` is a card, so a window's upload is one DMA."""
        device = torch.device(device)
        pin = device.type == "cuda"
        arrs = [_pinned(keys, pin)] + [
            _pinned(np.ascontiguousarray(x, np.uint32).view(np.int32), pin)
            for x in (cov, fw, bw)]
        table = cls(k, *arrs, compute=device)
        log.verbose(f"table of {len(table)} rows held on the host in "
                    f"{len(table.window_ranges())} windows")
        return table

    @classmethod
    def placed(cls, k: int, part, device) -> "KmerTable":
        """The table of a trimmed part (host arrays or device tensors):
        in the host form above max_device_rows(device) rows, else in
        the device form on `device`."""
        if len(part[0]) > max_device_rows(device):
            return cls.host_form(k, *_to_host(part), device)
        return cls(k, *_to_device(part, device))

    @classmethod
    def from_numpy(cls, k: int, keys, cov, fw, bw, device) -> "KmerTable":
        """From the JAX package's table arrays (u64 keys, u32 counters),
        placed by row count."""
        return cls.placed(k, (keys_from_u64(keys),
                              *(np.array(a, np.uint32)  # a writable copy
                                for a in (cov, fw, bw))), device)

    def host_arrays(self):
        """(keys int64 [n], cov u32 [n], fw u32 [n, 4], bw u32 [n, 4])
        on the host: views of the host form, a copy of the device
        form."""
        if self.on_host:
            return (self.keys.numpy(),
                    *(x.numpy().view(np.uint32)
                      for x in (self.cov, self.fw, self.bw)))
        return _to_host((self.keys, self.cov, self.fw, self.bw))

    def to_numpy(self):
        """(keys u64 [n], cov u32 [n], fw u32 [n, 4], bw u32 [n, 4]) in
        the JAX package's dtypes."""
        keys, cov, fw, bw = self.host_arrays()
        return keys_to_u64(keys), cov, fw, bw

    @classmethod
    def from_reads(cls, read_files: Iterable[str], k: int, device,
                   chunk: int | None = None, group=None) -> "KmerTable":
        """Count the canonical k-mers of all reads on `device`.

        `chunk` (bases per device step) defaults to the KREEQ_TPU_CHUNK
        environment variable, else 8M.  Per chunk: count_chunk_cuda (the
        extraction's count form, the sort, count_runs); chunk tables are
        tree-merged (TreeMerger;
        reference build phase: src/graph-builder.cpp:34-223).  With
        KREEQ_TPU_BUILD_CKPT set, the build is resumable
        (build_ckpt.from_reads_checkpointed).

        `group`: a torch.distributed group whose every rank calls with
        the same reads.  With several ranks, the build is sharded
        (ShardedCounter) when the reads pass 8 chunks of bytes or
        KREEQ_TPU_FORCE_SHARDED=1 (the JAX package's rule for its
        devices), and every rank gets the whole table.

        Spans: kq.build.upload (a chunk's copy to `device`),
        kq.build.count (its count step), kq.build.merge (TreeMerger);
        counter build.rows (the table's)."""
        from ..io.fastx import iter_reads
        from ..ops import kmers as K
        from ..ops.kernels import count_chunk_cuda

        if chunk is None:
            chunk = int(os.environ.get("KREEQ_TPU_CHUNK", 1 << 23))
        read_files = list(read_files)
        device = torch.device(device)
        if not _sharded(group):
            group = None
        elif not _force_sharded():
            # shard only where the inputs amortize the collectives
            try:
                total = sum(os.path.getsize(p) for p in read_files)
            except (OSError, TypeError):
                total = 0
            if total <= 8 * chunk:
                group = None
        ckpt = os.environ.get("KREEQ_TPU_BUILD_CKPT")
        if ckpt:
            from .build_ckpt import from_reads_checkpointed

            return from_reads_checkpointed(read_files, k, ckpt, device,
                                           chunk=chunk, group=group)

        def read_iter():
            for path in read_files:
                yield from iter_reads(path)

        if group is not None:
            sc = ShardedCounter(group, k, device)
            for buf in K.pack_reads(read_iter(), k, chunk):
                sc.add(buf)
            acc = sc.drain()
        else:
            tm = TreeMerger(device)
            for i, buf in enumerate(K.pack_reads(read_iter(), k, chunk)):
                with log.span("kq.build.upload"):
                    codes = torch.from_numpy(buf).to(device)
                with log.span("kq.build.count"):
                    part = count_chunk_cuda(codes, k)
                tm.push(part)
                if log.verbose_flag:
                    log.verbose(f"counted chunk {i}")
            acc = tm.finalize()
        if acc is None:
            return cls.empty(k, device)
        log.count("build.rows", len(acc[0]))
        return cls.placed(k, acc, device)

    # -- windows -----------------------------------------------------------

    def window_ranges(self):
        """Row ranges [(lo, hi), ...] of the host form's windows (the
        JAX split: as few windows of at most the cap as will do, of
        equal size but the last), or None for the device form."""
        if not self.on_host:
            return None
        n = len(self)
        w = max(-(-n // max_device_rows(self.device)), 1)
        step = -(-n // w)
        return [(i * step, min(n, (i + 1) * step)) for i in range(w)]

    def device_arrays(self, window: int):
        """(keys, cov, fw, bw) of window `window` on the compute device,
        in the device form.  One window is on the device at a time: the
        previous one (and its directory) is freed before the next
        uploads; a window that does not fit raises (torch's
        OutOfMemoryError)."""
        if self._win is not None and self._win[0] == window:
            return self._win[1]
        self._win = self._win_bucket = None
        lo, hi = self.window_ranges()[window]
        dev = self.device
        with log.span("kq.ooc.upload"):
            host = (self.keys[lo:hi], self.cov[lo:hi], self.fw[lo:hi],
                    self.bw[lo:hi])
            arrays = (host[0].to(dev, non_blocking=True),
                      *(widen_u32(x.to(dev, non_blocking=True))
                        for x in host[1:]))
        self._win = (window, arrays)
        return arrays

    def bucket_index(self, window: int | None = None):
        """(starts, shift) on the compute device (ops/index.py): the
        bucket directory that the probe_qv, probe_select and
        probe_sorted kernels search through.  Without `window`, the
        device form's, built at the first call and kept, so a run's
        validate and variants probes share one.  With `window`, the
        directory of that window's rows, built at upload: keys outside
        the window's range fall in empty buckets."""
        from ..ops.index import bucket_index

        if window is None:
            if self._bucket is None:
                self._bucket = bucket_index(self.keys, self.k)
            return self._bucket
        tkeys = self.device_arrays(window)[0]
        if self._win_bucket is None or self._win_bucket[0] != window:
            with log.span("kq.ooc.index"):
                index = bucket_index(tkeys, self.k)
            self._win_bucket = (window, index)
        return self._win_bucket[1]

    def window_index(self, window: int):
        """The directory a CUDA probe of window `window` needs; None on
        the CPU, whose plain probes need none."""
        if self.device.type != "cuda":
            return None
        return self.bucket_index(window)

    def probe_window(self, window: int, qkeys: torch.Tensor):
        """(found, cov, fw, bw) of the queries against window `window`
        only, through probe_sorted_cuda with the window's directory."""
        from ..ops.kernels import probe_sorted_cuda

        tab = self.device_arrays(window)
        index = self.window_index(window)
        log.count("ooc.probe_sorted")
        log.count("ooc.queries", qkeys.shape[0])
        return probe_sorted_cuda(*tab, qkeys, index)

    # -- probing -----------------------------------------------------------

    def probe_device(self, qkeys: torch.Tensor):
        """Batched lookup of int64 keys on the compute device: (found,
        cov, fw, bw) tensors in query order, through probe_sorted_cuda;
        on CUDA with a bucket directory (the CPU's plain probe needs
        none, so none is built there).  The host form probes the whole
        batch against each window in turn; the windows' key ranges are
        disjoint, so the first window that finds a key gives its row."""
        from ..ops.kernels import probe_sorted_cuda
        from ..ops.kmers import combine_probe

        ranges = self.window_ranges()
        if ranges is None:
            index = (self.bucket_index() if self.device.type == "cuda"
                     else None)
            return probe_sorted_cuda(self.keys, self.cov, self.fw, self.bw,
                                     qkeys, index)
        acc = None
        for w in range(len(ranges)):
            res = self.probe_window(w, qkeys)
            acc = res if acc is None else combine_probe(*acc, *res)
        return acc

    def probe(self, qkeys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
        """Batched lookup of int64 keys on the compute device: (found
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

    def lookup(self, key: int):
        """Scalar host lookup of a u64 key (a Python int, the host
        search's form): (fw u32[4], bw u32[4], cov) or None.  The host
        form is searched where it lies; the device form is copied to
        the host at the first call (keys stay int64 in the port's
        order; about 44 bytes a row), so a search of many lookups never
        waits on the device."""
        if self._host is None and self.on_host:
            self._host = self.host_arrays()
        elif self._host is None:
            with log.phase("table host copy"):
                self._host = self.host_arrays()
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
        if self.on_host:
            _keys, cov, fw, bw = self.host_arrays()
            vals, counts = np.unique(cov, return_counts=True)
            return TableStats(total=int(cov.sum(dtype=np.uint64)),
                              unique=int((cov == 1).sum()),
                              distinct=len(self),
                              edges=int(((fw > 0) | (bw > 0)).sum()),
                              histogram=dict(zip(vals.tolist(),
                                                 counts.tolist())))
        vals, counts = torch.unique(self.cov, return_counts=True)
        return TableStats(total=int(self.cov.sum()),
                          unique=int((self.cov == 1).sum()),
                          distinct=len(self),
                          edges=int(((self.fw > 0) | (self.bw > 0)).sum()),
                          histogram=dict(zip(vals.tolist(),
                                             counts.tolist())))

    def merge(self, other: "KmerTable", group=None) -> "KmerTable":
        """Union with saturating adds (replaces `kreeq union`,
        reference: src/graph-builder.cpp:297-351): on the host above
        `_host_merge_threshold()` merged rows, else on the compute
        device through merge_sorted_cuda; the result is placed by its
        row count (KmerTable.placed).  Under a `group` of several ranks
        that all hold both tables, `merge_sharded` when the two hold
        more than 2^23 rows or KREEQ_TPU_FORCE_SHARDED=1 (the JAX
        package's rule for its devices)."""
        from ..ops.kernels import merge_sorted_cuda

        if len(self) == 0:
            return other
        if len(other) == 0:
            return self
        if shard_merge(group, len(self) + len(other)):
            return self.merge_sharded(other, group)
        dev = self.device
        if len(self) + len(other) > _host_merge_threshold(dev):
            out = _host_merge(self.host_arrays(), other.host_arrays())
            return KmerTable.placed(self.k, out, dev)

        def dev_arrays(t):
            if t.on_host:
                return _to_device(t.host_arrays(), dev)
            return t.keys, t.cov, t.fw, t.bw

        part = merge_sorted_cuda(*dev_arrays(self), *dev_arrays(other))
        return KmerTable.placed(self.k, TreeMerger._trim(part)[:4], dev)

    def merge_sharded(self, other: "KmerTable", group) -> "KmerTable":
        """Union across the ranks of `group`, each of which holds both
        tables: every rank merges one key-range slice pair and gets the
        whole result (parallel/sharded.sharded_merge), placed by its
        row count."""
        from ..parallel.sharded import sharded_merge

        def arrays(t):
            return t.host_arrays() if t.on_host else (t.keys, t.cov, t.fw,
                                                      t.bw)

        dev = self.device
        part = sharded_merge(arrays(self), arrays(other), group, dev)
        return KmerTable.placed(self.k, part, dev)

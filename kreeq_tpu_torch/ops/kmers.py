"""Canonical k-mer extraction, counting and merging in plain PyTorch.

Counterpart of kreeq_tpu/ops/kmers.py.  `kmer_positions` and
`count_records`, `sort_keys_edges`, `count_runs`, `merge_sorted` and
`probe_sorted` here are the plain versions of the CUDA kernels in
csrc/kmer_extract.cu (its records and count forms), csrc/sort_records.cu,
csrc/count_runs.cu, csrc/merge_sorted.cu and csrc/probe_sorted.cu;
ops/kernels.py dispatches between each kernel and its plain version by
the device of the tensors.  `pack_reads` is the host's packing of reads
into the chunks those kernels count: numpy, with one copy a chunk from
a parsed batch.

Keys follow the dtype rule in constants.py: int64 holding u64 ^ 2^63,
SENTINEL = INT64_MAX.  The arithmetic below works on the raw u64 bit
patterns held in int64 and applies the bias once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BAD, KEY_BIAS, LARGEST_U32, SENTINEL


def kmer_positions(codes: torch.Tensor, k: int):
    """Per-position canonical keys, orientation, edge bits, validity.

    codes: uint8[N] (0-3 bases, BAD elsewhere), N >= k.  Returns
    (keys int64[P], isfw bool[P], edges uint8[P], valid bool[P]) with
    P = N - k + 1, the same values as the JAX kmer_positions (keys
    biased per the dtype rule).  Edge bits: bit w = fw edge to base w,
    bit 4+w = bw edge to base w.  Windows holding a BAD code read it as
    base 0, as the JAX package does, and are flagged invalid.
    """
    n = codes.shape[0]
    p = n - k + 1
    c = (codes & 3).to(torch.int64)
    # fw = OR_i c[j+i] << 2i and rc = OR_i (3 - c[j+i]) << 2(k-1-i):
    # left shifts only, so int64's arithmetic right shift never enters
    # and k = 32 (bit 63 set) needs no special case
    fw = torch.zeros(p, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    for i in range(k):
        w = c[i:i + p]
        fw |= w << (2 * i)
        rc |= (3 - w) << (2 * (k - 1 - i))
    # unsigned fw <= rc, as a signed compare of the biased patterns
    isfw = (fw ^ KEY_BIAS) <= (rc ^ KEY_BIAS)
    keys = torch.where(isfw, fw, rc) ^ KEY_BIAS

    bad = torch.zeros(n + 1, dtype=torch.int32, device=codes.device)
    bad[1:] = torch.cumsum((codes > 3).to(torch.int32), 0)
    valid = bad[k:k + p] == bad[:p]

    prev = torch.cat([codes.new_full((1,), BAD), codes[:p - 1]])
    nxt = torch.cat([codes[k:], codes.new_full((1,), BAD)])
    prev_ok = prev <= 3
    next_ok = nxt <= 3
    pc = (prev & 3).to(torch.int64)
    nc = (nxt & 3).to(torch.int64)
    one = torch.ones((), dtype=torch.int64, device=codes.device)
    zero = torch.zeros_like(one)
    e_fw = (torch.where(next_ok, one << nc, zero)
            | torch.where(prev_ok, one << (4 + pc), zero))
    e_rc = (torch.where(prev_ok, one << (3 - pc), zero)
            | torch.where(next_ok, one << (7 - nc), zero))
    edges = torch.where(isfw, e_fw, e_rc).to(torch.uint8)
    return keys, isfw, edges, valid


def count_records(codes: torch.Tensor, k: int):
    """The records the count step sorts (plain version of the
    extraction's count form): kmer_positions' keys with SENTINEL where
    the window is invalid, and its edge bits with 0 there."""
    keys, _isfw, edges, valid = kmer_positions(codes, k)
    return torch.where(valid, keys, SENTINEL), torch.where(valid, edges, 0)


def sort_keys_edges(skeys, sedges):
    """Plain version of the sort_records kernel: the records in key
    order, each edge byte beside its key, equal keys in input order (a
    stable sort, so the output is unique).  Run totals do not depend on
    the order of equal keys, so count_runs' output is that of any
    sort."""
    skeys, order = torch.sort(skeys, stable=True)
    return skeys, sedges[order]


def sort_records(keys, edges, valid):
    """Mask invalid records to (SENTINEL, 0) and sort by key, carrying
    the edge bits (sort_keys_edges)."""
    return sort_keys_edges(torch.where(valid, keys, SENTINEL),
                           torch.where(valid, edges, 0))


def _empty_rows(p: int, device):
    keys = torch.full((p,), SENTINEL, dtype=torch.int64, device=device)
    cov = torch.zeros(p, dtype=torch.int64, device=device)
    fw = torch.zeros((p, 4), dtype=torch.int64, device=device)
    bw = torch.zeros((p, 4), dtype=torch.int64, device=device)
    return keys, cov, fw, bw


def run_heads(keys):
    """True at the first row of each run of equal non-SENTINEL keys."""
    head = keys != SENTINEL
    head[1:] &= keys[1:] != keys[:-1]
    return head


def count_runs(skeys, sedges):
    """Plain version of the count_runs kernel: aggregate key-sorted
    (key, edge-bits) records into a sorted unique table.

    Returns (keys [P] with a SENTINEL tail, cov [P], fw [P, 4],
    bw [P, 4], n): cov = run length, fw[w] / bw[w] = records of the run
    with edge bit w / 4+w set.
    """
    p = skeys.shape[0]
    keys, cov, fw, bw = _empty_rows(p, skeys.device)
    head = run_heads(skeys)
    n = head.sum()
    keys[:int(n)] = skeys[head]
    real = skeys != SENTINEL
    run = (torch.cumsum(head, 0) - 1)[real]
    cov.index_add_(0, run, torch.ones_like(run))
    bits = (sedges[real].to(torch.int64)[:, None]
            >> torch.arange(8, device=skeys.device)) & 1
    fw.index_add_(0, run, bits[:, :4].contiguous())
    bw.index_add_(0, run, bits[:, 4:].contiguous())
    return keys, cov, fw, bw, n


def count_sorted(keys, edges, valid):
    """Aggregate (key, edge-bits) records into a sorted unique table
    (contract of the JAX count_sorted; see count_runs for the output)."""
    return count_runs(*sort_records(keys, edges, valid))


def merge_sorted(keys_a, cov_a, fw_a, bw_a, keys_b, cov_b, fw_b, bw_b):
    """Union of two sorted unique tables with saturating adds (plain
    version of the merge_sorted kernel; contract of the JAX
    merge_sorted).

    Either input may carry a SENTINEL tail.  Every row goes straight to
    its merged position (A rows before equal B rows), equal keys are
    summed into the first of the pair, saturating at 0xFFFFFFFF, and
    the heads are compacted to the front.  Output length is
    len(a) + len(b) with a SENTINEL tail, plus n.
    """
    na, nb = keys_a.shape[0], keys_b.shape[0]
    dev = keys_a.device
    pos_a = torch.searchsorted(keys_b, keys_a) + torch.arange(na, device=dev)
    pos_b = (torch.searchsorted(keys_a, keys_b, right=True)
             + torch.arange(nb, device=dev))
    keys = torch.empty(na + nb, dtype=torch.int64, device=dev)
    keys[pos_a] = keys_a
    keys[pos_b] = keys_b
    vals = torch.empty((na + nb, 9), dtype=torch.int64, device=dev)
    vals[pos_a] = torch.cat([cov_a[:, None], fw_a, bw_a], 1)
    vals[pos_b] = torch.cat([cov_b[:, None], fw_b, bw_b], 1)

    head = run_heads(keys)
    # a real row that is not a head is the second of an equal-key pair
    i = torch.nonzero((keys != SENTINEL) & ~head).squeeze(1)
    vals[i - 1] = torch.clamp(vals[i - 1] + vals[i], max=LARGEST_U32)

    okeys, ocov, ofw, obw = _empty_rows(na + nb, dev)
    n = head.sum()
    m = int(n)
    okeys[:m] = keys[head]
    v = vals[head]
    ocov[:m] = v[:, 0]
    ofw[:m] = v[:, 1:5]
    obw[:m] = v[:, 5:9]
    return okeys, ocov, ofw, obw, n


def probe_sorted(tkeys, tcov, tfw, tbw, qkeys):
    """Batched lookup in query order (plain version of the probe_sorted
    kernel; contract of the JAX probe_sorted / probe_merge).

    tkeys is sorted and unique (a SENTINEL tail is allowed).  Returns
    (found bool[q], cov int64[q], fw int64[q, 4], bw int64[q, 4]): found
    = the key is among the table's keys (a SENTINEL query is never
    found; an empty table finds nothing), and the found row's counters,
    0 where nothing was found."""
    q = qkeys.shape[0]
    t = tkeys.shape[0]
    if t == 0:
        zero = torch.zeros((q, 4), dtype=torch.int64, device=qkeys.device)
        return zero[:, 0].bool(), zero[:, 0].clone(), zero, zero.clone()
    row = torch.searchsorted(tkeys, qkeys).clamp_(max=t - 1)
    found = (tkeys[row] == qkeys) & (qkeys != SENTINEL)
    hit = found[:, None]
    return (found, torch.where(found, tcov[row], 0),
            torch.where(hit, tfw[row], 0), torch.where(hit, tbw[row], 0))


def combine_probe(f1, c1, fw1, bw1, f2, c2, fw2, bw2):
    """Fold the probe results of two table windows (counterpart of the
    JAX combine_probe).  The windows' key ranges are disjoint, so at
    most one side finds any query; the first that found it gives its
    counters (both sides hold zeros where they found nothing)."""
    hit = f1[:, None]
    return (f1 | f2, torch.where(f1, c1, c2), torch.where(hit, fw1, fw2),
            torch.where(hit, bw1, bw2))


# ---------------------------------------------------------------------------
# host-side packing


def pack_reads(seqs, k: int, chunk: int):
    """Pack reads into BAD-separated uint8 chunks of `chunk` bytes.

    Reads are never split across chunks (edge context must stay intact;
    the reference processes whole read batches for the same reason,
    reference: src/graph-builder.cpp:75-91).  Reads longer than the
    chunk size are emitted as dedicated right-sized chunks (padded to a
    power of two); the final partial chunk is trimmed to the smallest
    power of two >= 64 that holds it.

    An item of `seqs` is a read (a str or a uint8 code array) or a
    native.ReadBatch, whose reads are cut into chunks with one copy a
    chunk; the stream is byte for byte the one its reads would give
    one by one, and a chunk may hold the end of one item and the start
    of the next.  Each stretch from the generator's start or resume to
    its next chunk is the span `kq.ingest.pack` (counters
    `build.chunks`, `build.chunk_bytes`, and the reads packed from
    batches `ingest.batch_reads` and one by one `ingest.single_reads`);
    the pull of `seqs`, which parses the reads, runs inside it.
    """
    from ..utils import log

    packed = [0, 0]  # reads packed from batches, one by one
    chunks = _pack_reads(seqs, chunk, packed)
    while True:
        with log.span("kq.ingest.pack"):
            buf = next(chunks, None)
            if buf is not None:
                log.count("build.chunks")
                log.count("build.chunk_bytes", buf.nbytes)
            log.count("ingest.batch_reads", packed[0])
            log.count("ingest.single_reads", packed[1])
            packed[:] = 0, 0
        if buf is None:
            return
        yield buf


def _pack_reads(seqs, chunk: int, packed):
    from ..constants import seq_to_codes
    from ..native import ReadBatch

    buf = np.full(chunk, BAD, dtype=np.uint8)
    pos = 0
    for seq in seqs:
        if isinstance(seq, ReadBatch):
            sep, ends = seq.sep, seq.ends
            i, n = 0, len(ends)
            while i < n:
                start = int(ends[i - 1]) if i else 0
                # the reads from i on that fit in the open chunk
                j = int(np.searchsorted(ends, start + chunk - pos,
                                        side="right"))
                if j > i:
                    end = int(ends[j - 1])
                    buf[pos:pos + end - start] = sep[start:end]
                    pos += end - start
                    packed[0] += j - i
                    i = j
                    continue
                if pos > 0:  # read i does not fit in what is left
                    yield buf
                    buf = np.full(chunk, BAD, dtype=np.uint8)
                    pos = 0
                    continue
                # nor in a whole chunk
                packed[0] += 1
                yield _own_chunk(sep[start:int(ends[i]) - 1])
                i += 1
            continue
        codes = seq_to_codes(seq) if isinstance(seq, str) else seq
        m = len(codes)
        packed[1] += 1
        if m > chunk - 1:
            if pos > 0:
                yield buf
                buf = np.full(chunk, BAD, dtype=np.uint8)
                pos = 0
            yield _own_chunk(codes)
            continue
        if pos + m + 1 > chunk:
            yield buf
            buf = np.full(chunk, BAD, dtype=np.uint8)
            pos = 0
        buf[pos:pos + m] = codes
        pos += m + 1  # one BAD separator
    if pos > 0:
        # trim the final partial buffer to a power-of-two size
        size = 64
        while size < pos:
            size *= 2
        yield buf[:size]


def _own_chunk(codes):
    """A chunk of its own for a read longer than the chunk size, padded
    with BAD to the next power of two above its length."""
    m = len(codes)
    big = np.full(1 << int(np.ceil(np.log2(m + 1))), BAD, dtype=np.uint8)
    big[:m] = codes
    return big

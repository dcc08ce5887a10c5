"""Candidate-error discovery: bounded read-graph search per assembly
position (reference: src/variants.cpp).

Counterpart of kreeq_tpu/core/variants.py, in-core path.  For every
unexplained assembly k-mer, a bounded search walks the read DBG from the
last good k-mer toward a sliding window of downstream "target" k-mers; a
reconnection classifies the divergence as SNV/INS/DEL/COM and
reconstructs the alternative sequence by backtracking (reference:
src/variants.cpp:171-310).  The search replicates the reference's quirks
exactly:

  * only the bw-side edge test applies the coverage cutoff
    (ternary-precedence accident, reference: src/variants.cpp:236),
  * depth counts extracted nodes (<= kmerDepth+1 expansions),
  * destinations are capped at 10, the heap at 1000 nodes,
  * queued nodes keep priority 0 (decreaseKey refuses to raise keys),
    so extraction order follows the Fibonacci-heap mechanics.

Two halves per window of positions.  First the scan, on the table's
device: k-mer extraction with per-position sentinels
(`_extract_sentinel`), the table probe through
ops.kernels.probe_sorted_cuda (`KmerTable.probe_device`) and the
depth-0 candidate scan (`_candidate_scan`), in the port's biased int64
keys.  Then the exact Fibonacci-heap search from each branch point the
scan selected.  Against a device-form table on a card
(`_device_search`), one launch of ops.kernels.variant_search_cuda runs
every search of the window, a thread each, and only their path records
come back (`_search_on_card`).  Otherwise the window's keys,
orientations and the counters of the branch points come back in one
bulk copy, and the search runs on u64 Python ints, as in the JAX
package (keys.py; `KmerTable.lookup`; `_search_from_scan`).  Either way
a segment's variants are a PathGroups of packed path records.

Against a host-resident table (out of core, KmerTable.window_ranges)
the scan runs in two passes, the first with the table's windows outer
(`_probe_windows_inverted`), and the anomaly scan probes its segments
in batches (`_probe_segments`), so each window uploads once per pass.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import SENTINEL, keys_to_u64, revcom
from .fibheap import FibonacciHeap
from .keys import canonical, key_to_seq, next_key_bw, next_key_fw
from .table import u32_bits, widen_u32

SNV, INS, DEL, COM = "SNV", "INS", "DEL", "COM"


@dataclass
class DBGpath:
    """Reference: gfalibs DBGpath {type, pos, sequence, refLen}."""

    type: str = SNV
    pos: int = 0
    sequence: str = ""
    ref_len: int = 1


def correct_sequences(dbg) -> None:
    """Serial per segment (reference: src/variants.cpp:40-51)."""
    if not dbg.ui.in_sequence:
        return
    from ..config import get_file_ext

    ext = get_file_ext("." + dbg.ui.out_file)
    to_gfa = ext in ("gfa", "gfa2", "gfa.gz", "gfa2.gz")
    for seg in list(dbg.genome.segments):
        dbg_to_variants(dbg, seg)
        if to_gfa:
            variants_to_gfa(dbg, seg)


def detect_anomalies(dbg, seg, probed=None) -> List[Tuple[int, int]]:
    """Flag positions whose k-mer is missing or whose forward edge to
    the next assembly base is absent (reference:
    src/variants.cpp:406-456 — legacy code whose output is pinned by
    testFiles/random1.anomalies.bed).  Returns merged 1-based inclusive
    ranges of anomalous k-mer start positions.  `probed`: the table's
    (found, cov, fw, bw) of the segment's k-mers, when the caller
    probed them already."""
    from ..ops.kernels import extract_cuda

    k = dbg.k
    ln = len(seg)
    if ln < k:
        return []
    kcount = ln - k + 1
    codes = seg.codes
    table = dbg.table

    keys, isfw, _edges, valid = extract_cuda(
        torch.from_numpy(codes).to(table.device), k)
    found, _cov, rfw, rbw = probed if probed is not None else \
        table.probe(keys)
    isfw = isfw.cpu().numpy()
    # non-ACGT bases are masked to code 0 inside keys; the reference's
    # hash of a code>3 base misses the DB, so an invalid k-mer is never
    # "found" (mirrors validate_positions' found & valid guard)
    found = found & valid.cpu().numpy()

    nxt = codes[k:].astype(np.int64)  # next base per position c<kcount-1
    bad_next = nxt > 3  # IUPAC codes: skip the continuity test
    nxt = nxt & 3
    pos = np.arange(kcount - 1)
    fw_edge = rfw[pos, nxt]
    bw_edge = rbw[pos, 3 - nxt]
    cont_missing = (np.where(isfw[:-1], fw_edge, bw_edge) == 0) & ~bad_next
    anomaly = ~found[:kcount]
    anomaly[:-1] |= found[:kcount - 1] & cont_missing
    anomalies = np.nonzero(anomaly)[0].tolist()

    ranges: List[Tuple[int, int]] = []
    for c in anomalies:
        if ranges and c == ranges[-1][1]:
            ranges[-1] = (ranges[-1][0], c + 1)
        else:
            ranges.append((c, c + 1))
    return [(a + 1, b) for a, b in ranges]


# k-mer positions a batch of the anomaly scan probes at once against a
# host-resident table
_ANOMALY_BATCH = 1 << 24


def _probe_segments(dbg):
    """{segment index: probe result} of every segment's k-mers against
    a host-resident table, in batches of whole segments of up to
    _ANOMALY_BATCH positions: each batch pages the table's windows
    once, instead of once per segment."""
    from ..ops.kernels import extract_cuda

    k = dbg.k
    segs = dbg.genome.segments
    batches, rows = [[]], 0
    for si, seg in enumerate(segs):
        if len(seg) < k:
            continue
        n = len(seg) - k + 1
        if batches[-1] and rows + n > _ANOMALY_BATCH:
            batches.append([])
            rows = 0
        batches[-1].append(si)
        rows += n
    out = {}
    for batch in batches:
        if not batch:
            continue
        res = dbg.table.probe(torch.cat([extract_cuda(torch.from_numpy(
            segs[si].codes).to(dbg.table.device), k)[0] for si in batch]))
        lo = 0
        for si in batch:
            hi = lo + len(segs[si]) - k + 1
            out[si] = tuple(x[lo:hi] for x in res)
            lo = hi
    return out


def write_anomalies(dbg, out_path: str) -> None:
    probed = (_probe_segments(dbg) if dbg.table.window_ranges() is not None
              else {})
    with open(out_path, "w") as fh:
        for si, (seg, path) in enumerate(zip(dbg.genome.segments,
                                             _segment_paths(dbg.genome))):
            for a, b in detect_anomalies(dbg, seg, probed.get(si)):
                fh.write(f"{path}\t{a}\t{b}\n")


def _segment_paths(genome):
    """Path header owning each segment, in segment order."""
    owner = {}
    for path in genome.paths:
        for comp in path.components:
            if comp.ctype == "S":
                owner[comp.id] = path.header
    return [owner.get(seg.uid, seg.header) for seg in genome.segments]


def variants_to_gfa(dbg, seg) -> None:
    """Split a segment at variant sites into a bubble graph
    (reference: src/variants.cpp:312-404)."""
    from ..io.sequence import Edge

    genome = dbg.genome
    old = seg.seq
    header = seg.header
    seq_pos = seg.seq_pos
    processed = 0
    segment_counter = 0
    edge_counter = 0
    s_uids: List[int] = []
    s_uid = None

    def add_seg(name: str, sub: str):
        return genome.add_segment(name, sub, seq_pos=seq_pos)

    def add_edge(a: int, b: int) -> None:
        nonlocal edge_counter
        edge_counter += 1
        genome.add_edge(Edge(genome.next_uid(), len(genome.edges), a, b,
                             "+", "+", "0M",
                             f"{header}.edge.{edge_counter}"))

    for group in seg.variants:
        pos0 = group[0].pos
        segment_counter += 1
        new_seg = add_seg(f"{header}.{segment_counter}",
                          old[processed:pos0])
        for prev_uid in s_uids:
            add_edge(prev_uid, new_seg.uid)
        s_uids = []
        s_uid = new_seg.uid
        alt_counter = 0
        original_added = False
        processed = pos0
        for var in group:
            if var.type != DEL and not original_added:
                segment_counter += 1
                orig = add_seg(f"{header}.{segment_counter}",
                               old[pos0:pos0 + 1])
                add_edge(s_uid, orig.uid)
                s_uids.append(orig.uid)
                original_added = True
                processed += 1
            if var.type in (SNV, DEL):
                alt_counter += 1
                alt = add_seg(
                    f"{header}.{segment_counter}.alt{alt_counter}",
                    var.sequence)
                s_uids.append(alt.uid)
            if var.type == SNV:
                add_edge(s_uid, alt.uid)
            elif var.type == INS:
                s_uids.append(s_uid)
            elif var.type == DEL:
                add_edge(s_uid, alt.uid)
                s_uids.append(s_uid)
    if seg.variants:
        segment_counter += 1
        tail = add_seg(f"{header}.{segment_counter}", old[processed:])
        for prev_uid in s_uids:
            add_edge(prev_uid, tail.uid)
        genome.delete_segment(header)


def _extract_sentinel(codes: torch.Tensor, k: int):
    """K-mer extraction with per-position sentinels for invalid
    windows.  codes: uint8[N] on the table's device.  Returns (keys
    int64[P], isfw bool[P], valid bool[P]), keys biased per the dtype
    rule.

    Non-ACGT windows: the reference hashes garbage bytes into a key
    that misses the DB; a distinct per-position sentinel mirrors that.
    The JAX sentinels, in the port's biased form: for k < 32,
    (1 << 63) | i becomes i >= 0, while every real key (< 4^k <= 2^62
    unbiased) is negative.  At k = 32, first-base-T | last-base-T
    values 3 | i << 2 | 3 << 62 become 3 | i << 2 | 1 << 62: their
    reverse complement (first-base A at the top) is strictly smaller,
    so no canonical key — table entry, valid window, or candidate
    neighbour — can ever equal one."""
    from ..ops.kernels import extract_cuda

    p = codes.shape[0] - k + 1
    keys, isfw, _e, valid = extract_cuda(codes, k)
    iota = torch.arange(p, dtype=torch.int64, device=codes.device)
    if k < 32:
        sentinels = iota
    else:
        sentinels = (1 << 62) | (iota << 2) | 3
    return torch.where(valid, keys, sentinels), isfw, valid


def _candidate_scan(keys, isfw, found, covs, fws, bws, cutoff: int, k: int):
    """Depth-0 candidate-edge scan (the JAX _candidate_scan on int64):
    each position's four fw or four bw canonical neighbours
    (ops/frontier.neighbors8), by its orientation.  Returns (keys,
    isfw, found & has_candidate, covs, fws, bws)."""
    from ..ops.frontier import neighbors8

    nb = neighbors8(keys, k)
    cand = torch.where(isfw[:, None], nb[:, 0::2], nb[:, 1::2])
    cond = torch.where(isfw[:, None], fws > 0, bws > cutoff)
    # past the last position: SENTINEL, which no canonical candidate
    # equals (TT..T is never canonical)
    ref_next = torch.cat([keys[1:], keys.new_full((1,), SENTINEL)])
    has_candidate = (cond & (cand != ref_next[:, None])).any(dim=1)
    return keys, isfw, found & has_candidate, covs, fws, bws


def _variants_window_cap() -> int:
    """Positions per variants-scan window.  KREEQ_TPU_VARIANTS_WINDOW
    overrides (tests force tiny caps to exercise seam handling)."""
    env = os.environ.get("KREEQ_TPU_VARIANTS_WINDOW")
    return int(env) if env else (1 << 22)


def dbg_to_variants(dbg, seg) -> None:
    """Reference: src/variants.cpp:53-169.

    Batched redesign of the reference's per-position loop: one device
    probe answers every position's source-k-mer lookup, and a
    vectorized depth-0 candidate-edge scan identifies the positions
    whose search would terminate immediately with no discoveries
    (edge_count == explored_count == 0 — the overwhelmingly common
    case on a healthy assembly).  Only true branch points run the exact
    Fibonacci-heap search, on the card or on the host
    (`_device_search`), preserving byte-identical output.

    The scan runs in fixed windows of at most _variants_window_cap()
    positions (the reference's analog: map-range paging re-scans,
    src/variants.cpp:75-152), so device memory is bounded regardless
    of segment length.  Window halos make every window byte-exact:
    a RIGHT halo of k+max_span+1 positions covers the targets window
    and the reference-edge key of every core position, and a LEFT halo
    of max_span positions covers the back-occurrence test — in
    targets_state, an occurrence o <= c+k flips a key out of the map
    only when o > a - max_span (a >= c+k+1 being its in-window append
    position), so occurrences older than max_span positions behind the
    window never change the outcome.
    """
    from ..utils import log

    k = dbg.k
    ln = len(seg)
    if ln < k:
        return
    kcount = ln - k + 1
    max_span = dbg.ui.max_span
    cutoff = dbg.ui.cov_cutoff
    codes = seg.codes
    cache: Dict[int, object] = {}

    win = _variants_window_cap()
    lh = max_span                 # left halo (positions)
    rh = k + max_span + 1         # right halo (positions)
    wins = []
    for wa in range(0, kcount, win):
        wb = min(wa + win, kcount)
        wins.append((wa, wb, max(0, wa - lh), min(kcount, wb + rh)))
    nwin = len(wins)

    ranges = dbg.table.window_ranges()
    # against a host-resident table, pass 1: every window's probe of
    # every scan window, table windows outer
    parts = (_probe_windows_inverted(dbg, codes, wins, k, ranges)
             if ranges is not None else None)
    on_card = _device_search(dbg)
    variants = PathGroups()
    for wi, (wa, wb, lo, hi) in enumerate(wins):
        # per-window progress is load-bearing at scale: long-running
        # CLI phases are watchdogged on output cadence
        log.verbose(f"variants window {wi + 1}/{nwin} "
                    f"[{wa}, {wb}) of {kcount}")
        probed = None
        if parts is not None:
            probed = _upload_probe(parts[wi], dbg.table.device)
            parts[wi] = None  # free as we go
        _scan_window_variants(dbg, codes, lo, hi, wa, wb, kcount, k,
                              max_span, cutoff, cache, variants, probed,
                              on_card)
        if log.verbose_flag:
            log.verbose(f"variants window {wi + 1}/{nwin} done "
                        f"({len(variants)} positions with variants)")
    seg.variants = variants


def _probe_windows_inverted(dbg, codes, wins, k: int, ranges):
    """Pass 1 of the variants scan against a host-resident table (the
    JAX _scan_windows_inverted): for each table window, outer, the
    probe of every scan window's keys through the window's directory,
    folded into host accumulators (found, and u32 cov, fw, bw: 37 B a
    position); the windows' key ranges are disjoint, so at most one
    finds a key.  Returns those accumulators per scan window, for pass
    2 (_upload_probe, then the candidate scan and the host search of
    _scan_window_variants).  The transfers: each table window once,
    then each scan window's result once."""
    table = dbg.table
    dev = table.device
    parts = [None] * len(wins)
    for w in range(len(ranges)):
        for wi, (_wa, _wb, lo, hi) in enumerate(wins):
            cbuf = torch.from_numpy(codes[lo:hi + k - 1]).to(dev)
            keys, _isfw, valid = _extract_sentinel(cbuf, k)
            found, cov, fw, bw = table.probe_window(w, keys)
            found = (found & valid).cpu().numpy()
            vals = u32_bits(torch.cat([cov[:, None], fw, bw], 1))
            vals = vals.cpu().numpy().view(np.uint32)
            if parts[wi] is None:
                parts[wi] = (found, vals)
            else:
                parts[wi][0][:] |= found
                np.copyto(parts[wi][1], vals, where=found[:, None])
    return parts


def _upload_probe(part, device):
    """One scan window's pass-1 accumulators as the (found, cov, fw,
    bw) of a probe on `device`."""
    found, vals = part
    vals = widen_u32(torch.from_numpy(vals.view(np.int32)).to(device))
    return (torch.from_numpy(found).to(device), vals[:, 0], vals[:, 1:5],
            vals[:, 5:9])


def _device_search(dbg) -> bool:
    """Whether the variant search runs on the card: the table is on
    CUDA in the device form.  On the CPU and against a host-resident
    table (out of core) the host search runs (_search_from_scan)."""
    table = dbg.table
    return table.device.type == "cuda" and table.window_ranges() is None


def _window_scan(table, codes, lo: int, hi: int, wa: int, wb: int, k: int,
                 cutoff: int, probed=None):
    """The device half of one scan window (see _scan_window_variants):
    (keys, isfw, covs, fws, bws) of buffer positions [lo, hi) and the
    branch points among the core positions [wa, wb), buffer-relative,
    all on the table's device."""
    nbase = hi - lo + k - 1  # codes feeding positions [lo, hi)
    cbuf = torch.from_numpy(codes[lo:lo + nbase]).to(table.device)
    keys, isfw, valid = _extract_sentinel(cbuf, k)
    found, covs, fws, bws = (probed if probed is not None
                             else table.probe_device(keys))
    search = _candidate_scan(keys, isfw, found & valid, covs, fws, bws,
                             cutoff, k)[2]
    search[:wa - lo] = False  # core positions only
    search[wb - lo:] = False
    return keys, isfw, covs, fws, bws, torch.nonzero(search).squeeze(1)


def _scan_window_variants(dbg, codes, lo: int, hi: int, wa: int, wb: int,
                          kcount: int, k: int, max_span: int, cutoff: int,
                          cache, variants, probed=None,
                          on_card: bool = False) -> None:
    """One fixed window [wa, wb) of the variants scan, probing buffer
    positions [lo, hi) (core + halos).

    On the device: extraction + sentinels, the batched probe and the
    depth-0 candidate scan (the quirk semantics of search_variants'
    first iteration: direction = isFw; fw side ignores the cutoff, bw
    side applies it; the reference-edge neighbour is excluded).
    Positions with no candidates are exactly those whose search
    extracts the source, explores nothing, and stops explored=True
    with no paths.  The buffer holds exactly the bases of [lo, hi): no
    padding.  `on_card` (_device_search): the search runs on the card
    from the scan's tensors; else one bulk copy to the host of the
    window's keys and orientations and of the core branch points'
    counters feeds the host search.  `probed`: the window's probe
    result from pass 1 against a host-resident table
    (_probe_windows_inverted); else the table is probed here."""
    from ..utils import log

    with log.span("kq.variants.scan"):
        keys, isfw, covs, fws, bws, rows = _window_scan(
            dbg.table, codes, lo, hi, wa, wb, k, cutoff, probed)
        if not on_card:
            recs = tuple(a[rows].cpu().numpy() for a in (fws, bws, covs))
            all_keys = keys_to_u64(keys.cpu().numpy())
            all_isfw = isfw.cpu().numpy()
            rows = rows.cpu().numpy()
    log.count("variants.positions", wb - wa)
    log.count("variants.branch_points", int(rows.shape[0]))
    log.count("variants.device_searches", int(rows.shape[0]) * on_card)
    with log.span("kq.variants.search"):
        if on_card:
            lookups, hits, paths = _search_on_card(
                dbg, lo, kcount, k, max_span, cutoff, variants, keys, isfw,
                fws, bws, rows)
        else:
            lookups, hits, paths = _search_from_scan(
                dbg, lo, kcount, k, max_span, cache, variants, all_keys,
                all_isfw, rows, recs)
    log.count("variants.lookups", lookups)
    log.count("variants.cache_hits", hits)
    log.count("variants.paths", paths)


_PATH_TYPES = (SNV, INS, DEL, COM)  # the kernel's type numbers
_BASES = bytes.maketrans(bytes(range(4)), b"ACGT")
_CODES = bytes.maketrans(b"ACGT", bytes(range(4)))


class PathGroups:
    """A segment's variants as packed path records, as the
    variant_search kernel gives them (the host search packs its paths
    alike), read (iterated, counted, tested for truth) as the
    reference's list: one list of DBGpath a branch point with paths, in
    position order.  The records stay arrays; a group's DBGpath objects
    are made as it is read, so the tens of thousands of records of a
    job never live on as Python objects, which would reach the garbage
    collector's oldest generation and cost a full collection every
    other job."""

    def __init__(self) -> None:
        # a window's (pos, type, ref_len, bases, offset) columns as
        # lists in position order, its bases, its groups' first records
        self._parts: List[tuple] = []
        self._groups = 0

    def add(self, recs: np.ndarray, bases: np.ndarray) -> None:
        """One window's records, after every earlier window's: int64
        [n, 5] rows of (pos, type, ref_len, bases, offset into `bases`),
        a branch point's rows together and in destination order, the
        branch points in any order; bases uint8 codes 0-3."""
        if not recs.shape[0]:
            return
        recs = recs[np.argsort(recs[:, 0], kind="stable")]
        pos = recs[:, 0]
        firsts = np.flatnonzero(np.r_[True, pos[1:] != pos[:-1]])
        self._parts.append((
            *(recs[:, i].tolist() for i in range(5)),
            bases.tobytes().translate(_BASES).decode(),
            [*firsts.tolist(), recs.shape[0]]))
        self._groups += firsts.size

    def __len__(self) -> int:
        return self._groups

    def __iter__(self):
        for pos, typ, ref_len, nb, off, seq, firsts in self._parts:
            for a, b in zip(firsts, firsts[1:]):
                yield [DBGpath(_PATH_TYPES[typ[r]], pos[r],
                               seq[off[r]:off[r] + nb[r]], ref_len[r])
                       for r in range(a, b)]


def _search_on_card(dbg, lo: int, kcount: int, k: int, max_span: int,
                    cutoff: int, variants, keys, isfw, fws, bws,
                    rows) -> List[int]:
    """Device tail of one variants window: one variant_search launch
    over the branch points `rows` (relative to lo) of the scan's keys,
    orientations and probe, against the device-form table; the path
    records come back and join `variants`, a PathGroups.
    Returns [table lookups, cache hits, records found]."""
    from ..ops.kernels import variant_search_cuda

    stats = [0, 0, 0]
    if rows.shape[0]:
        table = dbg.table
        recs, bases, counts = variant_search_cuda(
            table.keys, table.fw, table.bw, keys, isfw, fws, bws, rows, lo,
            kcount, k, max_span, cutoff, dbg.ui.resolved_kmer_depth(),
            table.bucket_index())
        stats[:2] = counts.sum(0).tolist()
        variants.add(recs.cpu().numpy(), bases.cpu().numpy())
        stats[2] = int(recs.shape[0])
    return stats


def _search_from_scan(dbg, lo: int, kcount: int, k: int, max_span: int,
                      cache, variants, all_keys, all_isfw, search_rel,
                      recs) -> List[int]:
    """Host tail of one variants window: reconstruct the reference's
    sliding targets state and run the exact Fibonacci-heap search on
    the branch points the device scan selected.  all_keys: u64 keys of
    buffer positions [lo, hi); search_rel: the branch points, relative
    to lo; recs: (fw, bw, cov) of each branch point's table row.  The
    paths join `variants`, a PathGroups, packed as the kernel packs
    them.  Returns [table lookups, cache hits, records found]."""
    stats = [0, 0, 0]
    nloc = all_keys.shape[0]           # buffer-relative; abs = rel + lo

    # Only positions that are found AND have a non-reference candidate
    # run the host search.  The reference's targets_queue/targets_map
    # sliding state is reconstructed statelessly per search position
    # (byte-exact, incl. the quirk that popping the front erases a key
    # from the map even when a duplicate occurrence is still queued):
    # a key is in the map iff its latest append event is not older than
    # its latest pop event.  `ok` is always 1 (check_next never fails,
    # so edge_count == explored_count every iteration), so one pass
    # visits everything — no re-scan loop is needed.

    # last-occurrence index (ABSOLUTE positions), restricted to keys
    # that can actually be queried (those inside some search position's
    # target window): one sorted-membership pass over the buffer beats
    # a full stable argsort of all P keys
    # a target window can be empty: a segment's last k + 1 positions have
    # none, and a window whose branch points all lie there queries no
    # key (the JAX package indexes the empty key set there and raises)
    occ_of: Dict[int, np.ndarray] = {}
    offs = np.arange(1, max_span + 1)
    wpos = (search_rel[:, None] + k + offs[None, :]).ravel()
    wpos = wpos[wpos < min(nloc, kcount - lo)]
    if wpos.size:
        wvals = np.unique(all_keys[wpos])
        wi = np.minimum(np.searchsorted(wvals, all_keys), wvals.size - 1)
        occ_pos = np.nonzero(wvals[wi] == all_keys)[0]  # ascending
        occ_grp = np.argsort(wi[occ_pos], kind="stable")
        bounds = np.searchsorted(wi[occ_pos][occ_grp],
                                 np.arange(wvals.size + 1))
        for j, key in enumerate(wvals):
            occ_of[int(key)] = \
                occ_pos[occ_grp[bounds[j]:bounds[j + 1]]] + lo

    def last_occurrence_le(key, limit: int):
        """Largest abs position p <= limit with key at p, or None
        (positions before the buffer are invisible — see the halo
        argument in dbg_to_variants)."""
        occ = occ_of.get(int(key))
        if occ is None or occ.size == 0:
            return None
        j = int(np.searchsorted(occ, limit, side="right")) - 1
        return int(occ[j]) if j >= 0 else None

    def targets_state(c: int):
        """Queue + map exactly as after iteration c's maintenance."""
        w_lo, w_hi = c + k + 1, min(c + k + max_span + 1, kcount)
        queue = [int(all_keys[p - lo]) for p in range(w_lo, w_hi)]
        tmap: Dict[int, bool] = {}
        for p in range(w_lo, w_hi):
            key = int(all_keys[p - lo])
            if key in tmap:
                continue
            a = last_occurrence_le(np.uint64(key), w_hi - 1)  # == some p
            o = last_occurrence_le(np.uint64(key), c + k)
            a_time = max(a - k - max_span, -1)
            if o is None or a_time >= o - k:
                tmap[key] = True
        return queue, tmap

    fws, bws, covs = recs
    packed: List[tuple] = []  # (pos, type, ref_len, bases, offset)
    seqs: List[str] = []
    nbases = 0
    for j, c_rel in enumerate(search_rel):
        c = int(c_rel) + lo
        skey = int(all_keys[c_rel])
        is_fw = bool(all_isfw[c_rel])
        rec = (fws[j].astype(np.uint32), bws[j].astype(np.uint32),
               int(covs[j]))
        ref_key = int(all_keys[c_rel + 1]) if c + 1 <= kcount - 1 \
            else None
        targets_queue, targets_map = targets_state(c)
        ok, paths = search_variants(
            dbg, skey, rec, is_fw, ref_key, targets_queue,
            targets_map, cache, stats)
        assert ok, "searchVariants cannot end unexplored (see docstring)"
        for p in paths:
            packed.append((c + k, _PATH_TYPES.index(p.type), p.ref_len,
                           len(p.sequence), nbases))
            seqs.append(p.sequence)
            nbases += len(p.sequence)
        stats[2] += len(paths)
    variants.add(np.array(packed, np.int64).reshape(-1, 5),
                 np.frombuffer("".join(seqs).encode().translate(_CODES),
                               np.uint8))
    return stats


def search_variants(dbg, source_key: int, source_rec, is_source_fw: bool,
                    ref: Optional[int], targets_queue: List[int],
                    targets_map: Dict[int, bool],
                    cache: Dict[int, object],
                    stats: List[int]) -> Tuple[bool, List[DBGpath]]:
    """Reference: src/variants.cpp:171-310.  Keys are u64 Python ints.
    Adds the table lookups and cache hits to stats[0] and stats[1]."""
    k = dbg.k
    table = dbg.table
    cutoff = dbg.ui.cov_cutoff
    kmer_depth = dbg.ui.resolved_kmer_depth()

    heap = FibonacciHeap()
    dist: Dict[int, int] = {source_key: 1}
    prev: Dict[int, Tuple[int, bool]] = {}
    vals: Dict[int, object] = {source_key: source_rec}
    destinations: List[int] = []
    discovered: List[DBGpath] = []
    heap.insert(source_key, 1)
    depth = 0
    direction = True
    explored = False

    def check_next(key: int, dirn: bool, ukey: int) -> bool:
        if key in targets_map:
            return True
        nxt = cache.get(key)
        if nxt is None:
            stats[0] += 1
            nxt = table.lookup(key)
            if nxt is None:
                return True  # edge recorded but neighbour absent
            cache[key] = nxt
        else:
            stats[1] += 1
        alt = dist[ukey]
        if alt < 255:
            alt += 1
        if key not in dist:
            dist[key] = 255
            vals[key] = nxt
            heap.insert(key, 0)
        if alt < dist[key]:
            prev[key] = (ukey, dirn)
            dist[key] = alt
            heap.decrease_key(key, alt)
        return True

    while heap.size() > 0 and depth < kmer_depth + 1:
        explored = False
        ukey = heap.extract_min()
        ufw, ubw, _ucov = vals[ukey]
        if ukey in prev:
            direction = prev[ukey][1]
        edge_count = 0
        explored_count = 0
        candidates: List[Tuple[int, bool, bool]] = []
        for i in range(4):
            if depth == 0:
                direction = bool(is_source_fw)
            # quirk: `direction ? fw[i] : bw[i] > covCutOff` applies
            # the cutoff only to the bw side (src/variants.cpp:236)
            cond = bool(ufw[i]) if direction else (ubw[i] > cutoff)
            if cond:
                raw = (next_key_fw(ukey, i, k) if direction
                       else next_key_bw(ukey, i, k))
                key, isfw = canonical(raw, k)
                if key != ref:
                    candidates.append((key, isfw, direction))
                    edge_count += 1
        for key, isfw, dirn in candidates:
            found = check_next(key, dirn if isfw else not dirn, ukey)
            if found:
                explored_count += 1
                if key in targets_map:
                    prev[key] = (ukey, dirn)
                    destinations.append(key)
        depth += 1
        if (edge_count == explored_count or depth == kmer_depth + 1
                or len(destinations) >= 10):
            explored = True

    def prev_get(key: int) -> Tuple[int, bool]:
        return prev.get(key, (0, False))

    for destination in destinations:
        path = DBGpath()
        try:
            ref_len = targets_queue.index(destination) + k
        except ValueError:
            ref_len = len(targets_queue) + k
        i = 0
        node = prev_get(destination)[0]
        while node != source_key:
            node = prev_get(node)[0]
            i += 1
        node = prev_get(destination)[0]
        direction = prev_get(node)[1]
        b = i - ref_len
        if ref_len > k:
            path.type = COM
            path.ref_len = ref_len - k + 1
            b = ref_len - k
        elif i == ref_len:
            path.type = SNV
        elif i > ref_len:
            path.type = DEL
            b -= 1
            node = prev_get(node)[0]
            direction = prev_get(node)[1]
        else:
            path.type = INS
        seq = []
        while b >= 0:
            seq.append(key_to_seq(node, k)[0] if direction
                       else revcom(key_to_seq(node, k)[k - 1]))
            node = prev_get(node)[0]
            direction = prev_get(node)[1]
            b -= 1
        path.sequence = "".join(reversed(seq))
        discovered.append(path)

    if explored:
        for key in dist:
            cache.pop(key, None)
    return explored, discovered

"""DBG workloads: QV validation, per-base tracks, the DB summary.

Counterpart of kreeq_tpu/core/dbg.py (reference: src/kreeq.cpp:47-108,
src/graph-builder.cpp:284-295).  Each assembly segment is validated in
fixed windows of positions.  Against a device-resident table, plain
`validate` keeps only the two QV totals on the device; the track
writers also get cov, isfw and the two edge counters of every base,
copied to the host window by window.  A host-resident table (out of
core, KmerTable.window_ranges) is validated with its windows as the
outer loop (`_validate_windowed`), for the totals and the tracks
alike.
"""

from __future__ import annotations

import math
import sys
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import UserInput
from ..constants import BAD
from ..io.sequence import Genome
from ..utils import log
from ..utils.fmt import cpp_double
from .table import KmerTable, u32_bits, widen_u32

# windows whose track copies may be in flight before the host waits for
# the oldest: the card computes the next windows meanwhile
_TRACK_LAG = 2


def error_rate(missing: int, total: int, k: int) -> float:
    """Reference: src/kreeq.cpp:36-40."""
    if total == 0:
        return float("nan")
    return 1 - (1 - missing / total) ** (1 / k)


@dataclass
class SegmentTrack:
    """Per-base validation track of one segment (DBGbase equivalent,
    reference: include/input.h:4-9)."""

    cov: np.ndarray  # u32 [len]
    isfw: np.ndarray  # bool [len]
    right: np.ndarray  # u32 [len]  (edge toward higher coordinates)
    left: np.ndarray  # u32 [len]

    @classmethod
    def zeros(cls, ln: int) -> "SegmentTrack":
        return cls(np.zeros(ln, np.uint32), np.zeros(ln, bool),
                   np.zeros(ln, np.uint32), np.zeros(ln, np.uint32))


def _start_readback(track: SegmentTrack, a: int, b: int, cov, isfw,
                    right, left):
    """Start copying one window's track values, positions [a, b) of
    `track`, to the host, and return the function that waits for the
    copy and stores them.  On the card the copy runs behind the
    window's kernels while the host goes on to the next window."""
    vals = torch.stack([u32_bits(cov), u32_bits(right),
                        u32_bits(left)]).to("cpu", non_blocking=True)
    fw = isfw.to("cpu", non_blocking=True)
    done = None
    if cov.device.type == "cuda":
        done = torch.cuda.Event()
        done.record()

    def finish():
        if done is not None:
            done.synchronize()
        u = vals.numpy().view(np.uint32)
        track.cov[a:b] = u[0]
        track.right[a:b] = u[1]
        track.left[a:b] = u[2]
        track.isfw[a:b] = fw.numpy()

    return finish


class DBG:
    """The k-mer DB plus workloads against a loaded genome."""

    # positions per validate window: one window's buffer and query arrays
    # stay bounded on the device for chromosome-scale segments
    VALIDATE_WINDOW = 1 << 22

    def __init__(self, user_input: UserInput, table: KmerTable) -> None:
        self.ui = user_input
        self.table = table
        self.genome: Optional[Genome] = None
        self.tracks: List[SegmentTrack] = []
        self.tot_missing = 0
        self.tot_kcount = 0
        self.tot_edge_missing = 0

    @property
    def k(self) -> int:
        return self.table.k

    # -- summary -----------------------------------------------------------

    def db_stats_lines(self) -> List[str]:
        """Reference: src/graph-builder.cpp:284-295 (DBstats)."""
        st = self.table.stats()
        return [
            "DBG Summary statistics:",
            f"Total kmers: {st.total}",
            f"Unique kmers: {st.unique}",
            f"Distinct kmers: {st.distinct}",
            f"Missing kmers: {st.missing(self.k)}",
            f"Total edges: {st.edges}",
        ]

    def print_db_stats(self, out=None) -> None:
        out = out or sys.stdout
        out.write("\n".join(self.db_stats_lines()) + "\n")

    # -- validation (QV) ---------------------------------------------------

    def load_genome(self, genome: Genome) -> None:
        self.genome = genome

    def validate_sequences(self, out=None, need_tracks: bool = True) -> None:
        """QV computation + per-base tracks (reference:
        src/kreeq.cpp:47-108).

        need_tracks=False is the sums-only path for plain `validate`:
        the reference always fills its per-base tracks, but they feed
        only the QV totals unless a bed/csv/kwig/bkwig writer runs
        (src/kreeq-output.cpp:62-83).  The QV table is the same either
        way.  A host-resident table is probed first, window by window
        (`_probe_windowed`), then classified from what that gathered."""
        from ..ops.validate import validate_positions, validate_qv_sums

        out = out or sys.stdout
        if not self.ui.in_sequence:
            return
        k = self.k
        cutoff = self.ui.cov_cutoff
        device = self.table.device
        ranges = self.table.window_ranges()
        if ranges is None:
            tab = (self.table.keys, self.table.cov, self.table.fw,
                   self.table.bw)
            # the CUDA probes' bucket directory; the CPU's plain probes
            # need none
            index = (self.table.bucket_index() if device.type == "cuda"
                     else None)

            def sums(_si, _a, buf, lead, hi):
                return validate_qv_sums(*tab, buf, k, cutoff, lead, hi,
                                        index)

            def classify(_si, _a, buf, _lead, _hi):
                return validate_positions(*tab, buf, k, cutoff, index)
        else:
            accs = self._probe_windowed(ranges)
            sums = None  # a missing k-mer is known only from every window

            def classify(si, a, buf, lead, hi):
                return self._classify_acc(accs[si], a, buf, lead, hi)

        # int64 totals on the device: genome-scale counts pass 2^31
        acc = torch.zeros(2, dtype=torch.int64, device=device)
        self.tracks = []
        self.tot_kcount = 0
        pending = deque()  # track copies in flight, oldest first
        for si, seg in enumerate(self.genome.segments):
            ln = len(seg)
            if ln < k:
                if need_tracks:
                    self.tracks.append(SegmentTrack.zeros(ln))
                continue
            codes = seg.codes
            kcount = ln - k + 1
            track = SegmentTrack.zeros(ln) if need_tracks else None
            for a, b, lead, buf in self._seq_windows(codes, kcount):
                buf = torch.from_numpy(buf).to(device)
                hi = lead + (b - a)
                if not need_tracks and sums is not None:
                    acc += sums(si, a, buf, lead, hi)
                    continue
                (_valid, missing, edge_missing, cov, isfw, right,
                 left) = (x[lead:hi] for x in classify(si, a, buf, lead,
                                                       hi))
                acc += torch.stack([missing.sum(), edge_missing.sum()])
                if need_tracks:
                    pending.append(_start_readback(track, a, b, cov, isfw,
                                                   right, left))
                    while len(pending) > _TRACK_LAG:
                        pending.popleft()()
            self.tot_kcount += kcount
            if need_tracks:
                self.tracks.append(track)
        while pending:
            pending.popleft()()
        self.tot_missing, self.tot_edge_missing = (int(x) for x in
                                                   acc.tolist())
        self._print_qv(out, k)

    def _probe_windowed(self, ranges):
        """Probe every position against a host-resident table
        (counterpart of the JAX _validate_windowed, reference analog:
        the map-range rescans of src/kreeq.cpp:59-76).  Table windows
        are the outer loop, so each window uploads once per run.  Per
        (table window, sequence window), probe_select_cuda with the
        window's directory gives each position's found flag, cov and
        ctx-selected right and left counters; the hits fold into host
        accumulators of 13 B a position (the windows are disjoint, so
        at most one finds a key).  Returns {segment index: (found bool,
        cov, right, left u32)} over each segment's k-mer positions.
        probe_qv cannot serve here: a k-mer is missing only once every
        window has missed it."""
        from ..ops.kernels import extract_cuda, probe_select_cuda

        k = self.k
        table = self.table
        dev = table.device
        accs = {si: (np.zeros(len(seg) - k + 1, bool),
                     *(np.zeros(len(seg) - k + 1, np.uint32)
                       for _ in range(3)))
                for si, seg in enumerate(self.genome.segments)
                if len(seg) >= k}
        for w in range(len(ranges)):
            for si, (af, ac, ar, al) in accs.items():
                codes = self.genome.segments[si].codes
                for a, b, lead, buf in self._seq_windows(codes, af.size):
                    keys, _isfw, _valid, ctx = extract_cuda(
                        torch.from_numpy(buf).to(dev), k, "track")
                    tab = table.device_arrays(w)
                    index = table.window_index(w)
                    sel = probe_select_cuda(*tab, keys, ctx, index)
                    log.count("ooc.probe_select")
                    log.count("ooc.queries", keys.shape[0])
                    del tab, index  # the next window uploads into room
                    sl = slice(lead, lead + (b - a))
                    found = sel[0][sl].cpu().numpy()
                    vals = torch.stack([u32_bits(x[sl]) for x in sel[1:]])
                    vals = vals.cpu().numpy().view(np.uint32)
                    af[a:b] |= found
                    for dst, src in zip((ac, ar, al), vals):
                        np.copyto(dst[a:b], src, where=found)
        return accs

    def _classify_acc(self, sel_host, a: int, buf, lead: int, hi: int):
        """Classify one sequence window from the accumulated selection
        (the JAX _classify_acc): the window's positions [a, a + hi -
        lead) of the segment's accumulators go to the device at buffer
        positions [lead, hi), then _classify_sel."""
        from ..ops.kernels import extract_cuda
        from ..ops.validate import _classify_sel

        dev = buf.device
        _keys, isfw, valid, _ctx = extract_cuda(buf, self.k, "track")
        b = a + hi - lead
        found = np.zeros(valid.shape[0], bool)
        found[lead:hi] = sel_host[0][a:b]
        vals = np.zeros((3, valid.shape[0]), np.uint32)
        for row, x in zip(vals, sel_host[1:]):
            row[lead:hi] = x[a:b]
        vals = widen_u32(torch.from_numpy(vals.view(np.int32)).to(dev))
        return _classify_sel(buf, (torch.from_numpy(found).to(dev), *vals),
                             self.k, self.ui.cov_cutoff, isfw, valid)

    def _window_buf(self, codes, a: int, b: int, kcount: int):
        """One validate-window buffer for positions [a, b): the window's
        bases plus one base of context on each side (BAD at a segment
        end), which keeps the edge tests exact at window seams."""
        k = self.k
        buf = np.full(b - a + k + 1, BAD, np.uint8)
        if a > 0:
            buf[0] = codes[a - 1]
        buf[1:1 + (b - a) + k - 1] = codes[a:b + k - 1]
        if b < kcount:
            buf[(b - a) + k] = codes[b + k - 1]
        return buf

    def _seq_windows(self, codes, kcount: int):
        """(a, b, lead, buf) per fixed validate window of one segment;
        position i of the window is buffer position lead + i."""
        win = self.VALIDATE_WINDOW
        for a in range(0, kcount, win):
            b = min(a + win, kcount)
            yield a, b, 1, self._window_buf(codes, a, b, kcount)

    def _print_qv(self, out, k: int) -> None:
        if "." in self.ui.out_file or self.ui.out_file == "":
            def qv(err: float) -> float:
                if math.isnan(err):
                    return float("nan")
                return -10 * math.log10(err) if err > 0 else float("inf")

            out.write("Missing\tTotal\tQV\tError\tk\tMethod\n")
            merr = error_rate(self.tot_missing, self.tot_kcount, k)
            out.write(f"{self.tot_missing}\t{self.tot_kcount}\t"
                      f"{cpp_double(qv(merr))}\t{cpp_double(merr)}\t{k}\t"
                      f"Merqury\n")
            kerr = error_rate(self.tot_missing + self.tot_edge_missing,
                              self.tot_kcount, k)
            out.write(f"{self.tot_missing + self.tot_edge_missing}\t"
                      f"{self.tot_kcount}\t{cpp_double(qv(kerr))}\t"
                      f"{cpp_double(kerr)}\t{k}\tKreeq\n")

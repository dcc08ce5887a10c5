"""DBG workload driver: QV validation and the DB summary.

Counterpart of the sums-only path of kreeq_tpu/core/dbg.py (reference:
src/kreeq.cpp:47-108, src/graph-builder.cpp:284-295).  The table is
device-resident; each assembly segment is validated in fixed windows
of positions, and only the two QV totals leave the device.

Not yet ported: per-base tracks and out-of-core table windows.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import UserInput
from ..constants import BAD
from ..io.sequence import Genome
from ..utils.fmt import cpp_double
from .table import KmerTable


def error_rate(missing: int, total: int, k: int) -> float:
    """Reference: src/kreeq.cpp:36-40."""
    if total == 0:
        return float("nan")
    return 1 - (1 - missing / total) ** (1 / k)


class DBG:
    """The k-mer DB plus workloads against a loaded genome."""

    # positions per validate window: one window's buffer and query arrays
    # stay bounded on the device for chromosome-scale segments
    VALIDATE_WINDOW = 1 << 22

    def __init__(self, user_input: UserInput, table: KmerTable) -> None:
        self.ui = user_input
        self.table = table
        self.genome: Optional[Genome] = None
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

    def validate_sequences(self, out=None) -> None:
        """QV computation (reference: src/kreeq.cpp:47-108), sums only:
        plain `validate` consumes only the QV totals (the reference's
        per-base tracks feed the bed/csv/kwig/bkwig writers,
        src/kreeq-output.cpp:62-83, which are not yet ported)."""
        from ..ops.validate import validate_qv_sums

        out = out or sys.stdout
        if not self.ui.in_sequence:
            return
        k = self.k
        device = self.table.device
        tab = (self.table.keys, self.table.cov, self.table.fw, self.table.bw)
        # int64 totals on the device: genome-scale counts pass 2^31
        acc = torch.zeros(2, dtype=torch.int64, device=device)
        self.tot_kcount = 0
        for seg in self.genome.segments:
            ln = len(seg)
            if ln < k:
                continue
            codes = seg.codes
            kcount = ln - k + 1
            for a, b, lead, buf in self._seq_windows(codes, kcount):
                acc += validate_qv_sums(
                    *tab, torch.from_numpy(buf).to(device), k,
                    self.ui.cov_cutoff, lead, lead + (b - a))
            self.tot_kcount += kcount
        self.tot_missing, self.tot_edge_missing = (int(x) for x in
                                                   acc.tolist())
        self._print_qv(out, k)

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

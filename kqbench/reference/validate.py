"""An assembly scored against a k-mer table, and the outputs kreeq
prints and writes for it, in plain NumPy.

The semantics are kreeq's `validate` (github.com/vgl-hub/kreeq,
src/kreeq.cpp evaluateSegment, src/kreeq-output.cpp): each FASTA record
is a path, split at runs of N into segments and gaps; every k-mer
window of a segment is looked up by its canonical key.  A window is
missing when its key is absent, it holds a non-base, or its coverage is
below max(cutoff, 1); it is edge-missing when it is not missing, has a
base on both sides, and the table's edge counters toward both
neighbours are zero.  The per-base tracks of `.bkwig` hold, for the
window starting at each base, its coverage and the edge counters toward
the next and the previous base (zero where the window is missing or
that neighbour is absent), and zero past the last window.
"""

from __future__ import annotations

import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List

import numpy as np

from .kmers import CTOI, Table, windows

_N_RUN = re.compile(rb"[Nn]+")


@dataclass
class Path:
    name: str
    # (absolute position, bytes) per segment, in order
    segments: list = field(default_factory=list)


def paths_of(records) -> List[Path]:
    """Paths of FASTA records given as (name, sequence bytes)."""
    out = []
    for name, seq in records:
        path = Path(name)
        i = 0
        for m in _N_RUN.finditer(seq):
            if m.start() > i:
                path.segments.append((i, seq[i:m.start()]))
            i = m.end()
        if i < len(seq):
            path.segments.append((i, seq[i:]))
        out.append(path)
    return out


@dataclass
class Score:
    missing: int = 0
    edge_missing: int = 0
    kcount: int = 0
    # per segment, in path order: uint32 [len, 3] of cov, right, left
    tracks: list = field(default_factory=list)
    # distinct table rows that some window found
    rows_found: int = 0


def _select(fw, bw, isfw, base, forward: bool):
    """The counter toward a neighbour base in the key's orientation: the
    next base is fw[b] on a forward key and bw[3 - b] on a reverse one;
    the previous base is bw[b] and fw[3 - b]."""
    b = (base & 3).astype(np.int64)
    a, c = (fw, bw) if forward else (bw, fw)
    idx = np.arange(len(b))
    return np.where(isfw, a[idx, b], c[idx, 3 - b])


def _segment(table: Table, seq: bytes, cutoff: int, tracks: bool):
    """(missing, edge-missing, windows, track or None, rows found) of
    one segment."""
    k = table.k
    ln = len(seq)
    trk = np.zeros((ln, 3), np.uint32) if tracks else None
    t = len(table.keys)
    if ln < k:
        return 0, 0, 0, trk, np.zeros(0, np.int64)
    w = windows(CTOI[np.frombuffer(seq, np.uint8)], k)
    p = len(w.key)
    if t == 0:
        return p, 0, p, trk, np.zeros(0, np.int64)
    row = np.minimum(np.searchsorted(table.keys, w.key), t - 1)
    found = (table.keys[row] == w.key) & w.valid
    cov = np.where(found, table.cov[row], 0)
    ok = found & (cov >= max(cutoff, 1))
    has_n, has_p = w.next <= 3, w.prev <= 3
    fw, bw = table.fw[row], table.bw[row]
    right = np.where(ok & has_n, _select(fw, bw, w.isfw, w.next, True), 0)
    left = np.where(ok & has_p, _select(fw, bw, w.isfw, w.prev, False), 0)
    edge = ok & has_n & (right == 0) & has_p & (left == 0)
    if tracks:
        trk[:p, 0] = cov
        trk[:p, 1] = right
        trk[:p, 2] = left
    return int(p - ok.sum()), int(edge.sum()), p, trk, row[found]


def score(table: Table, records, cutoff: int = 0, tracks: bool = False,
          threads=None) -> Score:
    """QV counts (and, with `tracks`, the per-base tracks) of the
    assembly `records` against `table`, a segment a thread."""
    segs = [seq for path in paths_of(records) for _pos, seq in path.segments]
    with ThreadPoolExecutor(threads or os.cpu_count() or 1) as pool:
        res = list(pool.map(lambda s: _segment(table, s, cutoff, tracks),
                            segs))
    out = Score()
    for missing, edge, p, trk, _rows in res:
        out.missing += missing
        out.edge_missing += edge
        out.kcount += p
        if tracks:
            out.tracks.append(trk)
    rows = [r for *_x, r in res if len(r)]
    if rows:
        out.rows_found = len(np.unique(np.concatenate(rows)))
    return out


def _g(x: float) -> str:
    """A double as C++'s default ostream prints it."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return f"{x:g}"


def _qv_row(missing: int, total: int, k: int, method: str) -> str:
    if total == 0:
        err = float("nan")
    else:
        err = 1 - (1 - missing / total) ** (1 / k)
    if math.isnan(err):
        qv = float("nan")
    else:
        qv = -10 * math.log10(err) if err > 0 else float("inf")
    return f"{missing}\t{total}\t{_g(qv)}\t{_g(err)}\t{k}\t{method}\n"


def summary_text(table: Table) -> str:
    """kreeq's DBG summary (src/graph-builder.cpp DBstats).  Total edges
    counts an edge slot once where either its fw or its bw counter is
    above zero."""
    k = table.k
    edges = int(((table.fw > 0) | (table.bw > 0)).sum())
    return ("DBG Summary statistics:\n"
            f"Total kmers: {int(table.cov.sum())}\n"
            f"Unique kmers: {int((table.cov == 1).sum())}\n"
            f"Distinct kmers: {len(table.keys)}\n"
            f"Missing kmers: {4 ** k - len(table.keys)}\n"
            f"Total edges: {edges}\n")


def qv_text(sc: Score, k: int) -> str:
    return ("Missing\tTotal\tQV\tError\tk\tMethod\n"
            + _qv_row(sc.missing, sc.kcount, k, "Merqury")
            + _qv_row(sc.missing + sc.edge_missing, sc.kcount, k, "Kreeq"))

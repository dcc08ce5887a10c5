"""Genome / assembly-graph model (gfalibs `InSequences` equivalent).

Sequences are decomposed at runs of N into segments and gaps that form
paths, mirroring the reference's threaded N-split (reference:
src/input.cpp:229-235 appendSequence; component layout validated against
the index embedded in testFiles/decompressor1.bkwig: sequence3 of len 99
with NNN at [46,49) -> components (absPos 0, len 46), (absPos 49, len 50)).

Unlike the reference (pointer-heavy C++ objects), segments here carry
their raw strings for output fidelity plus lazily-computed uint8 code
arrays for the device kernels.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..constants import seq_to_codes

_N_RUN = re.compile("[Nn]+")

SEGMENT = "S"
GAP = "G"


@dataclass
class Segment:
    uid: int
    header: str
    seq: str
    seq_pos: int = 0
    comment: str = ""
    tags: list = field(default_factory=list)
    # populated by workloads
    # read as list[list[DBGpath]]; core.variants.dbg_to_variants sets a
    # PathGroups
    variants: list = field(default_factory=list)
    _codes: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.seq)

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = seq_to_codes(self.seq)
        return self._codes


@dataclass
class Gap(object):
    uid: int
    dist: int
    header: str = ""


@dataclass
class PathComponent:
    ctype: str  # SEGMENT or GAP
    id: int  # uid of the segment/gap
    orientation: str = "+"


@dataclass
class Path:
    header: str
    components: List[PathComponent] = field(default_factory=list)
    seq_pos: int = 0
    comment: str = ""


@dataclass
class Edge:
    """GFA link/edge (gfalibs InEdge equivalent)."""

    uid: int
    eid: int
    sid1: int
    sid2: int
    or1: str
    or2: str
    cigar: str = "0M"
    header: str = ""
    tags: list = field(default_factory=list)


class Genome:
    """Container for segments/gaps/paths/edges (InSequences equivalent)."""

    def __init__(self) -> None:
        self.segments: List[Segment] = []
        self.gaps: List[Gap] = []
        self.paths: List[Path] = []
        self.edges: List[Edge] = []
        self._uid = 0
        self._seg_by_uid: Dict[int, Segment] = {}
        self._gap_by_uid: Dict[int, Gap] = {}
        self._seg_by_header: Dict[str, Segment] = {}

    # -- construction ------------------------------------------------------

    def next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def add_segment(self, header: str, seq: str, seq_pos: int = 0,
                    comment: str = "", tags: Optional[list] = None) -> Segment:
        seg = Segment(self.next_uid(), header, seq, seq_pos, comment,
                      tags or [])
        self.segments.append(seg)
        self._seg_by_uid[seg.uid] = seg
        self._seg_by_header[seg.header] = seg
        return seg

    def add_gap(self, dist: int, header: str = "") -> Gap:
        gap = Gap(self.next_uid(), dist, header)
        self.gaps.append(gap)
        self._gap_by_uid[gap.uid] = gap
        return gap

    def add_edge(self, edge: Edge) -> None:
        self.edges.append(edge)

    def append_sequence(self, header: str, comment: str, seq: str,
                        seq_pos: int) -> None:
        """Split a sequence at N-runs into segments and gaps forming a path.

        Reference behavior: appendSequence (gfalibs, called from
        src/input.cpp:235).  Segment naming follows the gfastar
        convention `<header>.<n>` seen in testFiles/random1.gfa
        ("Random1.1" for path "Random1").
        """
        path = Path(header, seq_pos=seq_pos, comment=comment)
        n = len(seq)
        i = 0
        seg_counter = 0
        # C-speed N-run scan (a per-char Python loop costs ~1 s/Mbp)
        for m in _N_RUN.finditer(seq):
            if m.start() > i:
                seg_counter += 1
                seg = self.add_segment(f"{header}.{seg_counter}",
                                       seq[i:m.start()], seq_pos=seq_pos)
                path.components.append(PathComponent(SEGMENT, seg.uid))
            gap = self.add_gap(m.end() - m.start(),
                               f"{header}.gap{len(self.gaps) + 1}")
            path.components.append(PathComponent(GAP, gap.uid))
            i = m.end()
        if i < n:
            seg_counter += 1
            seg = self.add_segment(f"{header}.{seg_counter}", seq[i:],
                                   seq_pos=seq_pos)
            path.components.append(PathComponent(SEGMENT, seg.uid))
        self.paths.append(path)

    # -- lookup ------------------------------------------------------------

    def segment_by_uid(self, uid: int) -> Segment:
        return self._seg_by_uid[uid]

    def gap_by_uid(self, uid: int) -> Gap:
        return self._gap_by_uid[uid]

    def segment_by_header(self, header: str) -> Optional[Segment]:
        return self._seg_by_header.get(header)

    def delete_segment(self, header: str) -> None:
        seg = self._seg_by_header.pop(header, None)
        if seg is not None:
            self.segments.remove(seg)
            self._seg_by_uid.pop(seg.uid, None)

    # -- iteration helpers -------------------------------------------------

    def path_components(self, path: Path):
        """Yield (component, object) pairs for a path."""
        for comp in path.components:
            if comp.ctype == SEGMENT:
                yield comp, self._seg_by_uid[comp.id]
            else:
                yield comp, self._gap_by_uid[comp.id]

    def sort_paths_by_original(self) -> None:
        self.paths.sort(key=lambda p: p.seq_pos)

    def sort_segments_by_original(self) -> None:
        self.segments.sort(key=lambda s: s.seq_pos)

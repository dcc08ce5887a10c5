"""Subgraph extraction, graph search, unitig collapse, GFA emission.

Counterpart of kreeq_tpu/core/subgraph.py (reference: src/subgraph.cpp,
src/kreeq.cpp:360-600).

On the table's device: k-mer extraction of each assembly segment and
one batched probe of its k-mers (ops.kernels.probe_sorted_cuda, through
`KmerTable.probe`); the neighbour scans of the traversal rounds, the
best-first prefilter and the edge pruning (ops/frontier.survivors); the
probe of each traversal round's survivors and of the prefilter's.  The
traversal frontier and its member set stay on the device between
rounds; each round copies only its new nodes to the host.

On the host: the node dicts {u64 key: SubNode}, whose insertion order
fixes the GFA's segment and edge ids, so every pass keeps first-wins in
scan order; the best-first Fibonacci-heap search per boundary source
(scalar `KmerTable.lookup`); the unitig collapse; the graph statistics.
Keys in the dicts are u64 Python ints, the JAX package's form; they
become the port's biased int64 only at the device boundary.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import ITOC, keys_from_u64, keys_to_u64
from ..io.sequence import Edge, Genome
from ..native.subnode import get_module
from ..ops.frontier import survivors
from ..ops.kernels import extract_cuda
from ..utils import log
from .fibheap import FibonacciHeap
from .gfastats import report_stats_lines
from .keys import (canonical, key_to_seq, mask, next_key_bw, next_key_fw,
                   revcomp_key)


class SubNode:
    """DBGkmer32color equivalent (reference: include/kreeq.h:126-136),
    a __slots__ class: the searches create about one per assembly base."""

    __slots__ = ("fw", "bw", "cov", "color")

    def __init__(self, fw=None, bw=None, cov=0, color=0):
        self.fw = [0, 0, 0, 0] if fw is None else fw
        self.bw = [0, 0, 0, 0] if bw is None else bw
        self.cov = cov
        # 0 gray (search-found), 1 blue (DB), 2 red (asm-only)
        self.color = color

    def fw_count(self) -> int:
        return sum(1 for v in self.fw if v)

    def bw_count(self) -> int:
        return sum(1 for v in self.bw if v)


LARGEST = 0xFFFFFFFF


def _bulk_nodes(dst: dict, keys, fw, bw, cov, color: int = 0) -> None:
    """dst.update({keys[i]: SubNode(fw[i], bw[i], cov[i], color)}) in
    index order, through native/subnode_ext.c when it builds.  keys:
    u64 [n]; fw, bw: [n, 4] and cov: [n] counters below 2^32.  A key
    already in dst keeps its position (dict update semantics)."""
    n = len(keys)
    if n == 0:
        return
    ext = get_module()
    if ext is not None:
        keys = np.ascontiguousarray(keys, np.uint64)
        fw = np.ascontiguousarray(fw, np.uint32)
        bw = np.ascontiguousarray(bw, np.uint32)
        cov = np.ascontiguousarray(cov, np.uint32)
        ext.build_nodes(dst, n, keys.ctypes.data, fw.ctypes.data,
                        bw.ctypes.data, cov.ctypes.data, color)
        return
    dst.update(zip(
        np.asarray(keys, np.uint64).tolist(),
        (SubNode(f, b, c, color) for f, b, c in
         zip(np.asarray(fw).tolist(), np.asarray(bw).tolist(),
             np.asarray(cov).tolist()))))


def _satadd(a: int, b: int) -> int:
    s = a + b
    return s if s <= LARGEST else LARGEST


def color_palette(value: int) -> str:
    """Reference: src/kreeq.cpp:337-349."""
    return {0: "gray", 1: "blue", 2: "red"}[value]


def _node_arrays(sub: Dict[int, SubNode], device):
    """The dict's keys (biased int64 [n]) and fw, bw counters (int64
    [n, 4]) on `device`, in insertion order."""
    n = len(sub)
    keys = keys_from_u64(np.fromiter(sub.keys(), np.uint64, n))
    fw = np.array([nd.fw for nd in sub.values()], np.int64).reshape(-1, 4)
    bw = np.array([nd.bw for nd in sub.values()], np.int64).reshape(-1, 4)
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(fw).to(device), torch.from_numpy(bw).to(device))


# -- extraction -------------------------------------------------------------


def extract_subgraph(dbg) -> Dict[int, SubNode]:
    """Collect DB nodes touched by the assembly (color 1) plus
    reconstructed assembly-only nodes (color 2) unless --no-reference
    (reference: src/subgraph.cpp:190-288), merged across segments with
    saturating adds (reference unionSum, src/subgraph.cpp:42-112).
    Per segment: k-mer extraction and one probe on the table's device,
    one copy back."""
    ui = dbg.ui
    k = dbg.k
    table = dbg.table
    bed = _load_bed_spans(dbg) if ui.in_bed_include else None

    merged: Dict[int, SubNode] = {}
    for seg in dbg.genome.segments:
        ln = len(seg)
        if ln < k:
            continue
        kcount = ln - k + 1
        keys, _isfw, edges, valid = extract_cuda(
            torch.from_numpy(seg.codes).to(table.device), k)
        found, cov, fw, bw = table.probe(keys)
        keys = keys_to_u64(keys.cpu().numpy())
        edges = edges.cpu().numpy()
        valid = valid.cpu().numpy()

        spans = [(0, kcount)]
        if bed is not None:
            spans = bed.get(seg.header, [])

        # positions in span scan order; first occurrence of a key wins
        # (phmap insert semantics)
        pos_parts = [np.arange(lo, min(hi, kcount)) for lo, hi in spans]
        pos = (np.concatenate(pos_parts) if pos_parts
               else np.empty(0, np.int64))
        pos = pos[valid[pos]]
        _u, first = np.unique(keys[pos], return_index=True)
        pos = pos[np.sort(first)]
        if ui.no_reference:
            pos = pos[found[pos]]

        # red nodes: edges from the assembly's own bases, cov 1
        red = ~found[pos]
        bits = (edges[pos][:, None] >> np.arange(8, dtype=np.uint8)) & 1
        seg_map: Dict[int, SubNode] = {}
        _bulk_nodes(seg_map, keys[pos],
                    np.where(red[:, None], bits[:, :4], fw[pos]),
                    np.where(red[:, None], bits[:, 4:], bw[pos]),
                    np.where(red, 1, cov[pos]), 1)
        for key in keys[pos][red].tolist():
            seg_map[key].color = 2
        if not merged:
            merged = seg_map
            continue
        for key, node in seg_map.items():
            tgt = merged.get(key)
            if tgt is None:
                merged[key] = node
            else:
                for w in range(4):
                    tgt.fw[w] = _satadd(tgt.fw[w], node.fw[w])
                    tgt.bw[w] = _satadd(tgt.bw[w], node.bw[w])
                tgt.cov = _satadd(tgt.cov, node.cov)
    return merged


def _load_bed_spans(dbg):
    spans: Dict[str, List[Tuple[int, int]]] = {}
    with open(dbg.ui.in_bed_include) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 3:
                spans.setdefault(parts[0], []).append(
                    (int(parts[1]), int(parts[2])))
    # reference projects path coordinates onto segments
    # (src/kreeq.cpp:284-333); our segment headers are `<path>.<n>`.
    # NOTE: the reference never advances absPos across SEGMENT
    # components (only gaps) — an apparent bug we do not reproduce;
    # spans here use true absolute path coordinates (KNOWN_GAPS.md)
    out: Dict[str, List[Tuple[int, int]]] = {}
    for path in dbg.genome.paths:
        if path.header not in spans:
            continue
        abs_pos = 0
        for comp, obj in dbg.genome.path_components(path):
            if comp.ctype == "S":
                for b, e in spans[path.header]:
                    if abs_pos < b < abs_pos + len(obj):
                        out.setdefault(obj.header, []).append(
                            (b - abs_pos, e - abs_pos))
                abs_pos += len(obj)
            else:
                abs_pos += obj.dist
    return out


# -- DB neighbour lookup ----------------------------------------------------


def _db_node(table, key: int) -> Optional[SubNode]:
    rec = table.lookup(key)
    if rec is None:
        return None
    fw, bw, cov = rec
    return SubNode(list(map(int, fw)), list(map(int, bw)), cov, 0)


# -- searches ---------------------------------------------------------------


def traversal(dbg, sub: Dict[int, SubNode]) -> None:
    """BFS frontier expansion, kmerDepth rounds (reference:
    src/subgraph.cpp:301-415), on the table's device.

    Each round scans the frontier's neighbours in the reference's order
    (frontier order x fw0,bw0,..,fw3,bw3), keeps the first occurrence of
    each neighbour that is not yet a member, probes those with one B5
    launch, and keeps the hits on the device as the next frontier.  The
    hits come to the host in one copy and enter `sub` in scan order; on
    the device they join the sorted member set.

    The JAX package tests each round against the seed set only, so its
    frontiers carry nodes of earlier rounds again.  A node first found
    in round d has every eligible neighbour found by round d + 1, so
    such a revisit never adds a node and never reorders the new ones:
    the growing set gives the same dict, insertion order included."""
    k = dbg.k
    table = dbg.table
    dev = table.device
    fkeys, ffw, fbw = _node_arrays(sub, dev)
    members = torch.sort(fkeys).values
    for _ in range(dbg.ui.resolved_kmer_depth()):
        if fkeys.shape[0] == 0:
            break
        vals, _flat = survivors(fkeys, ffw, fbw, members, k, 0, dedup=True)
        if vals.shape[0] == 0:
            break
        found, cov, fw, bw = table.probe_device(vals)
        hit = torch.nonzero(found).squeeze(1)
        fkeys, ffw, fbw = vals[hit], fw[hit], bw[hit]
        rows = torch.cat([fkeys[:, None], cov[hit][:, None], ffw, fbw],
                         1).cpu().numpy()
        log.count("subgraph.rounds")
        log.count("subgraph.round_nodes", rows.shape[0])
        # new keys only, so updating sub keeps its order and appends
        # the round's nodes in scan order
        _bulk_nodes(sub, keys_to_u64(rows[:, 0]), rows[:, 2:6],
                    rows[:, 6:10], rows[:, 1])
        members = torch.sort(torch.cat([members, fkeys])).values


def best_first(dbg, sub: Dict[int, SubNode]) -> Dict[int, SubNode]:
    """Per-node bounded Dijkstra with shared cache (reference:
    src/subgraph.cpp:417-579).

    Prefilter: a source whose depth-0 iteration can insert no node —
    every above-cutoff neighbour is already in the subgraph or absent
    from the DB — runs to an empty heap with zero discoveries and zero
    cache writes, so skipping it is exact.  One neighbour scan and one
    probe on the device select the boundary sources; only those run the
    host Fibonacci-heap search.
    """
    cache: Dict[int, SubNode] = {}
    candidates: Dict[int, SubNode] = {}
    copy: Dict[int, SubNode] = {}
    need = _boundary_sources(dbg, sub)
    log.count("subgraph.sources", int(need.sum()))
    with log.span("kq.subgraph.search"):
        for idx, (key, node) in enumerate(sub.items()):
            if need[idx]:
                _explored, discovered = _dijkstra(dbg, sub, key, node,
                                                  cache)
                for dk, dn in discovered.items():
                    candidates.setdefault(dk, dn)
            copy[key] = node
    for dk, dn in candidates.items():
        copy.setdefault(dk, dn)
    return copy


def _boundary_sources(dbg, sub: Dict[int, SubNode]) -> np.ndarray:
    """Mask over sub's insertion order: sources whose depth-0 scan can
    insert at least one node (above-cutoff edge to a key that is not
    in sub and is in the DB)."""
    n = len(sub)
    if n == 0:
        return np.zeros(0, bool)
    keys, fw, bw = _node_arrays(sub, dbg.table.device)
    vals, flat = survivors(keys, fw, bw, torch.sort(keys).values, dbg.k,
                           dbg.ui.cov_cutoff, dedup=False)
    if vals.shape[0] == 0:
        return np.zeros(n, bool)
    uniq, inv = torch.unique(vals, return_inverse=True)
    found = dbg.table.probe_device(uniq)[0]
    need = torch.zeros(n, dtype=torch.bool, device=keys.device)
    need[flat[found[inv]] // 8] = True
    return need.cpu().numpy()


def _dijkstra(dbg, sub, source_key: int, source_node: SubNode, cache):
    """Reference: src/subgraph.cpp:460-579.  depth counts extracted
    nodes, not levels; all queued nodes carry priority 0 (insert-then-
    refused-decreaseKey), so order follows the heap mechanics."""
    k = dbg.k
    table = dbg.table
    cutoff = dbg.ui.cov_cutoff
    kmer_depth = dbg.ui.resolved_kmer_depth()

    heap = FibonacciHeap()
    dist: Dict[int, int] = {source_key: 1}
    prev: Dict[int, Tuple[int, bool]] = {}
    vals: Dict[int, SubNode] = {source_key: source_node}
    discovered: Dict[int, SubNode] = {}
    destinations: List[int] = []
    heap.insert(source_key, 1)
    depth = 0
    direction = True
    explored = False

    def check_next(key: int, dirn: bool, ukey: int) -> bool:
        if key in sub:
            return True
        nxt = cache.get(key)
        if nxt is None:
            nxt = _db_node(table, key)
            if nxt is None:
                return True  # edge present but neighbour not in DB
            cache[key] = nxt
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
        uval = vals[ukey]
        if ukey in prev:
            direction = prev[ukey][1]
        edge_count = 0
        explored_count = 0
        for i in range(4):
            if direction or depth == 0:
                if depth == 0:
                    direction = True
                if uval.fw[i] > cutoff:
                    nk, isfw = canonical(next_key_fw(ukey, i, k), k)
                    if check_next(nk, direction if isfw else not direction,
                                  ukey):
                        explored_count += 1
                        if nk in sub:
                            destinations.append(ukey)
                    edge_count += 1
            if (not direction) or depth == 0:
                if depth == 0:
                    direction = False
                if uval.bw[i] > cutoff:
                    nk, isfw = canonical(next_key_bw(ukey, i, k), k)
                    if check_next(nk, direction if isfw else not direction,
                                  ukey):
                        explored_count += 1
                        if nk in sub:
                            destinations.append(ukey)
                    edge_count += 1
        depth += 1
        if (edge_count == explored_count or depth == kmer_depth + 1
                or len(destinations) >= 10):
            explored = True

    for dest in destinations:
        while dest != source_key:
            node = cache.get(dest)
            if node is not None:
                discovered.setdefault(
                    dest, SubNode(list(node.fw), list(node.bw), node.cov, 0))
            dist.pop(dest, None)
            dest = prev[dest][0]
    if explored:
        for key in dist:
            cache.pop(key, None)
    return explored, discovered


def search_graph(dbg, sub: Dict[int, SubNode]) -> Dict[int, SubNode]:
    """Reference: src/subgraph.cpp:290-299."""
    alg = dbg.ui.trav_algorithm
    if alg == "best-first":
        return best_first(dbg, sub)
    if alg == "traversal":
        traversal(dbg, sub)
        return sub
    sys.stderr.write(
        f"Cannot find input algorithm ({alg}). Terminating.\n")
    sys.exit(1)


# -- pruning + summary ------------------------------------------------------


def remove_missing_edges(dbg, sub: Dict[int, SubNode]) -> None:
    """Zero edges whose endpoint is not in the subgraph; only counters
    above the cutoff are eligible for pruning (reference quirk,
    src/subgraph.cpp:599-628).  The neighbour scan runs on the device;
    only the slots that prune are touched on the host."""
    if not sub:
        return
    keys, fw, bw = _node_arrays(sub, dbg.table.device)
    _vals, flat = survivors(keys, fw, bw, torch.sort(keys).values, dbg.k,
                            dbg.ui.cov_cutoff, dedup=False)
    nodes = list(sub.values())
    for f in flat.tolist():
        node = nodes[f // 8]
        slot = f % 8
        if slot % 2 == 0:
            node.fw[slot // 2] = 0
        else:
            node.bw[slot // 2] = 0


def subgraph_summary_lines(sub: Dict[int, SubNode], k: int) -> List[str]:
    """Reference: src/subgraph.cpp:163-188 (same either-side edge
    quirk as DBstats)."""
    tot = sum(n.cov for n in sub.values())
    unique = sum(1 for n in sub.values() if n.cov == 1)
    distinct = len(sub)
    edges = sum(1 for n in sub.values() for w in range(4)
                if n.fw[w] > 0 or n.bw[w] > 0)
    return [
        "Subgraph summary statistics:",
        f"Total kmers: {tot}",
        f"Unique kmers: {unique}",
        f"Distinct kmers: {distinct}",
        f"Missing kmers: {4 ** k - distinct}",
        f"Total edges: {edges}",
    ]


# -- GFA emission -----------------------------------------------------------


def graph_to_gfa(dbg, sub: Dict[int, SubNode]) -> Genome:
    """Reference: src/kreeq.cpp:523-600 (DBGgraphToGFA)."""
    if not dbg.ui.no_collapse:
        return collapse_nodes(dbg, sub)
    k = dbg.k
    gfa = Genome()
    id_counter = 0
    edge_counter = 0
    seg_of_key: Dict[int, object] = {}
    for key, node in sub.items():
        seg = gfa.add_segment(str(id_counter), key_to_seq(key, k),
                              seq_pos=id_counter,
                              tags=[("f", "DP", str(node.cov)),
                                    ("Z", "CB", color_palette(node.color))])
        seg_of_key[key] = seg
        id_counter += 1
    for key, node in sub.items():
        this_seg = seg_of_key[key]
        # two separate passes, like the reference (src/kreeq.cpp:549-593)
        for i in range(4):
            if node.fw[i] == 0:
                continue
            nk, isfw = canonical(next_key_fw(key, i, k), k)
            nxt = seg_of_key.get(nk)
            if nxt is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter, this_seg.uid,
                              nxt.uid, "+", "+" if isfw else "-",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.fw[i]))]))
            id_counter += 1
            edge_counter += 1
        for i in range(4):
            if node.bw[i] == 0:
                continue
            nk, isfw = canonical(next_key_bw(key, i, k), k)
            prv = seg_of_key.get(nk)
            if prv is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter, prv.uid,
                              this_seg.uid, "+" if isfw else "-", "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.bw[i]))]))
            id_counter += 1
            edge_counter += 1
    return gfa


def collapse_nodes(dbg, sub: Dict[int, SubNode]) -> Genome:
    """Greedy unbranching-run collapse into unitigs (reference:
    src/kreeq.cpp:360-521).  Output counts are traversal-order
    independent; node choice follows dict order (the reference picks
    arbitrary phmap order).  Consumes `sub`.

    Both loops take the first remaining key in insertion order, as the
    JAX package's `next(iter(...))` does.  Neither dict gains a key while
    it is consumed, so one pass over a snapshot of its keys finds every
    head: `next(iter(d))` would rescan the deleted prefix each time,
    quadratic in the node count."""
    k = dbg.k
    gfa = Genome()
    id_counter = 0
    edge_counter = 0
    # residual: key -> (node snapshot, unitig id, direction)
    residual: Dict[int, Tuple[SubNode, int, int]] = {}

    def extend(seed: List[int], direction: int) -> List[int]:
        """seed: list of base codes (length >= k), extended in place.
        Returns the grown seed (reference collapseNodes extend lambda,
        src/kreeq.cpp:365-427)."""
        fwkey = 0
        for i, b in enumerate(seed[:k]):
            fwkey |= b << (2 * i)
        rckey = revcomp_key(fwkey, k)
        key, isfw = (fwkey, True) if fwkey <= rckey else (rckey, False)
        node = sub.get(key)
        if node is None:
            return seed
        top = 2 * (k - 1)
        kmask = mask(k)
        while True:
            idx = ([i for i in range(4) if node.fw[i]] if isfw
                   else [3 - i for i in range(4) if node.bw[i]])
            i = idx[0]
            # next kmer = window shifted one base fw: both packings
            # update in O(1) (the rc of a fw-shift prepends the
            # complement base)
            fwkey = (fwkey >> 2) | (i << top)
            rckey = ((rckey << 2) & kmask) | (3 - i)
            key_prev, node_prev = key, node
            key, isfw = ((fwkey, True) if fwkey <= rckey
                         else (rckey, False))
            got = sub.get(key)
            if got is None:
                if key in residual:
                    residual[key_prev] = (node_prev, id_counter, direction)
                break
            node = got
            front = ([w for w in range(4) if node.fw[w]] if isfw
                     else [w for w in range(4) if node.bw[w]])
            back = ([w for w in range(4) if node.bw[w]] if isfw
                    else [w for w in range(4) if node.fw[w]])
            if len(back) > 1:
                residual[key_prev] = (node_prev, id_counter, direction)
                break
            seed.append(i)
            del sub[key]
            if len(front) == 0:
                break
            if len(front) > 1:
                residual[key] = (node, id_counter, direction)
                break
        return seed

    order = iter(list(sub))
    while sub:
        key = next(key for key in order if key in sub)
        node = sub[key]
        front = [(key >> (2 * i)) & 3 for i in range(k)]
        back = [3 - b for b in reversed(front)]
        edge_counts = (node.bw_count(), node.fw_count())
        snapshot = SubNode(list(node.fw), list(node.bw), node.cov,
                           node.color)
        if edge_counts[0] == 1 or edge_counts[1] == 1:
            for direction in (1, 0):
                if edge_counts[direction] == 1:
                    if direction:
                        front = extend(front, 1)
                    else:
                        back = extend(back, 0)
                elif edge_counts[direction] > 1:
                    residual[key] = (snapshot, id_counter, direction)
            sub.pop(key, None)
        else:
            residual[key] = (snapshot, id_counter, 0)
            sub.pop(key, None)  # reference never erases here (would hang)
        # unitig = revcom(back) + front[k:]
        seq_codes = [3 - b for b in reversed(back)] + front[k:]
        seq = "".join(ITOC[b] for b in seq_codes)
        gfa.add_segment(str(id_counter), seq, seq_pos=id_counter,
                        tags=[("f", "DP", str(snapshot.cov)),
                              ("Z", "CB", color_palette(snapshot.color))])
        id_counter += 1

    seg_by_header = {s.header: s for s in gfa.segments}
    # the reference consumes residualEdges head-first; a neighbour's
    # reciprocal edge is skipped once the head is erased, so each
    # unitig adjacency is emitted exactly once
    # (reference: src/kreeq.cpp:463-519)
    for key in list(residual):
        node, uid, direction = residual[key]
        this_header = str(uid)
        # two separate passes, like the reference (src/kreeq.cpp:468-517)
        for i in range(4):
            if node.fw[i] == 0:
                continue
            nk, _ = canonical(next_key_fw(key, i, k), k)
            got = residual.get(nk)
            if got is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter,
                              seg_by_header[this_header].uid,
                              seg_by_header[str(got[1])].uid,
                              "+" if direction else "-",
                              "-" if got[2] else "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.fw[i]))]))
            id_counter += 1
            edge_counter += 1
        for i in range(4):
            if node.bw[i] == 0:
                continue
            nk, _ = canonical(next_key_bw(key, i, k), k)
            got = residual.get(nk)
            if got is None:
                continue
            gfa.add_edge(Edge(id_counter, edge_counter,
                              seg_by_header[str(got[1])].uid,
                              seg_by_header[this_header].uid,
                              "+" if got[2] else "-",
                              "-" if direction else "+",
                              f"{k - 1}M", f"edge.{edge_counter}",
                              [("i", "KC", str(node.bw[i]))]))
            id_counter += 1
            edge_counter += 1
        del residual[key]
    return gfa


# -- the mode ---------------------------------------------------------------


def run_subgraph(dbg, out=None) -> None:
    """Reference flow: src/input.cpp:153-180."""
    out = out or sys.stdout
    if not dbg.ui.in_sequence:
        return
    with log.phase("extract"):
        sub = extract_subgraph(dbg)
    log.count("subgraph.seed", len(sub))
    log.count("subgraph.blue", sum(1 for n in sub.values() if n.color == 1))
    with log.phase("search"):
        sub = search_graph(dbg, sub)
    with log.phase("prune"):
        remove_missing_edges(dbg, sub)
    out.write("\n".join(subgraph_summary_lines(sub, dbg.k)) + "\n")
    with log.phase("collapse"):
        dbg.subgraph_gfa = graph_to_gfa(dbg, sub)
    with log.phase("graph stats"):
        lines = report_stats_lines(dbg.subgraph_gfa)
    out.write("\n".join(lines) + "\n")

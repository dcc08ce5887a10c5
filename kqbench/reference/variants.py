"""kreeq's candidate errors of an assembly (`validate -d db -f asm -o
x.vcf`), worked out again in plain Python and NumPy.

The semantics are upstream kreeq's `correctSequences`
(github.com/vgl-hub/kreeq, src/variants.cpp:40-310), followed as
written: a loop over each segment's positions that keeps the targets
queue and map as upstream keeps them, and from every position whose
k-mer the table holds, a bounded Dijkstra into the read graph over
upstream's bounded Fibonacci heap (include/fibonacci-heap.h), written
here on arrays of its own.  The defaults are the CLI's: `max_span` 5,
a search depth of k (best-first, include/kreeq.h:168-177), coverage
cutoff 0.

Upstream's quirks, kept where the code keeps them:
  - popping the queue's front erases its key from the map, also when
    the key is still queued further back (`segment_records`);
  - the cutoff applies to the bw side only (`_search`);
  - the search stops after k + 1 extractions, when every edge was
    explored, or at 10 destinations; distances are u8 (`_search`);
  - new nodes enter the heap at priority 0 and decreaseKey never raises
    a key, so the heap's splice and consolidate order, with 1000 nodes
    and evict-on-insert, fixes the extraction order (`FibonacciHeap`);
  - the COM, SNV, DEL and INS rules and the backtrack (`_paths`).

Departures, each where upstream reads what it has not defined:
  - a window holding a non-base is a key of its own that no table row
    and no other window equals (upstream hashes the byte anyway);
  - the last position excludes no reference edge (upstream reads one
    byte past the segment); its targets are empty, so no record moves;
  - the queue's front is popped only when the queue has one
    (`front()` of an empty deque);
  - an edge to a k-mer the table lacks raises (upstream dereferences
    the map's end; a table counted from reads never has one).

The VCF is rendered as the gfalibs writer does, by the rules the
port's io/vcf.py states and validateFiles/test.50.tst pins.

Nothing here reads what the program under test made, or imports it.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from .kmers import CTOI, Table, windows
from .validate import paths_of

SNV, INS, DEL, COM = "SNV", "INS", "DEL", "COM"
MAX_SPAN = 5
CUTOFF = 0
# upstream's bounded heap (include/fibonacci-heap.h)
HEAP_NODES = 1000
U8_MAX = 255

HEADER = (
    "##fileformat=VCFv4.2\n"
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description='
    '"Genotype Quality">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")

_M64 = (1 << 64) - 1


class FibonacciHeap:
    """Upstream's bounded Fibonacci heap, its nodes as indices into
    arrays.  Roots and children are circular doubly linked lists; a
    new node or a root moved up is spliced in to the left of the
    minimum; the consolidation table is rebuilt by each extraction and
    its roots spliced back in table order; at `max_nodes` an insert
    first decreases the last table entry to 0 and extracts it."""

    def __init__(self, max_nodes: int = HEAP_NODES):
        self.max_nodes = max_nodes
        self.n = 0
        self.min = -1
        self.table = []
        self.at = {}  # object -> node
        self.obj, self.key = [], []
        self.left, self.right = [], []
        self.parent, self.child = [], []
        self.degree, self.mark = [], []

    def size(self) -> int:
        return self.n

    def _new(self, obj, key: int) -> int:
        i = len(self.obj)
        self.obj.append(obj)
        self.key.append(key)
        self.left.append(i)
        self.right.append(i)
        self.parent.append(-1)
        self.child.append(-1)
        self.degree.append(0)
        self.mark.append(False)
        return i

    def _splice_left_of_min(self, i: int) -> None:
        m = self.min
        ml = self.left[m]
        self.left[m] = i
        self.right[i] = m
        self.left[i] = ml
        self.right[ml] = i

    def insert(self, obj, key: int) -> None:
        if self.n >= self.max_nodes:
            victim = self.table[-1] if self.table else -1
            if victim >= 0:
                self.decrease_key(self.obj[victim], 0)
            self.at.pop(self.extract_min(), None)
        i = self._new(obj, key)
        self.at[obj] = i
        if self.min >= 0:
            self._splice_left_of_min(i)
        if self.min < 0 or self.key[self.min] > key:
            self.min = i
        self.n += 1

    def _to_root(self, i: int) -> None:
        self.parent[i] = -1
        self.mark[i] = False
        if self.min >= 0:
            self._splice_left_of_min(i)
            if self.key[self.min] > self.key[i]:
                self.min = i
        else:
            self.min = i
            self.left[i] = self.right[i] = i

    def _unlink(self, i: int) -> None:
        if self.right[i] != i:
            self.left[self.right[i]] = self.left[i]
            self.right[self.left[i]] = self.right[i]
        p = self.parent[i]
        if p >= 0:
            self.child[p] = -1 if self.degree[p] == 1 else self.right[i]
            self.degree[p] -= 1

    def extract_min(self):
        m = self.min
        if m < 0:
            return None
        c = self.child[m]
        for _ in range(self.degree[m]):
            nxt = self.right[c]
            self._to_root(c)
            c = nxt
        self._unlink(m)
        self.n -= 1
        if self.n == 0:
            self.min = -1
        else:
            r, ml = self.right[m], self.left[m]
            self.min = r
            self.left[r] = ml
            self.right[ml] = r
            self._consolidate()
        return self.obj[m]

    def decrease_key(self, obj, key: int) -> None:
        i = self.at.get(obj)
        if i is None or key > self.key[i]:
            return
        self.key[i] = key
        p = self.parent[i]
        if p >= 0 and key < self.key[p]:
            self._cut(i)
            self._cascade(p)
        if self.min >= 0 and key < self.key[self.min]:
            self.min = i

    def _cut(self, i: int) -> None:
        self._unlink(i)
        self._to_root(i)

    def _cascade(self, i: int) -> None:
        p = self.parent[i]
        if p >= 0:
            if not self.mark[i]:
                self.mark[i] = True
            else:
                self._cut(i)
                self._cascade(p)

    def _link(self, high: int, low: int) -> None:
        """`high` becomes a child of `low`."""
        self._unlink(high)
        if self.degree[low] == 0:
            self.child[low] = high
            self.left[high] = self.right[high] = high
        else:
            c = self.child[low]
            cl = self.left[c]
            self.left[c] = high
            self.right[high] = c
            self.left[high] = cl
            self.right[cl] = high
        self.parent[high] = low
        self.degree[low] += 1
        self.mark[high] = False

    def _consolidate(self) -> None:
        if self.n <= 1:
            return
        table = self.table = []
        roots = 1
        i = self.right[self.min]
        while i != self.min:
            roots += 1
            i = self.right[i]
        cur = self.min
        for _ in range(roots):
            x = cur
            cur = self.right[cur]
            d = self.degree[x]
            while True:
                while d >= len(table):
                    table.append(-1)
                y = table[d]
                if y < 0:
                    table[d] = x
                    break
                if self.key[x] > self.key[y]:
                    x, y = y, x
                if x == y:
                    break
                self._link(y, x)
                table[d] = -1
                d += 1
        self.min = -1
        for i in table:
            if i >= 0:
                self._to_root(i)


def _revcomp(x: int, k: int) -> int:
    """The reverse complement of a k-mer packed first base lowest."""
    x = ~x & _M64
    x = ((x >> 2) & 0x3333333333333333) | ((x & 0x3333333333333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0F) | ((x & 0x0F0F0F0F0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF00FF00FF) | ((x & 0x00FF00FF00FF00FF) << 8)
    x = ((x >> 16) & 0x0000FFFF0000FFFF) | ((x & 0x0000FFFF0000FFFF) << 16)
    x = (x >> 32) | ((x << 32) & _M64)
    return x >> (64 - 2 * k)


def _next(key: int, base: int, forward: bool, k: int):
    """(canonical key, whether it is the forward strand) of the k-mer
    one step from `key` read in its own orientation: drop the first
    base and append `base` (forward), or drop the last and prepend it
    (upstream's buildNextKmer, then the hash)."""
    if forward:
        raw = (key >> 2) | (base << (2 * (k - 1)))
    else:
        raw = ((key << 2) & ((1 << 2 * k) - 1)) | base
    rc = _revcomp(raw, k)
    return (raw, True) if raw <= rc else (rc, False)


class Db:
    """The table as upstream's map: `find(key)` gives (fw, bw, cov) of
    a key's row as Python ints, or None."""

    def __init__(self, table: Table):
        self.keys = table.keys
        self.fw, self.bw, self.cov = table.fw, table.bw, table.cov

    def row(self, i: int):
        return (self.fw[i].tolist(), self.bw[i].tolist(), int(self.cov[i]))

    def find(self, key: int):
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and int(self.keys[i]) == key:
            return self.row(i)
        return None


@dataclass
class Record:
    """Upstream's DBGpath: a candidate error at segment position `pos`."""

    type: str
    pos: int
    sequence: str
    ref_len: int


def _search(db: Db, k: int, source: int, rec, source_fw: bool, ref,
            queue, tmap, cache: dict, depth_max: int, cutoff: int, heap):
    """src/variants.cpp:171-310: (explored, records) of the search from
    one found k-mer."""
    explored = False
    destinations = []
    q = heap()
    dist = {source: 1}
    prev = {}
    node = {source: rec}  # what each heap entry points at
    q.insert(source, 1)
    depth = 0
    direction = True

    def check_next(key: int, dirn: bool, u: int) -> bool:
        if key in tmap:
            return True
        nxt = cache.get(key)
        if nxt is None:
            nxt = db.find(key)
            if nxt is None:
                raise ValueError(f"an edge leads to k-mer {key:#x}, which "
                                 "the table lacks")
            cache[key] = nxt
        alt = dist[u]
        if alt < U8_MAX:
            alt += 1
        if key not in dist:
            dist[key] = U8_MAX
            node[key] = nxt
            q.insert(key, 0)
        if alt < dist[key]:
            prev[key] = (u, dirn)
            dist[key] = alt
            q.decrease_key(key, alt)
        return True

    while q.size() > 0 and depth < depth_max + 1:
        explored = False
        u = q.extract_min()
        fw, bw, _cov = node[u]
        if u in prev:
            direction = prev[u][1]
        edges = explored_edges = 0
        candidates = []
        for i in range(4):
            if depth == 0:
                direction = source_fw
            # quirk: `direction ? fw[i] : bw[i] > covCutOff`
            if (fw[i] != 0) if direction else (bw[i] > cutoff):
                key, isfw = _next(u, i, direction, k)
                if key != ref:
                    candidates.append((key, isfw, direction))
                    edges += 1
        for key, isfw, dirn in candidates:
            if check_next(key, dirn if isfw else not dirn, u):
                explored_edges += 1
                if key in tmap:
                    prev[key] = (u, dirn)
                    destinations.append(key)
        depth += 1
        if (edges == explored_edges or depth == depth_max + 1
                or len(destinations) >= 10):
            explored = True
    records = _paths(k, source, destinations, prev, queue)
    if explored:
        for key in dist:
            cache.pop(key, None)
    return explored, records


def _paths(k: int, source: int, destinations, prev, queue):
    """src/variants.cpp:265-304: a record a destination, classified by
    the walk's length against the target's place in the queue, its
    sequence backtracked from the prev map (a missing entry reads as
    upstream's default, (0, false))."""
    out = []
    queue = list(queue) if destinations else []
    for dest in destinations:
        ref_len = (queue.index(dest) if dest in queue else len(queue)) + k
        steps = 0
        nd = prev.get(dest, (0, False))[0]
        while nd != source:
            nd = prev.get(nd, (0, False))[0]
            steps += 1
            if steps > len(prev) + 1:
                raise ValueError("the prev map does not lead back to the "
                                 "source")
        nd = prev.get(dest, (0, False))[0]
        direction = prev.get(nd, (0, False))[1]
        b = steps - ref_len
        ref_out = 1
        if ref_len > k:
            kind = COM
            ref_out = ref_len - k + 1
            b = ref_len - k
        elif steps == ref_len:
            kind = SNV
        elif steps > ref_len:
            kind = DEL
            b -= 1
            nd = prev.get(nd, (0, False))[0]
            direction = prev.get(nd, (0, False))[1]
        else:
            kind = INS
        seq = []
        while b >= 0:
            if direction:
                seq.append("ACGT"[nd & 3])
            else:
                seq.append("TGCA"[(nd >> (2 * (k - 1))) & 3])
            nd = prev.get(nd, (0, False))[0]
            direction = prev.get(nd, (0, False))[1]
            b -= 1
        out.append(Record(kind, 0, "".join(reversed(seq)), ref_out))
    return out


def segment_records(db: Db, seq: bytes, k: int, max_span: int = MAX_SPAN,
                    depth: int = None, cutoff: int = CUTOFF,
                    heap=FibonacciHeap):
    """src/variants.cpp:53-169: the groups of records of one segment, in
    position order.  `depth` defaults to k (best-first)."""
    ln = len(seq)
    if ln < k:
        return []
    depth = k if depth is None else depth
    kcount = ln - k + 1
    w = windows(CTOI[np.frombuffer(seq, np.uint8)], k)
    keys = w.key.tolist()
    for p in np.flatnonzero(~w.valid).tolist():
        keys[p] = -1 - p  # a non-base window: a key of its own
    isfw = w.isfw.tolist()
    # db.find of every position's k-mer, as one sorted search
    t = len(db.keys)
    rows = np.minimum(np.searchsorted(db.keys, w.key), max(t - 1, 0))
    found = ((db.keys[rows] == w.key) & w.valid if t
             else np.zeros(kcount, bool)).tolist()
    rows = rows.tolist()
    cache = {}
    visited = bytearray(kcount)
    explored = 0
    groups = []
    while explored < kcount:
        before = explored
        queue = deque()
        tmap = set()
        for pos in range(max_span):
            if pos + k < kcount:
                queue.append(keys[pos + k])
                tmap.add(keys[pos + k])
        for c in range(kcount):
            if queue:
                # quirk: erases the key even if it is queued again
                tmap.discard(queue.popleft())
            if c + k + max_span < kcount:
                key = keys[c + k + max_span]
                tmap.add(key)
                queue.append(key)
            if visited[c]:
                continue
            if not found[c]:
                explored += 1
                visited[c] = 1
                continue
            ref = keys[c + 1] if c + 1 < kcount else None
            ok, recs = _search(db, k, keys[c], db.row(rows[c]), isfw[c],
                               ref, queue, tmap, cache, depth, cutoff, heap)
            explored += ok
            if ok:
                for r in recs:
                    r.pos = c + k
                if recs:
                    groups.append(recs)
                visited[c] = 1
        if explored == before:
            raise RuntimeError("a pass over the segment explored nothing")
    return groups


def vcf_line(name: str, abs_pos: int, seq: str, r: Record) -> str:
    """One VCF row (io/vcf.py's rules, validateFiles/test.50.tst)."""
    pos = r.pos
    if r.type in (SNV, COM):
        ref = seq[pos:pos + (r.ref_len if r.type == COM else 1)]
        alt = r.sequence
        vpos = abs_pos + pos + 1
    elif r.type == INS:
        ref = seq[pos - 1:pos + max(r.ref_len, 1)]
        alt = seq[pos - 1]
        vpos = abs_pos + pos
    else:  # DEL
        ref = seq[pos - 1:pos + 1]
        alt = seq[pos - 1] + r.sequence + seq[pos]
        vpos = abs_pos + pos
    return f"{name}\t{vpos}\t.\t{ref}\t{alt}\t0\tPASS\t.\tGT:GQ\t1/1:0\n"


def vcf(table: Table, records, **search) -> bytes:
    """The VCF of the assembly `records` ((name, sequence bytes) each)
    against `table`: a path a record, its segments in order.
    `search`: segment_records' options."""
    db = Db(table)
    out = [HEADER]
    for path in paths_of(records):
        for abs_pos, seq in path.segments:
            text = seq.decode("ascii")
            for group in segment_records(db, seq, table.k, **search):
                for r in group:
                    out.append(vcf_line(path.name, abs_pos, text, r))
    return "".join(out).encode()

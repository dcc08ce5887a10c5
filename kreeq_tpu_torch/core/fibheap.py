"""Behavior-faithful port of the reference's bounded Fibonacci heap
(reference: include/fibonacci-heap.h, modified from arXiv:2303.10034);
host code, the same as kreeq_tpu/core/fibheap.py.

The graph searches' golden outputs depend on this heap's exact
extraction order: nodes are inserted with priority 0 and decreaseKey
refuses to raise a key (reference: fibonacci-heap.h:129), so the
"Dijkstra" searches effectively drain an all-equal-priority heap whose
order is fixed by the splice/consolidate mechanics replicated here.
Bounded at 1000 nodes with evict-min-on-insert
(reference: fibonacci-heap.h:27,56-61).
"""

from __future__ import annotations

from typing import Dict, List, Optional


class _Node:
    __slots__ = ("degree", "parent", "child", "left", "right", "mark",
                 "key", "obj")

    def __init__(self, obj, key: int) -> None:
        self.degree = 0
        self.parent: Optional[_Node] = None
        self.child: Optional[_Node] = None
        self.left: _Node = self
        self.right: _Node = self
        self.mark = False
        self.key = key
        self.obj = obj  # the k-mer key (u64 int)


class FibonacciHeap:
    def __init__(self, max_nodes: int = 1000) -> None:
        self.min: Optional[_Node] = None
        self.n = 0
        self.max_nodes = max_nodes
        self.deg_table: List[Optional[_Node]] = []
        self.node_ptrs: Dict[int, _Node] = {}

    def size(self) -> int:
        return self.n

    def insert(self, obj: int, key: int) -> None:
        if self.n >= self.max_nodes:
            # evict: force the last consolidation-table entry to the
            # top, then extract it (reference: fibonacci-heap.h:56-61)
            victim = self.deg_table[-1]
            if victim is not None:
                self.decrease_key(victim.obj, 0)
            gone = self.extract_min()
            self.node_ptrs.pop(gone, None)
        node = _Node(obj, key)
        self.node_ptrs[obj] = node
        min_n = self.min
        if min_n is not None:
            min_left = min_n.left
            min_n.left = node
            node.right = min_n
            node.left = min_left
            min_left.right = node
        if min_n is None or min_n.key > node.key:
            self.min = node
        self.n += 1

    def extract_min(self) -> Optional[int]:
        min_n = self.min
        if min_n is None:
            return None
        curr = min_n.child
        for _ in range(min_n.degree):
            rem = curr
            curr = curr.right
            self._existing_to_root(rem)
        self._remove_node_from_root(min_n)
        self.n -= 1
        if self.n == 0:
            self.min = None
        else:
            self.min = min_n.right
            min_left = min_n.left
            self.min.left = min_left
            min_left.right = self.min
            self._consolidate()
        return min_n.obj

    def decrease_key(self, obj: int, new_key: int) -> None:
        node = self.node_ptrs.get(obj)
        if node is None or new_key > node.key:
            return
        node.key = new_key
        if node.parent is not None and node.key < node.parent.key:
            parent = node.parent
            self._cut(node)
            self._cascading_cut(parent)
        if self.min is not None and node.key < self.min.key:
            self.min = node

    # -- internals (mirroring the reference's splice order exactly) -----

    def _existing_to_root(self, node: _Node) -> None:
        min_n = self.min
        node.parent = None
        node.mark = False
        if min_n is not None:
            min_left = min_n.left
            min_n.left = node
            node.right = min_n
            node.left = min_left
            min_left.right = node
            if min_n.key > node.key:
                self.min = node
        else:
            self.min = node
            node.right = node
            node.left = node

    def _remove_node_from_root(self, node: _Node) -> None:
        if node.right is not node:
            node.right.left = node.left
            node.left.right = node.right
        if node.parent is not None:
            if node.parent.degree == 1:
                node.parent.child = None
            else:
                node.parent.child = node.right
            node.parent.degree -= 1

    def _cut(self, node: _Node) -> None:
        self._remove_node_from_root(node)
        self._existing_to_root(node)

    def _add_child(self, parent: _Node, child: _Node) -> None:
        if parent.degree == 0:
            parent.child = child
            child.right = child
            child.left = child
        else:
            c1 = parent.child
            c1_left = c1.left
            c1.left = child
            child.right = c1
            child.left = c1_left
            c1_left.right = child
        child.parent = parent
        parent.degree += 1

    def _cascading_cut(self, node: _Node) -> None:
        parent = node.parent
        if parent is not None:
            if not node.mark:
                node.mark = True
            else:
                self._cut(node)
                self._cascading_cut(parent)

    def _link(self, high: _Node, low: _Node) -> None:
        self._remove_node_from_root(high)
        self._add_child(low, high)
        high.mark = False

    def _consolidate(self) -> None:
        if self.n <= 1:
            return
        self.deg_table = []
        curr = self.min
        it_node = self.min
        root_cnt = 0
        while True:
            root_cnt += 1
            it_node = it_node.right
            if it_node is self.min:
                break
        for _ in range(root_cnt):
            consol = curr
            curr = curr.right
            deg = consol.degree
            while True:
                while deg >= len(self.deg_table):
                    self.deg_table.append(None)
                if self.deg_table[deg] is None:
                    self.deg_table[deg] = consol
                    break
                other = self.deg_table[deg]
                if consol.key > other.key:
                    consol, other = other, consol
                if other is consol:
                    break
                self._link(other, consol)
                self.deg_table[deg] = None
                deg += 1
        self.min = None
        for entry in self.deg_table:
            if entry is not None:
                self._existing_to_root(entry)

"""Directed graph utilities (reference utils/DirectedGraph.scala:34,
Node.scala; counterpart of ``bigdl_tpu/utils/directed_graph.py``, a
copy) — generic Node + DirectedGraph with BFS/DFS iterators and
Kahn topology sort.  The ``Graph`` container keeps its own specialized
topo sort over ModuleNodes; this is the general-purpose structure the
reference exposes (used by interop graph builders and user code).
"""
from __future__ import annotations

from typing import Any, Iterator, List


class Node:
    """Graph node holding an element; topology lives in the node links
    (reference utils/Node.scala)."""

    def __init__(self, element: Any = None):
        self.element = element
        self.next_nodes: List["Node"] = []
        self.prev_nodes: List["Node"] = []

    def add(self, node: "Node") -> "Node":
        """this -> node edge (reference Node.add); returns ``node``."""
        if node not in self.next_nodes:
            self.next_nodes.append(node)
        if self not in node.prev_nodes:
            node.prev_nodes.append(self)
        return node

    def delete(self, node: "Node") -> "Node":
        """remove this -> node edge."""
        if node in self.next_nodes:
            self.next_nodes.remove(node)
        if self in node.prev_nodes:
            node.prev_nodes.remove(self)
        return self

    def __repr__(self):
        return f"Node({self.element!r})"

    def graph(self, reverse: bool = False) -> "DirectedGraph":
        return DirectedGraph(self, reverse)


class DirectedGraph:
    """Stores a source node; topology is in the node connections
    (reference DirectedGraph.scala:34).  ``reverse=True`` walks prev
    edges instead of next edges."""

    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _next(self, node: Node) -> List[Node]:
        return node.prev_nodes if self.reverse else node.next_nodes

    def size(self) -> int:
        return sum(1 for _ in self.bfs())

    def edges(self) -> int:
        return sum(len(self._next(n)) for n in self.bfs())

    def bfs(self) -> Iterator[Node]:
        """Breadth-first iterator from the source (DirectedGraph.BFS)."""
        from collections import deque

        visited = {id(self.source)}
        queue = deque([self.source])
        while queue:
            node = queue.popleft()
            yield node
            for nxt in self._next(node):
                if id(nxt) not in visited:
                    visited.add(id(nxt))
                    queue.append(nxt)

    def dfs(self) -> Iterator[Node]:
        """Depth-first iterator from the source (DirectedGraph.DFS)."""
        visited = set()
        stack = [self.source]
        while stack:
            node = stack.pop()
            if id(node) in visited:
                continue
            visited.add(id(node))
            yield node
            for nxt in self._next(node):
                if id(nxt) not in visited:
                    stack.append(nxt)

    def topology_sort(self) -> List[Node]:
        """Kahn's algorithm; raises on cycles
        (DirectedGraph.topologySort, :52)."""
        in_degrees: dict = {id(self.source): [self.source, 0]}
        for n in self.dfs():
            for m in self._next(n):
                entry = in_degrees.setdefault(id(m), [m, 0])
                entry[1] += 1
        result: List[Node] = []
        while in_degrees:
            start = [k for k, (_, deg) in in_degrees.items() if deg == 0]
            if not start:
                raise ValueError("There's a cycle in the graph")
            for k in start:
                node, _ = in_degrees.pop(k)
                result.append(node)
                for nxt in self._next(node):
                    if id(nxt) in in_degrees:
                        in_degrees[id(nxt)][1] -= 1
        return result

"""Graph container (counterpart of ``bigdl_tpu/nn/graph.py``; reference
nn/Graph.scala:58, utils/DirectedGraph.scala:34).

``Graph`` topo-sorts its DAG once at construction and replays the sorted
node list in one ``apply_fn``; autograd differentiates the whole graph,
as the JAX package takes the vjp of it.  Its children are the sorted
nodes' modules under ``"0"``, ``"1"``, … in ``topo_sort``'s DFS
post-order, the JAX ``Graph``'s keys, so ``load_param_tree`` carries a
JAX graph's weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..utils.table import Table
from .containers import Identity
from .module import AbstractModule, Container


class ModuleNode:
    """DAG node wrapping a module (reference ``Node[AbstractModule]``)."""

    _counter = [0]

    def __init__(self, element: AbstractModule):
        self.element = element
        self.prev_nodes: List["ModuleNode"] = []
        self.next_nodes: List["ModuleNode"] = []
        ModuleNode._counter[0] += 1
        self.uid = ModuleNode._counter[0]

    def add_edge(self, to: "ModuleNode"):
        self.next_nodes.append(to)
        to.prev_nodes.append(self)
        return self

    def inputs(self, *nodes):
        for n in nodes:
            n.add_edge(self)
        return self

    def __repr__(self):
        return f"Node({self.element.get_name()})"


def Input(device=None) -> ModuleNode:
    """Placeholder source node (reference nn/Graph.scala Input)."""
    return ModuleNode(Identity(device=device))


def topo_sort(outputs: Sequence[ModuleNode]) -> List[ModuleNode]:
    """DFS post-order topological sort (reference
    DirectedGraph.topologySort:52)."""
    visited, order = set(), []

    def visit(node):
        if node.uid in visited:
            return
        visited.add(node.uid)
        for p in node.prev_nodes:
            visit(p)
        order.append(node)

    for out in outputs:
        visit(out)
    return order


class Graph(Container):
    """DAG of modules with explicit input and output nodes (reference
    nn/Graph.scala:58).  A multi-input graph takes a 1-based ``Table``
    in the order of ``inputs``; a multi-output graph returns one; a node
    with several predecessors gets a ``Table`` of their outputs in
    ``prev_nodes`` order.  On the first node module's device unless
    ``device`` is given."""

    def __init__(self, inputs, outputs, device=None):
        if isinstance(inputs, ModuleNode):
            inputs = [inputs]
        if isinstance(outputs, ModuleNode):
            outputs = [outputs]
        self.input_nodes = list(inputs)
        self.output_nodes = list(outputs)
        self.sorted_nodes = topo_sort(self.output_nodes)
        sorted_ids = {n.uid for n in self.sorted_nodes}
        for i in self.input_nodes:
            if i.uid not in sorted_ids:
                raise ValueError("graph input not connected to any output")
        super().__init__(*[n.element for n in self.sorted_nodes],
                         device=device)

    def apply_fn(self, params, x):
        activities: Dict[int, object] = {}
        if len(self.input_nodes) == 1:
            activities[self.input_nodes[0].uid] = x
        else:
            for i, node in enumerate(self.input_nodes):
                activities[node.uid] = x[i + 1]
        for i, node in enumerate(self.sorted_nodes):
            if node.uid in activities:
                a = activities[node.uid]
            elif len(node.prev_nodes) == 1:
                a = activities[node.prev_nodes[0].uid]
            else:
                a = Table(*[activities[p.uid] for p in node.prev_nodes])
            activities[node.uid] = node.element.apply_fn(params[str(i)], a)
        if len(self.output_nodes) == 1:
            return activities[self.output_nodes[0].uid]
        return Table(*[activities[o.uid] for o in self.output_nodes])


def Model(inputs, outputs, device=None) -> Graph:
    """pyspark-parity factory (pyspark/bigdl/nn/layer.py Model)."""
    return Graph(inputs, outputs, device=device)

"""Conversions between `Edge` lists and NetworkX graphs (carried over from
mac_tpu.utils.conversions). networkx is imported where a graph is built,
so that importing the package does not load it."""

from typing import List

from mac_tpu_torch.utils.graphs import Edge


def nx_to_mac(G: "networkx.Graph") -> List[Edge]:
    """Edge list of `G`, endpoints ordered so that i < j, weight 1 where
    the edge has none."""
    edges = []
    for i, j in G.edges():
        weight = G.get_edge_data(i, j).get("weight", 1.0)
        edges.append(Edge(i, j, weight) if i < j else Edge(j, i, weight))
    return edges


def mac_to_nx(edges: List[Edge]) -> "networkx.Graph":
    """NetworkX graph with `weight` attributes from a list of edges."""
    import networkx as nx

    G = nx.Graph()
    for e in edges:
        if e.i < e.j:
            G.add_edge(e.i, e.j, weight=e.weight)
        else:
            G.add_edge(e.j, e.i, weight=e.weight)
    return G

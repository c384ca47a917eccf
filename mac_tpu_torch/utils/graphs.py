"""Graph types and host Laplacian builders (numpy and scipy only; carried
over from mac_tpu.utils.graphs)."""

from collections import namedtuple
from typing import List, Tuple, Union

import numpy as np
from scipy.sparse import coo_matrix, csr_matrix

# Edge container: endpoints i, j and a positive weight.
Edge = namedtuple("Edge", ["i", "j", "weight"])


def edges_to_arrays(
    edges: List[Edge], dtype=np.float64
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a list of `Edge` into an (m, 2) int32 index array and an (m,)
    weight array. Accepts an existing (idx, w) pair and passes it through.
    """
    if isinstance(edges, tuple) and len(edges) == 2:
        idx, w = edges
        return (np.asarray(idx, dtype=np.int32).reshape(-1, 2),
                np.asarray(w, dtype=dtype))
    m = len(edges)
    idx = np.zeros((m, 2), dtype=np.int32)
    w = np.zeros((m,), dtype=dtype)
    for t, e in enumerate(edges):
        idx[t, 0] = int(e[0])
        idx[t, 1] = int(e[1])
        w[t] = float(e[2]) if len(e) > 2 else 1.0
    return idx, w


def arrays_to_edges(idx: np.ndarray, w: np.ndarray) -> List[Edge]:
    """Unpack (m, 2) indices and (m,) weights into a list of `Edge`."""
    return [Edge(int(i), int(j), float(wt))
            for (i, j), wt in zip(np.asarray(idx), np.asarray(w))]


def laplacian_coo_triplets(
    idx: np.ndarray, w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triplets of sum_e w_e (e_i - e_j)(e_i - e_j)^T."""
    i, j = idx[:, 0], idx[:, 1]
    rows = np.concatenate([i, j, i, j])
    cols = np.concatenate([i, j, j, i])
    data = np.concatenate([w, w, -w, -w])
    return rows, cols, data


def weight_graph_lap_from_edge_list(edges: List[Edge],
                                    num_nodes: int) -> csr_matrix:
    """Weighted graph Laplacian (scipy CSR) of a list of edges."""
    idx, w = edges_to_arrays(edges)
    rows, cols, data = laplacian_coo_triplets(idx, w)
    return csr_matrix(coo_matrix((data, (rows, cols)),
                                 shape=(num_nodes, num_nodes)))


def weight_reduced_graph_lap_from_edge_list(edges: List[Edge],
                                            num_nodes: int) -> csr_matrix:
    """The weighted Laplacian with node 0 pinned (row and column 0
    removed)."""
    return weight_graph_lap_from_edge_list(edges, num_nodes)[1:, 1:]


def weight_graph_lap_from_edges(
    edges: np.ndarray, weights: np.ndarray, num_nodes: int
) -> csr_matrix:
    """Weighted Laplacian (scipy CSR) from an (m, 2) index array and (m,)
    weights."""
    idx = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    w = np.asarray(weights, dtype=np.float64)
    if idx.shape[0] != w.shape[0]:
        raise ValueError(f"{idx.shape[0]} edges but {w.shape[0]} weights")
    rows, cols, data = laplacian_coo_triplets(idx, w)
    return csr_matrix(coo_matrix((data, (rows, cols)),
                                 shape=(num_nodes, num_nodes)))


def select_edges(edges: List[Edge], w: np.ndarray) -> List[Edge]:
    """The edges whose entry in the binary mask `w` equals one."""
    w = np.asarray(w)
    if len(edges) != len(w):
        raise ValueError(f"selection mask length {len(w)} does not match "
                         f"the number of edges {len(edges)}")
    return [e for i, e in enumerate(edges) if w[i] == 1.0]


def get_incidence_vector(eij: Union[Edge, Tuple[int, int]],
                         num_nodes: int) -> np.ndarray:
    """Incidence vector a_uv of the edge (u, v): +1 at u, -1 at v."""
    a = np.zeros(num_nodes)
    a[eij[0]] = 1.0
    a[eij[1]] = -1.0
    return a


def set_incidence_vector_for_edge_inplace(
        auv_vec: np.ndarray, edge: Union[Edge, Tuple[int, int]],
        num_nodes: int) -> None:
    """Fill `auv_vec` (length num_nodes - 1) with the reduced incidence
    vector of `edge`: node 0 is pinned, so indices shift by -1 and an
    endpoint at node 0 is dropped."""
    if len(auv_vec) != num_nodes - 1:
        raise ValueError(f"auv_vec has length {len(auv_vec)}, want "
                         f"{num_nodes - 1}")
    auv_vec.fill(0)
    i = edge[0] - 1
    j = edge[1] - 1
    if i >= 0:
        auv_vec[i] = 1.0
    if j >= 0:
        auv_vec[j] = -1.0


def get_edge_selection_as_binary_mask(edges: List[Edge],
                                      selected_edges: List[Edge]) -> np.ndarray:
    """Binary mask over `edges` marking membership in `selected_edges`."""
    if len(edges) < len(selected_edges):
        raise ValueError("The number of selected edges cannot be greater "
                         "than the total number of edges.")
    selected = set(selected_edges)
    mask = np.zeros(len(edges))
    for i, e in enumerate(edges):
        if e in selected:
            mask[i] = 1.0
    return mask

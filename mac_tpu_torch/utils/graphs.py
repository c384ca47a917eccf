"""Graph types and host Laplacian builders (numpy and scipy only; carried
over from mac_tpu.utils.graphs)."""

from collections import namedtuple
from typing import List, Tuple

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


def laplacian_coo_triplets(
    idx: np.ndarray, w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO triplets of sum_e w_e (e_i - e_j)(e_i - e_j)^T."""
    i, j = idx[:, 0], idx[:, 1]
    rows = np.concatenate([i, j, i, j])
    cols = np.concatenate([i, j, j, i])
    data = np.concatenate([w, w, -w, -w])
    return rows, cols, data


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

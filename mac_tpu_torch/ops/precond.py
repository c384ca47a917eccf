"""Preconditioner inputs for Laplacian eigensolves.

PyTorch counterpart of mac_tpu.ops.precond; this slice carries only the
odometry-chain detection that picks the eigensolver's preconditioner rule.
The chain preconditioners themselves (make_chain_precond and its pinned
and Jacobi siblings) are not ported yet.
"""

from typing import Optional

import numpy as np


def extract_chain_weights(fixed_idx: np.ndarray, fixed_w: np.ndarray,
                          num_nodes: int) -> Optional[np.ndarray]:
    """If the fixed edges contain the whole path 0-1-...-(n-1) (the
    odometry chain of a pose graph), the (n-1,) per-slot chain weights
    (parallel chain edges summed), else None."""
    fixed_idx = np.asarray(fixed_idx)
    fixed_w = np.asarray(fixed_w)
    if num_nodes < 2 or fixed_idx.shape[0] == 0:
        return None
    lo = fixed_idx.min(axis=1)
    hi = fixed_idx.max(axis=1)
    is_chain_edge = hi - lo == 1
    slot_w = np.zeros(num_nodes - 1, dtype=np.float64)
    np.add.at(slot_w, lo[is_chain_edge], fixed_w[is_chain_edge])
    if (slot_w <= 0.0).any():
        return None
    return slot_w

"""Preconditioners for Laplacian eigensolves and CG (PyTorch counterpart of
mac_tpu.ops.precond).

  * odometry-chain detection, which picks the eigensolver's preconditioner
    rule (extract_chain_weights);
  * the exact path-graph solves by two cumulative sums, on 1^perp
    (make_chain_precond) and with node 0 pinned (make_chain_precond_pinned);
  * diagonal scaling (make_jacobi_precond) and the identity.

Each preconditioner is a function (n, q) -> (n, q). Nothing on the solve
paths uses the last four; they are public helpers.
"""

from typing import Callable, Optional

import numpy as np
import torch


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


def make_chain_precond(chain_w: torch.Tensor) -> Callable:
    """Exact pseudo-inverse of the path-graph Laplacian with the (n-1,)
    positive edge weights chain_w: flows phi_i = -cumsum(P b)_i on edge
    (i, i+1) (P the projection onto 1^perp), potentials
    y_{i+1} = y_i + phi_i / w_i, then y centred."""
    inv_w = 1.0 / chain_w

    def apply(B: torch.Tensor) -> torch.Tensor:
        Bp = B - B.mean(dim=0, keepdim=True)
        incr = -torch.cumsum(Bp[:-1], dim=0) * inv_w[:, None]
        y = torch.cat([B.new_zeros((1, B.shape[1])),
                       torch.cumsum(incr, dim=0)])
        return y - y.mean(dim=0, keepdim=True)

    return apply


def make_chain_precond_pinned(chain_w: torch.Tensor) -> Callable:
    """Exact solve of the path-graph Laplacian with node 0 pinned (the
    reduced systems of GreedyESP): phi_i = sum_{j > i} b_j, then
    y_{i+1} = y_i + phi_i / w_i. Row 0 of the input is ignored and row 0
    of the output is zero."""
    inv_w = 1.0 / chain_w

    def apply(B: torch.Tensor) -> torch.Tensor:
        b = torch.cat([B.new_zeros((1, B.shape[1])), B[1:]])
        rev = torch.cumsum(b.flip(0), dim=0).flip(0)  # rev[i] = sum_{j>=i} b_j
        incr = rev[1:] * inv_w[:, None]
        return torch.cat([B.new_zeros((1, B.shape[1])),
                          torch.cumsum(incr, dim=0)])

    return apply


def make_jacobi_precond(deg: torch.Tensor, eps: float = 1e-12) -> Callable:
    """Diagonal (weighted-degree) scaling."""
    inv = 1.0 / torch.clamp(deg, min=eps)

    def apply(B: torch.Tensor) -> torch.Tensor:
        return inv[:, None] * B

    return apply


def identity_precond(B: torch.Tensor) -> torch.Tensor:
    return B

"""Closed-form LP oracles for Frank-Wolfe direction finding (PyTorch
counterpart of mac_tpu.optimization.constraints)."""

import torch


def solve_subset_box_lp(g: torch.Tensor, k: int) -> torch.Tensor:
    """max <g, x> s.t. 0 <= x <= 1, ||x||_0 <= k: the indicator of the top-k
    entries of g. Ties go to the lower index, as jax.lax.top_k breaks them:
    a stable descending sort."""
    m = g.shape[0]
    k = int(k)
    if k <= 0:
        return torch.zeros_like(g)
    if k >= m:
        return torch.ones_like(g)
    idx = torch.sort(g, descending=True, stable=True).indices[:k]
    out = torch.zeros_like(g)
    out[idx] = 1.0
    return out


def solve_box_lp(g: torch.Tensor) -> torch.Tensor:
    """max <g, x> s.t. 0 <= x <= 1: the indicator of the positive entries."""
    return (g > 0.0).to(g.dtype)

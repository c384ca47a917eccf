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


def solve_subset_box_lp_dynamic(g: torch.Tensor,
                                k: torch.Tensor) -> torch.Tensor:
    """solve_subset_box_lp for R budget lanes at once: g (R, m), k (R,)
    integer budgets (any k; k <= 0 selects nothing, k >= m everything).
    Lane r's indicator of the top-k[r] entries of g[r], by rank: one stable
    descending sort ranks every lane (ties to the lower index, as the JAX
    package's stable argsort(-g) breaks them) and ranks below k are set."""
    order = torch.sort(g, dim=-1, descending=True, stable=True).indices
    ranks = torch.arange(g.shape[-1], device=g.device)
    sel = (ranks[None, :] < k.to(g.device)[:, None]).to(g.dtype)
    return torch.zeros_like(g).scatter_(-1, order, sel)


def solve_box_lp(g: torch.Tensor) -> torch.Tensor:
    """max <g, x> s.t. 0 <= x <= 1: the indicator of the positive entries."""
    return (g > 0.0).to(g.dtype)

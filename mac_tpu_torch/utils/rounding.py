"""Rounding of relaxed solutions onto the binary constraint set (PyTorch
counterpart of mac_tpu.utils.rounding.round_nearest)."""

from typing import Optional

import torch


def round_nearest(w: torch.Tensor, k: int, weights=None,
                  break_ties_decimal_tol: Optional[int] = None
                  ) -> torch.Tensor:
    """Round w in [0, 1]^m with |w| ~= k to the indicator of its top-k
    entries.

    With `weights` and `break_ties_decimal_tol`, w is truncated to that many
    decimals and ties go to the larger original edge weight: the ascending
    lexicographic order (w_trunc, weight) of jnp.lexsort, built from two
    stable sorts, and the last k ranks are taken. Without them, ties go to
    the lower index, as jax.lax.top_k breaks them.
    """
    m = w.shape[0]
    k = int(k)
    if k <= 0:
        return torch.zeros_like(w)
    if k >= m:
        return torch.ones_like(w)
    out = torch.zeros_like(w)
    if weights is None or break_ties_decimal_tol is None:
        out[torch.sort(w, descending=True, stable=True).indices[:k]] = 1.0
        return out
    scale = 10.0 ** int(break_ties_decimal_tol)
    w_trunc = torch.round(w * scale) / scale
    weights = torch.as_tensor(weights, dtype=w.dtype, device=w.device)
    order = torch.sort(weights, stable=True).indices
    order = order[torch.sort(w_trunc[order], stable=True).indices]
    out[order[m - k:]] = 1.0
    return out

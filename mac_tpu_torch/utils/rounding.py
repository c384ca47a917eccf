"""Rounding of relaxed solutions onto the binary constraint set (PyTorch
counterpart of mac_tpu.utils.rounding).

  * round_nearest / round_nearest_np: top-k selection, ties optionally
    broken towards the larger original edge weight (tensor and numpy forms).
  * round_madow_base / round_madow: Madow (systematic) sampling from one
    cumulative sum and closed-form interval counting; best of R trials
    through a batched value function.
  * round_random: independent Bernoulli rounding.
  * round_nearest_dynamic / round_madow_base_dynamic: the two roundings of
    MAC.solve_sweep, for R budget lanes at once.

Randomness is an explicit torch.Generator (or an injected offset `u`), never
global state.
"""

from typing import Callable, Optional

import numpy as np
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


def round_nearest_np(w, k: int, weights=None,
                     break_ties_decimal_tol: Optional[int] = None
                     ) -> np.ndarray:
    """round_nearest in numpy, for the host engine and the host tails: the
    same truncation and the same stable ascending lexsort with the original
    edge weight as the secondary key, with no tensor in between."""
    w = np.asarray(w)
    m = w.shape[0]
    k = int(k)
    if k <= 0:
        return np.zeros_like(w)
    if k >= m:
        return np.ones_like(w)
    out = np.zeros_like(w)
    if weights is None or break_ties_decimal_tol is None:
        out[np.argpartition(w, m - k)[m - k:]] = 1.0
        return out
    scale = 10.0 ** int(break_ties_decimal_tol)
    w_trunc = np.round(w * scale) / scale
    order = np.lexsort((np.asarray(weights, dtype=w.dtype), w_trunc))
    out[order[m - k:]] = 1.0
    return out


def round_nearest_dynamic(w: torch.Tensor, k: torch.Tensor, weights=None,
                          decimal_tol: int = 10) -> torch.Tensor:
    """round_nearest of R lanes w (R, m) with budgets k (R,), always with
    the lexicographic tie-break: ascending (w truncated to decimal_tol
    decimals, then the original edge weight, or 0 without `weights`), two
    stable sorts as jnp.lexsort orders them, and the last k[r] ranks of lane
    r taken (k <= 0 selects nothing, k >= m everything)."""
    m = w.shape[-1]
    scale = 10.0 ** int(decimal_tol)
    w_trunc = torch.round(w * scale) / scale
    if weights is None:
        order = torch.arange(m, device=w.device).expand_as(w)
    else:
        tie = torch.as_tensor(weights, dtype=w.dtype, device=w.device)
        order = torch.sort(tie, stable=True).indices.expand_as(w)
    order = order.gather(-1, torch.sort(w_trunc.gather(-1, order), dim=-1,
                                        stable=True).indices)
    ranks = torch.arange(m, device=w.device)
    sel = (ranks[None, :] >= m - k.to(w.device)[:, None]).to(w.dtype)
    return torch.zeros_like(w).scatter_(-1, order, sel)


def round_madow_base_dynamic(w: torch.Tensor, k: torch.Tensor,
                             u: torch.Tensor) -> torch.Tensor:
    """round_madow_base of R lanes w (R, m) with budgets k (R,) and offsets
    u (R,) in [0, 1): each lane's cumulative weight line renormalised to
    exactly k[r] (a zero total guarded by the dtype's tiny), its k[r]
    systematic points u[r] + t. The JAX package draws u[r] from the lane's
    PRNG key; here it is given."""
    kf = k.to(device=w.device, dtype=w.dtype)[:, None]
    total = w.sum(dim=-1, keepdim=True)
    wn = w * (kf / torch.clamp(total, min=torch.finfo(w.dtype).tiny))
    sumw = torch.cumsum(wn, dim=-1)
    sumw[:, -1] = kf[:, 0]
    pi = torch.cat([sumw.new_zeros((w.shape[0], 1)), sumw[:, :-1]], dim=-1)
    u = torch.as_tensor(u, dtype=w.dtype).to(w.device)[:, None]
    x = torch.floor(sumw - u) - torch.floor(pi - u)
    return torch.clamp(x, 0.0, 1.0)


def _uniform(generator: Optional[torch.Generator], shape, dtype) -> torch.Tensor:
    """U[0, 1) of `shape` on the CPU from `generator` (seed 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand(shape, generator=generator, dtype=dtype)


def round_random(w: torch.Tensor, k: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Independent Bernoulli rounding: E[#selected] = |w| (k is unused, as
    in the reference)."""
    w = torch.as_tensor(w)
    r = _uniform(generator, w.shape, w.dtype).to(w.device)
    return (w > r).to(w.dtype)


def round_madow_base(w: torch.Tensor, k: int,
                     generator: Optional[torch.Generator] = None,
                     u=None) -> torch.Tensor:
    """Madow systematic sampling: exactly k items, with inclusion
    probabilities proportional to w.

    Item i covers the interval [pi_i, pi_i + w_i) of the cumulative weight
    line (the total renormalised to exactly k) and is selected iff the
    interval holds some u + t, t = 0..k-1. Each interval is at most 1 long,
    so that is floor(cumsum_i - u) - floor(pi_i - u), in {0, 1}; exactly k
    are selected by construction. `u` in [0, 1) is drawn from `generator`
    unless given.
    """
    w = torch.as_tensor(w)
    k = int(k)
    if k <= 0:
        return torch.zeros_like(w)
    if u is None:
        u = _uniform(generator, (), w.dtype)
    u = torch.as_tensor(u, dtype=w.dtype).to(w.device)
    wn = w * (k / w.sum())
    sumw = torch.cumsum(wn, dim=0)
    sumw[-1] = float(k)  # exact endpoint against rounding drift
    pi = torch.cat([sumw.new_zeros(1), sumw[:-1]])
    x = torch.floor(sumw - u) - torch.floor(pi - u)
    return torch.clamp(x, 0.0, 1.0)


def round_madow(w: torch.Tensor, k: int,
                generator: Optional[torch.Generator] = None,
                value_fn: Optional[Callable] = None,
                max_iters: int = 1, u=None) -> torch.Tensor:
    """Best of `max_iters` Madow roundings: value_fn takes the (R, m) batch
    of trials and returns their (R,) values. `u` may hold the R offsets."""
    if value_fn is None or max_iters == 1:
        return round_madow_base(w, k, generator, u=u)
    w = torch.as_tensor(w)
    if u is None:
        u = _uniform(generator, (int(max_iters),), w.dtype)
    xs = torch.stack([round_madow_base(w, k, u=ui) for ui in u])
    vals = torch.as_tensor(value_fn(xs))
    return xs[int(torch.argmax(vals))]

"""Fiedler-pair front end on the banded operator (PyTorch counterpart of the
banded branch of mac_tpu.utils.fiedler.fiedler_pair_op), the deterministic
start block, and the float64 scipy referee."""

from typing import Optional

import numpy as np
import torch

from mac_tpu_torch.ops import banded as _banded
from mac_tpu_torch.ops.lobpcg import tracemin_fiedler

_DEFAULT_SEED = 7  # the reference's np.random.RandomState(7) start block


def scipy_lam2(L) -> float:
    """Float64 lambda_2 of a host Laplacian by shift-invert Lanczos: the
    quality referee, independent of the port's own eigensolver."""
    import scipy.sparse.linalg as spla

    vals = spla.eigsh(L.astype(np.float64), k=2, sigma=-1e-9, which="LM",
                      return_eigenvectors=False)
    return float(np.sort(vals)[-1])


def default_block(n: int, q: Optional[int] = None, seed: Optional[int] = None,
                  dtype=None) -> np.ndarray:
    """Deterministic start block: q = min(4, n-1) columns of N(0, 1) from
    numpy's RandomState(7)."""
    if q is None:
        q = min(4, n - 1)
    rs = np.random.RandomState(_DEFAULT_SEED if seed is None else seed)
    X = np.asarray(rs.normal(size=(q, n))).T
    if dtype is not None:
        X = X.astype(dtype)
    return X


def fiedler_pair_op(
    bop: "_banded.BandedOperator",
    w: torch.Tensor,
    X: torch.Tensor,
    *,
    xprev0: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 200,
    inner_iters: int = 16,
    rel_tol: Optional[float] = None,
    coeff_dtype=None,
    pstate: Optional["_banded.PrecondState"] = None,
    use_prev: Optional[bool] = None,
    rebuild: Optional[bool] = None,
    return_pstate: bool = False,
):
    """Fiedler pair of L(w) on the banded operator: assemble BD(w), build the
    two-level preconditioner (warm-rebuilt from `pstate` when given), run
    TRACEMIN. Returns FiedlerResult, or (FiedlerResult, PrecondState) with
    return_pstate=True."""
    BD = _banded.assemble_bd(bop, w)

    def apply_L(V):
        return _banded.banded_apply(bop, BD, V)

    # ||L||_inf = 2 max weighted degree, read off BD's diagonal.
    lnorm = 2.0 * BD.deg.max()
    pstate_out = None
    if pstate is not None or return_pstate:
        Minv, pstate_out = _banded.make_banded_precond(
            bop, BD, w=w, prev_state=pstate, use_prev=use_prev,
            rebuild=rebuild, return_state=True)
    else:
        Minv = _banded.make_banded_precond(bop, BD, w=w)
    res = tracemin_fiedler(
        apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol, maxiter=maxiter,
        inner_iters=inner_iters, rel_tol=rel_tol, coeff_dtype=coeff_dtype)
    return (res, pstate_out) if return_pstate else res

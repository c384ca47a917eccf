"""Fiedler-pair front end (PyTorch counterpart of
mac_tpu.utils.fiedler.fiedler_pair_op) on the banded operator or on a
matrix-free GraphOperator, the deterministic start block, and the float64
scipy referee."""

from typing import Optional

import numpy as np
import torch

from mac_tpu_torch.ops import banded as _banded
from mac_tpu_torch.ops.cg import pcg_fixed
from mac_tpu_torch.ops.laplacian import (DENSE_MAX_N, GraphOperator,
                                         lap_applier, lap_dense,
                                         lap_inf_norm, lap_tridiagonal_part)
from mac_tpu_torch.ops.lobpcg import (_shift_term, dense_fiedler,
                                      lobpcg_fiedler, tracemin_fiedler)
from mac_tpu_torch.ops.tridiag import (tridiag_ldl_auto,
                                       tridiag_solve_factored_fast)
from mac_tpu_torch.ops.twogrid import make_twogrid_precond

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


def _banded_pair(bop, w, X, *, xprev0, tol, maxiter, inner_iters, rel_tol,
                 coeff_dtype, pstate, use_prev, rebuild, return_pstate):
    """The banded branch: assemble BD(w), build the two-level
    preconditioner (warm-rebuilt from `pstate` when given), run TRACEMIN."""
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


def fiedler_pair_op(
    op,
    w: torch.Tensor,
    X: torch.Tensor,
    *,
    xprev0: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 200,
    inner_iters: int = 16,
    rel_tol: Optional[float] = None,
    method: str = "tracemin",
    precond: str = "twogrid",
    coeff_dtype=None,
    pstate: Optional["_banded.PrecondState"] = None,
    use_prev: Optional[bool] = None,
    rebuild: Optional[bool] = None,
    return_pstate: bool = False,
):
    """Fiedler pair of L(w), X the (n, q) start block and xprev0 the block
    that seeds the eigensolver's previous-iterate memory.

    op: a BandedOperator (TRACEMIN with the banded two-level
        preconditioner; pstate / use_prev / rebuild carry its coarse
        inverse across calls) or a GraphOperator, which takes:
      * the exact dense eigh for method="dense" or a dense-mode operator of
        at most DENSE_MAX_N nodes;
      * otherwise the ELL (or dense-mode) product, the preconditioner
        `precond` -- "twogrid" (the V-cycle) or "tridiag" (the tridiagonal
        part's LDL^T solve alone, on 1^perp) -- and TRACEMIN, or LOBPCG for
        method="lobpcg" (its preconditioner is `inner_iters` PCG steps on
        the shifted operator).
    Returns FiedlerResult, or (FiedlerResult, PrecondState or None) with
    return_pstate=True.
    """
    if isinstance(op, _banded.BandedOperator):
        return _banded_pair(
            op, w, X, xprev0=xprev0, tol=tol, maxiter=maxiter,
            inner_iters=inner_iters, rel_tol=rel_tol, coeff_dtype=coeff_dtype,
            pstate=pstate, use_prev=use_prev, rebuild=rebuild,
            return_pstate=return_pstate)
    if not isinstance(op, GraphOperator):
        raise TypeError(f"fiedler_pair_op: unknown operator {type(op)}")

    def _ret(res):
        # An incoming PrecondState passes through untouched.
        return (res, pstate) if return_pstate else res

    if method == "dense" or (op.mode == "dense"
                             and op.n <= DENSE_MAX_N):
        return _ret(dense_fiedler(lap_dense(op, w), X.shape[1]))

    apply_L = lap_applier(op, w)
    lnorm = lap_inf_norm(op, w)
    if precond == "twogrid":
        Minv = make_twogrid_precond(op, w, apply_L)
    else:
        d, e = lap_tridiagonal_part(op, w)
        eps = 100 * torch.finfo(w.dtype).eps
        fac = tridiag_ldl_auto(d + eps * d.max(), e)

        def center(B):
            return B - B.mean(dim=0, keepdim=True)

        def Minv(B):
            # On 1^perp, so the shifted constant mode is never amplified.
            return center(tridiag_solve_factored_fast(fac, center(B)))

    if method == "lobpcg":
        def apply_shifted(V):
            return apply_L(V) + _shift_term(V, lnorm)

        def pc(R):
            return pcg_fixed(apply_shifted, R, Minv, iters=inner_iters)

        return _ret(lobpcg_fiedler(apply_L, X, lnorm, xprev0=xprev0,
                                   precond=pc, tol=tol, maxiter=maxiter))
    return _ret(tracemin_fiedler(
        apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol, maxiter=maxiter,
        inner_iters=inner_iters, rel_tol=rel_tol, coeff_dtype=coeff_dtype))

"""Host TRACEMIN Fiedler engine in numpy and scipy (counterpart of
mac_tpu.ops.host_tracemin; the port's own copy, since that module lives in
the JAX package).

The engine of the small and the float64-escalated instances (the bundled
intel, kitti and ais2klinik graphs) and of the exact float64 tails of the
banded float32 route (polish, round guard). The same TRACEMIN structure as
the device engine (mac_tpu_torch.ops.lobpcg), with the inner solve done
exactly by one scipy `splu` factorisation per weight vector: on these
near-chain graphs a sparse direct factor has next to no fill, while an
iterative solve spends its time on per-operation latency.

The constant nullspace is removed by grounding node 0: for b with
1^T b = 0, the solution of L y = b with y[0] = 0 satisfies the reduced
system L[1:, 1:] y[1:] = b[1:], which is SPD and factors by plain sparse
LU. Search blocks are kept centred (1^perp), so the Ritz values are the
non-zero spectrum. This module stays on the host by design: the sparse LU
is its point.
"""

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def host_tracemin_fiedler(
    L,
    X0: np.ndarray,
    tol: float = 1e-8,
    maxiter: int = 60,
    rel_tol: float = 1e-8,
    lu=None,
    solve_fn=None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fiedler pair of the Laplacian L (host, float64) with a q-wide Ritz
    block.

    L: scipy sparse (n, n) Laplacian. X0: (n, q) start block (warm starts
    welcome). lu: a splu factor of L[1:, 1:] computed before (reused across
    calls with the same weights). solve_fn: replaces the grounded inner
    solve; called as solve_fn(B) with B = X[1:], it returns (an
    approximation of) L[1:, 1:]^-1 B. The Frank-Wolfe host loop passes a
    CG solve of the current operator preconditioned by a stale factor.
    Returns (lam (q,), X (n, q), outer iterations). Only the leading pair
    (lam[0], X[:, 0]) is converged in the residual; the trailing Ritz pairs
    are warm-start state for the next call.

    Converged when ||L x_1 - lam_1 x_1||_1 / ||L||_inf < tol with a sane
    relative residual (< 2), or when the eigenvalue-relative residual
    ||r||_2 / lam_1 < rel_tol (scale invariant: on a tiny-gap graph
    lam_2 / ||L|| underflows the first test while the pair is still poor).
    """
    X = np.array(X0, dtype=np.float64, copy=True)
    q = X.shape[1]
    L = L.tocsr()
    lnorm = float(np.abs(L).sum(axis=1).max())
    if solve_fn is None:
        if lu is None:
            lu = splu_reduced(L)
        solve_fn = lu.solve

    def center(B):
        return B - B.mean(axis=0, keepdims=True)

    X = np.linalg.qr(center(X))[0]
    lam = np.zeros(q)
    it = 0
    converged = False
    for it in range(1, maxiter + 1):
        W = L @ X
        H = X.T @ W
        evals, Y = np.linalg.eigh((H + H.T) / 2)
        lam = evals[:q]
        X = X @ Y[:, :q]
        W = W @ Y[:, :q]
        r = W[:, 0] - lam[0] * X[:, 0]
        legacy = np.abs(r).sum() / lnorm
        rres = np.linalg.norm(r) / max(lam[0], 1e-300)
        if (legacy < tol and rres < 2.0) or rres < rel_tol:
            converged = True
            break
        # Exact inverse iteration on the grounded system; centre again to
        # stay in 1^perp and orthonormalise.
        Y = np.zeros_like(X)
        Y[1:] = solve_fn(X[1:])
        X = np.linalg.qr(center(Y))[0]
    if not converged:
        # Budget spent mid-cycle: one Rayleigh-Ritz pass so the block comes
        # back Ritz-ordered (callers warm-start from it).
        W = L @ X
        H = X.T @ W
        evals, Y = np.linalg.eigh((H + H.T) / 2)
        lam = evals[:q]
        X = X @ Y[:, :q]
    return lam, X, it


def splu_reduced(L):
    """splu factor of the grounded (node 0 removed) Laplacian.

    Explicit zeros are eliminated first: the Frank-Wolfe host loop hands in
    fixed-pattern Laplacians (solvers._host._IncrementalHostLap) whose
    unselected candidate slots are stored zeros, and SuperLU takes those as
    fill-producing non-zeros in its ordering and its factorisation. The
    [1:, 1:] slice copies, so the caller's shared pattern arrays are never
    changed."""
    Lred = sp.csc_matrix(L.tocsr()[1:, 1:])
    Lred.eliminate_zeros()
    return spla.splu(Lred)


def block_pcg(A, B, M_solve, tol: float = 1e-10, maxiter: int = 60):
    """Preconditioned CG with several right-hand sides on the SPD grounded
    Laplacian: solves A Y = B for (n-1, q) B, the columns sharing products
    but stepping and converging on their own. M_solve(R) applies the
    preconditioner (in the host loop, a splu factor one Frank-Wolfe step
    old). The operator is the current A, only the solve is iterative, to a
    relative residual `tol` per column. Returns (Y, iterations, converged).
    """
    B = np.asarray(B, np.float64)
    Y = np.zeros_like(B)
    R = B.copy()
    bnorm = np.linalg.norm(B, axis=0)
    bnorm = np.where(bnorm > 0, bnorm, 1.0)
    Z = M_solve(R)
    P = Z.copy()
    rz = np.einsum("ij,ij->j", R, Z)
    it = 0
    for it in range(1, maxiter + 1):
        AP = A @ P
        pAp = np.einsum("ij,ij->j", P, AP)
        alpha = np.where(pAp > 0, rz / np.where(pAp > 0, pAp, 1.0), 0.0)
        Y += alpha * P
        R -= alpha * AP
        if np.all(np.linalg.norm(R, axis=0) <= tol * bnorm):
            return Y, it, True
        Z = M_solve(R)
        rz_new = np.einsum("ij,ij->j", R, Z)
        beta = rz_new / np.where(rz > 0, rz, 1.0)
        P = Z + beta * P
        rz = rz_new
    return Y, it, False

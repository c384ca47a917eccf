"""TRACEMIN: preconditioned block inverse iteration for the Fiedler pair.

PyTorch counterpart of mac_tpu.ops.lobpcg.tracemin_fiedler. The smallest
eigenpairs of the rank-one-corrected operator A' = L + (c / n) 1 1^T
(c = ||L||_inf moves the constant mode's eigenvalue from 0 to c) are found
by inverse iteration: each outer iteration runs a fixed number of
preconditioned CG steps toward A'^-1 X, then Rayleigh-Ritz on
span[X, Y, X_prev]. Every Ritz value is >= lambda_2(L).

The loop is Python control flow; its stop test is read from the device
once per outer iteration. The random block X_prev that seeds the first
basis is an explicit argument: the reference draws it from
jax.random.normal(PRNGKey(7)), which torch cannot reproduce.
"""

from typing import Callable, NamedTuple, Optional

import torch

from mac_tpu_torch.ops.cg import pcg_fixed


# Stop after this many outer iterations without a STALL_FACTOR improvement
# of the residual near the precision floor.
STALL_PATIENCE = 5
STALL_FACTOR = 0.99


class FiedlerResult(NamedTuple):
    lam: torch.Tensor  # (q,) Ritz values, lam[0] = lambda_2(L)
    X: torch.Tensor    # (n, q) Ritz vectors, X[:, 0] = Fiedler vector
    iters: int         # outer iterations used
    res: torch.Tensor  # () final residual (reference criterion)


def _colnorm(S: torch.Tensor) -> torch.Tensor:
    """Scale columns to unit norm; the norm floor is relative to the largest
    column so converged (noise-level) columns stay ~0 instead of
    overflowing."""
    nrm = torch.linalg.vector_norm(S, dim=0, keepdim=True)
    floor = torch.finfo(S.dtype).eps * torch.clamp(nrm.max(), min=1.0)
    return S / torch.maximum(nrm, floor)


def _hi(x: torch.Tensor) -> torch.Tensor:
    """Upcast to float64 for coefficient-level algebra."""
    return x.double()


def _gram(A: torch.Tensor, B: torch.Tensor, coeff_dtype) -> torch.Tensor:
    """A^T B at coefficient precision: float64, or full float32."""
    if coeff_dtype == torch.float64:
        return _hi(A).T @ _hi(B)
    return A.T @ B


def cholesky_upper(A: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor, NaN where A is not positive definite (as
    jnp.linalg.cholesky returns; later finiteness checks read it), without
    the host synchronisation of an error check."""
    R, info = torch.linalg.cholesky_ex(A, upper=True)
    return torch.where(info == 0, R, torch.full_like(R, float("nan")))


def _cholqr(S: torch.Tensor, coeff_dtype=torch.float64) -> torch.Tensor:
    """One CholeskyQR pass Q = S chol(S^T S + jitter)^-1, coefficients at
    coeff_dtype; the jitter keeps rank-deficient bases finite."""
    G = _gram(S, S, coeff_dtype)
    k = G.shape[0]
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    jitter = k * torch.finfo(S.dtype).eps * (torch.trace(G) + 1.0)
    R = cholesky_upper(G + jitter * eye)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return S @ Rinv.to(S.dtype)


def _orth(S: torch.Tensor, coeff_dtype=torch.float64) -> torch.Tensor:
    """Column scaling, then CholeskyQR2."""
    return _cholqr(_cholqr(_colnorm(S), coeff_dtype), coeff_dtype)


def _ortho_against(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Project Y orthogonal to the orthonormal block X by two classical
    Gram-Schmidt passes (CGS2), in the vector space: near convergence Y is
    nearly parallel to X, and a Gram matrix would square that angle."""
    Y = Y - X @ (X.T @ Y)
    Y = Y - X @ (X.T @ Y)
    return Y


def _shift_term(V: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(c / n) 1 1^T V with the column means accumulated in float64 (c can
    exceed lambda_2 by many orders of magnitude)."""
    m64 = V.double().mean(dim=0, keepdim=True)
    return (c.double() * m64).to(V.dtype)


def tracemin_fiedler(
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    lnorm: torch.Tensor,
    Minv: Callable[[torch.Tensor], torch.Tensor],
    *,
    xprev0: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 200,
    inner_iters: int = 16,
    rel_tol: Optional[float] = None,
    coeff_dtype=None,
    lam0: Optional[torch.Tensor] = None,
    warm_init: Optional[bool] = None,
    min_iters: int = 0,
    nullvec: Optional[torch.Tensor] = None,
) -> FiedlerResult:
    """Block inverse (subspace) iteration with Rayleigh-Ritz.

    apply_L: (n, k) -> (n, k) Laplacian product. X0: (n, q) start block.
    lnorm: ||L||_inf (the nullspace shift c). Minv: preconditioner on
    1^perp. xprev0: (n, q) block that seeds the previous-iterate memory
    (LOBPCG's P term) before its first update.

    nullvec: a unit (n,) vector spanning the operator's nullspace when that
    is not the constant vector, e.g. D^(1/2) 1 / ||D^(1/2) 1|| for the
    normalised Laplacian; the shift is then c u (u^T V) and the projection
    V - u (u^T V). None is the constant vector (mean projection).

    lam0 / warm_init: the warm entry. With lam0 (the (q,) Ritz values that
    came with X0) given and warm_init true, X0 is trusted to be the
    Ritz-ordered orthonormal block a previous call returned: it is not
    orthonormalised again, only rotated by one Rayleigh-Ritz pass against
    the current operator. warm_init false (or lam0 None) takes the cold
    entry. min_iters forces that many outer iterations whatever the entry
    residual: a warm block already within rel_tol would otherwise come back
    as it is, the previous operator's eigenvectors.

    Stops when the eigenvalue-relative residual ||A x - lam x|| / lam drops
    to rel_tol (or, with a sane relative residual, the reference criterion
    ||A x - lam x||_1 / ||L||_inf drops to tol), after maxiter outer
    iterations, or after STALL_PATIENCE non-improving iterations near the
    precision floor.
    """
    n, q = X0.shape
    dtype = X0.dtype
    dev = X0.device
    eps = torch.finfo(dtype).eps
    if coeff_dtype is None:
        coeff_dtype = torch.float64
    eff_tol = torch.clamp(torch.tensor(tol, dtype=dtype, device=dev),
                          min=2048 * eps)
    c = lnorm.to(dtype)
    sigma = 32 * eps * c

    if nullvec is None:
        def shift(V):
            return _shift_term(V, c)

        def project(V):
            m64 = V.double().mean(dim=0, keepdim=True)
            return V - m64.to(V.dtype)
    else:
        # Coefficients in float64, like _shift_term's means.
        u64 = nullvec.double()

        def shift(V):
            coef = u64[None, :] @ V.double()  # (1, k)
            return (c.double() * (u64[:, None] * coef)).to(V.dtype)

        def project(V):
            coef = u64[None, :] @ V.double()
            return V - (u64[:, None] * coef).to(V.dtype)

    def apply_shifted(V):
        return apply_L(V) + shift(V)

    def apply_inner(V):
        return apply_shifted(V) + sigma * V

    # Cold entry: orthonormalise, then Rayleigh-Ritz. Warm entry: the
    # Rayleigh-Ritz rotation alone.
    warm = lam0 is not None and bool(warm_init)
    X = X0 if warm else _orth(project(X0), coeff_dtype)
    AX = apply_shifted(X)
    H = _gram(X, AX, coeff_dtype)
    lam, Y0 = torch.linalg.eigh((H + H.T) / 2)
    Y0 = Y0.to(dtype)
    X, AX, lam = X @ Y0, AX @ Y0, lam[:q].to(dtype)
    Xprev = project(xprev0.to(dtype))

    def residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.sum(torch.abs(r)) / lnorm.to(dtype)

    if rel_tol is None:
        rel_tol = 1e-3 if dtype == torch.float32 else 1e-7
    rel_tol_v = torch.tensor(rel_tol, dtype=dtype, device=dev)

    def rel_residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.linalg.vector_norm(r) / torch.maximum(lam[0], sigma)

    it = 0
    res = residual(lam, X, AX)
    best = res
    since = torch.zeros((), dtype=torch.int32, device=dev)
    rres = rel_residual(lam, X, AX)
    while True:
        # The reference-criterion stop counts only when the relative
        # residual is also sane (< 2): on tiny-lambda graphs ||r||_1 /
        # ||L||_inf is below any tolerance while the pair is still garbage.
        legacy_done = (res <= eff_tol) & (rres < 2.0)
        keep = (~legacy_done) & (rres > rel_tol_v) & (since < STALL_PATIENCE)
        if it >= min_iters and (it >= maxiter or not bool(keep)):
            break
        inv_lam = 1.0 / torch.maximum(lam, sigma)
        Y = pcg_fixed(apply_inner, X, Minv, iters=inner_iters,
                      X0=X * inv_lam[None, :])
        Y = project(Y)
        Yp = _colnorm(_ortho_against(X, Y))
        Pp = _colnorm(_ortho_against(X, Xprev))
        S = torch.cat([X, Yp, Pp], dim=1)  # (n, 3q)
        Q = _orth(S, coeff_dtype)
        AQ = apply_shifted(Q)
        H = _gram(Q, AQ, coeff_dtype)
        H = (H + H.T) / 2
        evals, C = torch.linalg.eigh(H)
        Cq = C[:, :q].to(dtype)
        lam_new = evals[:q].to(dtype)
        X_new = Q @ Cq
        AX_new = AQ @ Cq
        res_new = residual(lam_new, X_new, AX_new)
        # Count non-improving iterations only near the precision floor.
        near_floor = res_new < 4 * eff_tol
        improved = res_new < STALL_FACTOR * best
        best = torch.minimum(best, res_new)
        since = torch.where(near_floor & ~improved, since + 1,
                            torch.zeros_like(since))
        rres = rel_residual(lam_new, X_new, AX_new)
        Xprev, X, AX, lam, res = X, X_new, AX_new, lam_new, res_new
        it += 1
    return FiedlerResult(lam=lam, X=X, iters=it, res=res)


# LOBPCG stops after this many outer iterations without a 3% residual
# improvement near its precision floor.
LOBPCG_STALL_PATIENCE = 8


def lobpcg_fiedler(
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    lnorm: torch.Tensor,
    *,
    xprev0: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
) -> FiedlerResult:
    """The q smallest nonzero eigenpairs of a graph Laplacian by LOBPCG
    (mac_tpu.ops.lobpcg.lobpcg_fiedler): Rayleigh-Ritz on span[X, W, P]
    of the shifted operator, W the preconditioned residual and P the
    previous iterate, seeded by `xprev0` (the reference draws it from
    jax.random, which torch cannot reproduce).

    apply_L: (n, k) -> (n, k) Laplacian product. X0: (n, q) start block.
    lnorm: ||L||_inf, also the nullspace shift. precond: approximate inverse
    of L on 1^perp, the identity if None."""
    n, q = X0.shape
    dtype = X0.dtype
    eps = torch.finfo(dtype).eps
    # A 1e-8 residual is out of float32's reach; clamp so the loop stops on
    # convergence rather than maxiter.
    eff_tol = max(float(tol), 32 * eps)
    c = lnorm.to(dtype)

    def apply_shifted(V):
        return apply_L(V) + _shift_term(V, c)

    if precond is None:
        def precond(B):
            return B

    def project(V):
        return V - V.mean(dim=0, keepdim=True)

    X = _orth(project(X0))
    AX = apply_shifted(X)
    H = _hi(X).T @ _hi(AX)
    lam, Y = torch.linalg.eigh((H + H.T) / 2)
    lam, Y = lam.to(dtype), Y.to(dtype)
    X, AX = X @ Y, AX @ Y
    Xprev = project(xprev0.to(dtype))

    def residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.sum(torch.abs(r)) / lnorm.to(dtype)

    it = 0
    res = residual(lam, X, AX)
    best = res
    since = 0
    while it < maxiter and float(res) > eff_tol \
            and since < LOBPCG_STALL_PATIENCE:
        R = AX - X * lam[None, :]
        W = _ortho_against(X, project(precond(R)))
        P = _ortho_against(X, Xprev)
        S = torch.cat([X, _colnorm(W), _colnorm(P)], dim=1)  # (n, 3q)
        Q = _orth(S)
        AQ = apply_shifted(Q)
        H = _hi(Q).T @ _hi(AQ)
        evals, C = torch.linalg.eigh((H + H.T) / 2)
        Cq = C[:, :q].to(dtype)
        lam_new = evals[:q].to(dtype)
        X_new, AX_new = Q @ Cq, AQ @ Cq
        res_new = residual(lam_new, X_new, AX_new)
        near_floor = bool(res_new < 4 * eff_tol)
        improved = bool(res_new < 0.97 * best)
        best = torch.minimum(best, res_new)
        since = since + 1 if near_floor and not improved else 0
        Xprev, X, AX, lam, res = X, X_new, AX_new, lam_new, res_new
        it += 1
    return FiedlerResult(lam=lam, X=X, iters=it, res=res)


def dense_fiedler(L_dense: torch.Tensor, q: int) -> FiedlerResult:
    """Exact Fiedler pair by dense eigh, for tiny graphs (n <= 256) and as
    an oracle: eigenpairs 2..q+1 (the constant mode skipped), padded with
    the top pair when n - 1 < q."""
    n = L_dense.shape[0]
    evals, V = torch.linalg.eigh((L_dense + L_dense.T) / 2)
    hi = min(1 + q, n)
    lam, X = evals[1:hi], V[:, 1:hi]
    pad = q - lam.shape[0]
    if pad > 0:
        lam = torch.cat([lam, evals[-1:].expand(pad)])
        X = torch.cat([X, V[:, -1:].expand(n, pad)], dim=1)
    return FiedlerResult(lam=lam, X=X, iters=0,
                         res=torch.zeros((), dtype=L_dense.dtype,
                                         device=L_dense.device))

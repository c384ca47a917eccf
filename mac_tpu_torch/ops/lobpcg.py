"""TRACEMIN: preconditioned block inverse iteration for the Fiedler pair.

PyTorch counterpart of mac_tpu.ops.lobpcg.tracemin_fiedler. The smallest
eigenpairs of the rank-one-corrected operator A' = L + (c / n) 1 1^T
(c = ||L||_inf moves the constant mode's eigenvalue from 0 to c) are found
by inverse iteration: each outer iteration runs a fixed number of
preconditioned CG steps toward A'^-1 X, then Rayleigh-Ritz on
span[X, Y, X_prev]. Every Ritz value is >= lambda_2(L).

The loop is Python control flow; its stop test is read from the device
once per outer iteration. The random block X_prev that seeds the first
basis is the argument `xprev0`; left out, it is default_xprev's draw from a
torch.Generator seeded with 7 (the reference draws it from
jax.random.normal(PRNGKey(7)), which torch cannot reproduce; the parity
tests pass the JAX block in).
"""

from typing import Callable, NamedTuple, Optional

import torch

from mac_tpu_torch.ops.cg import pcg_fixed
from mac_tpu_torch.ops.kernels import syev as _syev


# Outer iterations at most, and preconditioned CG steps per outer iteration.
TRACEMIN_MAXITER = 200
TRACEMIN_INNER_ITERS = 16
# Stop after this many outer iterations without a STALL_FACTOR improvement
# of the residual near the precision floor.
STALL_PATIENCE = 5
STALL_FACTOR = 0.99
# Seed of the default previous-iterate block (default_xprev).
XPREV_SEED = 7


class FiedlerResult(NamedTuple):
    lam: torch.Tensor  # (q,) Ritz values, lam[0] = lambda_2(L)
    X: torch.Tensor    # (n, q) Ritz vectors, X[:, 0] = Fiedler vector
    iters: int         # outer iterations used
    res: torch.Tensor  # () final residual (reference criterion)


def _colnorm(S: torch.Tensor) -> torch.Tensor:
    """Scale columns to unit norm; the norm floor is relative to the largest
    column so converged (noise-level) columns stay ~0 instead of
    overflowing. S (n, k), or a batch (R, n, k) with a floor per block."""
    nrm = torch.linalg.vector_norm(S, dim=-2, keepdim=True)
    floor = torch.finfo(S.dtype).eps * torch.clamp(
        nrm.amax(dim=-1, keepdim=True), min=1.0)
    return S / torch.maximum(nrm, floor)


def _hi(x: torch.Tensor) -> torch.Tensor:
    """Upcast to float64 for coefficient-level algebra."""
    return x.double()


def _gram(A: torch.Tensor, B: torch.Tensor, coeff_dtype) -> torch.Tensor:
    """A^T B at coefficient precision: float64, or full float32 (of each
    block of a batch)."""
    if coeff_dtype == torch.float64:
        return _hi(A).mT @ _hi(B)
    return A.mT @ B


def batched_trace(A: torch.Tensor) -> torch.Tensor:
    """torch.trace of a matrix, or the trace of each matrix of a batch (a
    diagonal sum, which rounds otherwise than torch.trace, so a single
    matrix keeps torch.trace)."""
    if A.dim() == 2:
        return torch.trace(A)
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(dim=-1)


def cholesky_upper(A: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor, NaN where A is not positive definite (as
    jnp.linalg.cholesky returns; later finiteness checks read it), without
    the host synchronisation of an error check. A may be a batch of
    matrices; each gets its own factor or NaN."""
    R, info = torch.linalg.cholesky_ex(A, upper=True)
    return torch.where((info == 0)[..., None, None], R,
                       torch.full_like(R, float("nan")))


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
    nearly parallel to X, and a Gram matrix would square that angle. Also
    blockwise over a batch (R, n, k)."""
    Y = Y - X @ (X.mT @ Y)
    Y = Y - X @ (X.mT @ Y)
    return Y


def _per_lane(x: torch.Tensor) -> torch.Tensor:
    """A scalar, or one per lane (R,), shaped to broadcast over a block."""
    return x[:, None, None] if x.dim() == 1 else x


def _shift_term(V: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(c / n) 1 1^T V with the column means accumulated in float64 (c can
    exceed lambda_2 by many orders of magnitude); V (n, k) with c 0-d, or
    lanes (R, n, k) with c (R,)."""
    m64 = V.double().mean(dim=-2, keepdim=True)
    return (_per_lane(c).double() * m64).to(V.dtype)


class Operator:
    """A linear operator V -> L V with TRACEMIN's shifted forms:
    `shifted(c)` is V -> L V + (c / n) 1 1^T V, and `shifted(c, sigma)`
    that + sigma V (c and sigma 0-d, or (R,) one per lane). Here they are
    closures over the product with _shift_term's shift; an operator with
    forms of its own (ops.banded.BandedProduct) overrides `shifted`.
    as_operator wraps a plain function."""

    def __init__(self, apply: Callable[[torch.Tensor], torch.Tensor]):
        self.apply = apply

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        return self.apply(V)

    def shifted(self, c: torch.Tensor, sigma: Optional[torch.Tensor] = None
                ) -> Callable[[torch.Tensor], torch.Tensor]:
        def apply_shifted(V):
            y = self(V) + _shift_term(V, c)
            return y if sigma is None else y + _per_lane(sigma) * V

        return apply_shifted


def as_operator(apply_L) -> Operator:
    """apply_L as an Operator (itself if it is one)."""
    return apply_L if isinstance(apply_L, Operator) else Operator(apply_L)


def default_xprev(n: int, q: int, dtype, device) -> torch.Tensor:
    """The default block that seeds the eigensolver's previous-iterate
    memory: N(0, 1) from a torch.Generator seeded with XPREV_SEED."""
    gen = torch.Generator().manual_seed(XPREV_SEED)
    return torch.randn((n, q), generator=gen, dtype=dtype).to(device)


def default_rel_tol(dtype) -> float:
    """TRACEMIN's eigenvalue-relative stop: 1e-3 in float32, else 1e-7."""
    return 1e-3 if dtype == torch.float32 else 1e-7


def _keep_iterating(res, rres, since, eff_tol, rel_tol,
                    patience: int = STALL_PATIENCE) -> torch.Tensor:
    """TRACEMIN's stop test, elementwise (one solve, or one flag per lane):
    true while the relative residual rres is above rel_tol, the residual
    has not stalled for `patience` iterations, and the reference criterion
    res <= eff_tol does not hold. That criterion counts only when rres is
    also sane (< 2): on tiny-lambda graphs ||r||_1 / ||L||_inf is below
    any tolerance while the pair is still garbage."""
    legacy_done = (res <= eff_tol) & (rres < 2.0)
    return (~legacy_done) & (rres > rel_tol) & (since < patience)


def _stall_update(res_new, best, since, eff_tol,
                  factor: float = STALL_FACTOR):
    """(best residual, count of non-improving iterations) after an outer
    iteration; an iteration counts only near the precision floor, and
    improves when the residual drops below `factor` times the best."""
    near_floor = res_new < 4 * eff_tol
    improved = res_new < factor * best
    return (torch.minimum(best, res_new),
            torch.where(near_floor & ~improved, since + 1,
                        torch.zeros_like(since)))


class TraceminCarry(NamedTuple):
    """TRACEMIN's state from one outer iteration to the next."""

    X: torch.Tensor      # (n, q) Ritz vectors
    AX: torch.Tensor     # (n, q) the shifted operator on them
    lam: torch.Tensor    # (q,) Ritz values
    Xprev: torch.Tensor  # (n, q) the previous iterate
    res: torch.Tensor    # () residual (reference criterion)
    best: torch.Tensor   # () best residual so far
    since: torch.Tensor  # () int32, iterations near the floor not improving
    rres: torch.Tensor   # () eigenvalue-relative residual


class TraceminOps:
    """TRACEMIN's arithmetic on one operator: the entry, one outer
    iteration and the stop flag, each a function of device tensors with no
    host read, so that tracemin_fiedler's loop and the captured CUDA graphs
    of ops.graphs run the same operations. tol and rel_tol are floats or
    0-dim tensors of the block's dtype; the other arguments are
    tracemin_fiedler's."""

    def __init__(self, apply_L, Minv, lnorm: torch.Tensor, *, dtype, tol,
                 rel_tol, coeff_dtype, inner_iters: int,
                 stall_patience: int = STALL_PATIENCE,
                 stall_factor: float = STALL_FACTOR, nullvec=None,
                 inner_solve=None):
        dev = lnorm.device
        eps = torch.finfo(dtype).eps

        def scalar(v):  # a fill, not a copy from the host: capturable
            return (v if isinstance(v, torch.Tensor)
                    else torch.full((), v, dtype=dtype, device=dev))

        self.apply_L, self.Minv, self.lnorm = apply_L, Minv, lnorm
        self.dtype, self.coeff_dtype = dtype, coeff_dtype
        self.inner_iters, self.inner_solve = inner_iters, inner_solve
        self.stall_patience, self.stall_factor = stall_patience, stall_factor
        self.eff_tol = torch.clamp(scalar(tol), min=2048 * eps)
        self.rel_tol = scalar(rel_tol)
        self.c = lnorm.to(dtype)
        self.sigma = 32 * eps * self.c
        # Coefficients in float64, like _shift_term's means.
        self.u64 = None if nullvec is None else nullvec.double()
        # The shifted operator and the inner solve's (+ sigma V).
        if nullvec is None:
            op = as_operator(apply_L)
            self.apply_shifted = op.shifted(self.c)
            self.apply_inner = op.shifted(self.c, self.sigma)
        else:
            def apply_shifted(V):
                coef = self.u64[None, :] @ V.double()  # (1, k)
                shift = self.c.double() * (self.u64[:, None] * coef)
                return apply_L(V) + shift.to(V.dtype)

            self.apply_shifted = apply_shifted
            self.apply_inner = (lambda V: apply_shifted(V)
                                + self.sigma * V)

    def project(self, V):
        if self.u64 is None:
            m64 = V.double().mean(dim=0, keepdim=True)
            return V - m64.to(V.dtype)
        coef = self.u64[None, :] @ V.double()
        return V - (self.u64[:, None] * coef).to(V.dtype)

    def residual(self, lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.sum(torch.abs(r)) / self.lnorm.to(self.dtype)

    def rel_residual(self, lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.linalg.vector_norm(r) / torch.maximum(lam[0],
                                                           self.sigma)

    def entry(self, X0: torch.Tensor, xprev0: torch.Tensor,
              warm: bool) -> TraceminCarry:
        """The cold entry (orthonormalise, then Rayleigh-Ritz), or the warm
        one (the Rayleigh-Ritz rotation alone); xprev0 seeds Xprev. Both
        blocks are read in row-major layout, whatever theirs (a start
        block may be a transposed view), so that the sums round alike for
        any caller's layout and for a captured graph's static copy."""
        q, dtype = X0.shape[1], self.dtype
        X0, xprev0 = X0.contiguous(), xprev0.contiguous()
        X = X0 if warm else _orth(self.project(X0), self.coeff_dtype)
        AX = self.apply_shifted(X)
        H = _gram(X, AX, self.coeff_dtype)
        lam, Y0 = _syev.sym_eig((H + H.T) / 2)
        Y0 = Y0.to(dtype)
        X, AX, lam = X @ Y0, AX @ Y0, lam[:q].to(dtype)
        Xprev = self.project(xprev0.to(dtype))
        res = self.residual(lam, X, AX)
        since = torch.zeros((), dtype=torch.int32, device=X.device)
        return TraceminCarry(X, AX, lam, Xprev, res, res, since,
                             self.rel_residual(lam, X, AX))

    def step(self, carry: TraceminCarry) -> TraceminCarry:
        """One outer iteration: the inner solve, CGS2 against the Ritz
        block, CholeskyQR2 of [X, Y, Xprev] and Rayleigh-Ritz."""
        X, AX, lam, Xprev, res, best, since, rres = carry
        q, dtype = X.shape[1], self.dtype
        inv_lam = 1.0 / torch.maximum(lam, self.sigma)
        if self.inner_solve is None:
            Y = pcg_fixed(self.apply_inner, X, self.Minv,
                          iters=self.inner_iters, X0=X * inv_lam[None, :])
        else:
            Y = self.inner_solve(X, X * inv_lam[None, :], self.inner_iters,
                                 self.c, self.sigma)
        Y = self.project(Y)
        Yp = _colnorm(_ortho_against(X, Y))
        Pp = _colnorm(_ortho_against(X, Xprev))
        S = torch.cat([X, Yp, Pp], dim=1)  # (n, 3q)
        Q = _orth(S, self.coeff_dtype)
        AQ = self.apply_shifted(Q)
        H = _gram(Q, AQ, self.coeff_dtype)
        H = (H + H.T) / 2
        evals, C = _syev.sym_eig(H)
        Cq = C[:, :q].to(dtype)
        lam_new = evals[:q].to(dtype)
        X_new = Q @ Cq
        AX_new = AQ @ Cq
        res_new = self.residual(lam_new, X_new, AX_new)
        best, since = _stall_update(res_new, best, since, self.eff_tol,
                                    self.stall_factor)
        rres = self.rel_residual(lam_new, X_new, AX_new)
        return TraceminCarry(X_new, AX_new, lam_new, X, res_new, best, since,
                             rres)

    def keep(self, carry: TraceminCarry) -> torch.Tensor:
        """The stop test's flag: true while TRACEMIN goes on."""
        return _keep_iterating(carry.res, carry.rres, carry.since,
                               self.eff_tol, self.rel_tol,
                               self.stall_patience)


def tracemin_fiedler(
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    lnorm: torch.Tensor,
    Minv: Callable[[torch.Tensor], torch.Tensor],
    *,
    xprev0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    maxiter: int = TRACEMIN_MAXITER,
    inner_iters: int = TRACEMIN_INNER_ITERS,
    stall_patience: int = STALL_PATIENCE,
    stall_factor: float = STALL_FACTOR,
    rel_tol: Optional[float] = None,
    coeff_dtype=None,
    lam0: Optional[torch.Tensor] = None,
    warm_init: Optional[bool] = None,
    min_iters: int = 0,
    nullvec: Optional[torch.Tensor] = None,
    agree: Callable = bool,
    inner_solve: Optional[Callable] = None,
) -> FiedlerResult:
    """Block inverse (subspace) iteration with Rayleigh-Ritz.

    apply_L: (n, k) -> (n, k) Laplacian product. X0: (n, q) start block.
    lnorm: ||L||_inf (the nullspace shift c). Minv: preconditioner on
    1^perp. xprev0: (n, q) block that seeds the previous-iterate memory
    (LOBPCG's P term) before its first update; None draws default_xprev's.

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
    iterations, or after `stall_patience` iterations near the precision
    floor that did not take the residual below `stall_factor` times its
    best.

    The Rayleigh-Ritz eigensolves run through kernel K4
    (ops.kernels.syev.sym_eig: the CUDA kernel on the card, its plain
    Jacobi on the CPU). The arithmetic is TraceminOps'; ops.graphs runs
    the same entry and outer iteration as replayed CUDA graphs.

    agree: reads the stop test on the host, bool by default; on a mesh the
    group's agreement (parallel.mesh.MeshGroup.agree), so that every rank
    leaves the loop at the same iteration.

    inner_solve: each outer iteration's inner solve as a function (B, X0,
    iters, c, sigma) -> X computing what pcg_fixed does on apply_inner
    (L + (c / n) 1 1^T + sigma I, with nullvec None) preconditioned by
    Minv, for the same operator and preconditioner (ops.graphs.inner_replay:
    the inner solve alone replayed as a CUDA graph); None runs pcg_fixed
    itself.
    """
    n, q = X0.shape
    dtype = X0.dtype
    if coeff_dtype is None:
        coeff_dtype = torch.float64
    if rel_tol is None:
        rel_tol = default_rel_tol(dtype)
    ops = TraceminOps(apply_L, Minv, lnorm, dtype=dtype, tol=tol,
                      rel_tol=rel_tol, coeff_dtype=coeff_dtype,
                      inner_iters=inner_iters, stall_patience=stall_patience,
                      stall_factor=stall_factor, nullvec=nullvec,
                      inner_solve=inner_solve)
    if xprev0 is None:
        xprev0 = default_xprev(n, q, dtype, X0.device)
    carry = ops.entry(X0, xprev0, lam0 is not None and bool(warm_init))
    it = 0
    while True:
        if it >= min_iters and (it >= maxiter or not agree(ops.keep(carry))):
            break
        carry = ops.step(carry)
        it += 1
    return FiedlerResult(lam=carry.lam, X=carry.X, iters=it, res=carry.res)


def _lanes(V: torch.Tensor, R: int) -> torch.Tensor:
    """(n, R k) -> (R, n, k): lane r holds columns r k .. r k + k - 1."""
    return V.reshape(V.shape[0], R, -1).permute(1, 0, 2)


def _flat(A: torch.Tensor) -> torch.Tensor:
    """(R, n, k) -> (n, R k): every lane's columns side by side."""
    R, n, k = A.shape
    return A.permute(1, 0, 2).reshape(n, R * k)


def on_flat_block(fn: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function of the (n, R k) block of every lane's columns side by
    side, as a function of the lanes (R, n, k): for an operator or a
    preconditioner shared by the lanes, whose work then runs on one wide
    block."""
    def lanes_fn(V):
        return _lanes(fn(_flat(V)), V.shape[0])
    return lanes_fn


def _orth_lanes(S: torch.Tensor, coeff_dtype=torch.float64) -> torch.Tensor:
    """_orth of each lane of S (R, n, k): column scaling, then CholeskyQR2
    with one Gram, jitter and factor per lane, coefficients at
    coeff_dtype."""
    S = _colnorm(S)
    k = S.shape[2]
    for _ in range(2):
        G = _gram(S, S, coeff_dtype)
        eye = torch.eye(k, dtype=G.dtype, device=G.device)
        jitter = k * torch.finfo(S.dtype).eps * (batched_trace(G) + 1.0)
        Rf = cholesky_upper(G + jitter[:, None, None] * eye)
        Rinv = torch.linalg.solve_triangular(Rf, eye.expand_as(Rf),
                                             upper=True)
        S = S @ Rinv.to(S.dtype)
    return S


def tracemin_fiedler_lanes(
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    lnorm: torch.Tensor,
    Minv: Callable[[torch.Tensor], torch.Tensor],
    *,
    xprev0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    maxiter: int = TRACEMIN_MAXITER,
    inner_iters: int = TRACEMIN_INNER_ITERS,
    rel_tol: Optional[float] = None,
    coeff_dtype=None,
    min_iters: int = 0,
    agree: Callable = bool,
) -> FiedlerResult:
    """tracemin_fiedler's cold entry and iteration for R operators at once,
    one lane each, as one solve: what a vmap of tracemin_fiedler over the
    lanes computes, with the same knobs.

    apply_L: (R, n, k) -> (R, n, k), lane r's operator on lane r's block
    (k = q, or 3q for the Rayleigh-Ritz basis). Minv: (R, n, k) ->
    (R, n, k), lane r's preconditioner; a lane may take another operator's
    (it changes how fast TRACEMIN converges, not the eigenpair it converges
    to). An operator or preconditioner shared by every lane can run on the
    lanes' columns side by side (on_flat_block). X0: the (n, q) start block
    of every lane, or (R, n, q) one per lane. lnorm: (R,) ||L_r||_inf, each
    lane's nullspace shift. xprev0: the (n, q) block that seeds every
    lane's previous-iterate memory (None: default_xprev's, for every
    lane). min_iters: outer iterations every lane runs whatever its entry
    residual (as in tracemin_fiedler). agree: as in tracemin_fiedler, for
    the test whether any lane goes on.

    Each lane keeps its own Rayleigh-Ritz (the q x q and 3q x 3q
    eigensolves of all lanes as one batch through sym_eig: K4 on the card,
    one launch a batch, its plain Jacobi here), CGS2 and CholeskyQR2,
    residuals, stall count and stop test; a lane that has stopped stays as
    it was. The stop flags are read from the device
    once per outer iteration. Returns FiedlerResult with lam (R, q),
    X (R, n, q), iters (R,) and res (R,).
    """
    R = lnorm.shape[0]
    n, q = X0.shape[-2:]
    dtype, dev = X0.dtype, X0.device
    eps = torch.finfo(dtype).eps
    eff_tol = max(float(tol), 2048 * eps)
    if rel_tol is None:
        rel_tol = default_rel_tol(dtype)
    if coeff_dtype is None:
        coeff_dtype = torch.float64
    c = lnorm.to(dtype)
    sigma = 32 * eps * c

    def project(V):
        return V - V.double().mean(dim=-2, keepdim=True).to(V.dtype)

    op = as_operator(apply_L)
    apply_shifted, apply_inner = op.shifted(c), op.shifted(c, sigma)

    def rayleigh_ritz(Q, AQ):
        H = _gram(Q, AQ, coeff_dtype)
        evals, C = _syev.sym_eig((H + H.mT) / 2)
        Cq = C[:, :, :q].to(dtype)
        return Q @ Cq, AQ @ Cq, evals[:, :q].to(dtype)

    def residuals(lam, X, AX):
        r = AX[:, :, 0] - lam[:, :1] * X[:, :, 0]  # (R, n)
        return (r.abs().sum(dim=1) / c,
                torch.linalg.vector_norm(r, dim=1)
                / torch.maximum(lam[:, 0], sigma))

    X = _orth_lanes(project(X0.expand(R, n, q)), coeff_dtype)
    X, AX, lam = rayleigh_ritz(X, apply_shifted(X))
    if xprev0 is None:
        xprev0 = default_xprev(n, q, dtype, dev)
    Xprev = project(xprev0.to(dtype)).expand(R, n, q)
    res, rres = residuals(lam, X, AX)
    best = res
    since = torch.zeros(R, dtype=torch.int32, device=dev)
    iters = torch.zeros(R, dtype=torch.int32, device=dev)
    it = 0
    while True:
        keep = _keep_iterating(res, rres, since, eff_tol, rel_tol)
        if it < min_iters:
            keep = torch.ones_like(keep)
        elif it >= maxiter or not agree(keep.any()):
            break
        inv_lam = 1.0 / torch.maximum(lam, sigma[:, None])
        Y = project(pcg_fixed(apply_inner, X, Minv, iters=inner_iters,
                              X0=X * inv_lam[:, None, :]))
        S = torch.cat([X, _colnorm(_ortho_against(X, Y)),
                       _colnorm(_ortho_against(X, Xprev))],
                      dim=2)  # (R, n, 3q)
        Q = _orth_lanes(S, coeff_dtype)
        X_new, AX_new, lam_new = rayleigh_ritz(Q, apply_shifted(Q))
        res_new, rres_new = residuals(lam_new, X_new, AX_new)
        best_new, since_new = _stall_update(res_new, best, since, eff_tol)
        # A lane that stopped keeps its state.
        k3 = keep[:, None, None]
        Xprev = torch.where(k3, X, Xprev)
        X = torch.where(k3, X_new, X)
        AX = torch.where(k3, AX_new, AX)
        lam = torch.where(keep[:, None], lam_new, lam)
        best = torch.where(keep, best_new, best)
        res = torch.where(keep, res_new, res)
        rres = torch.where(keep, rres_new, rres)
        since = torch.where(keep, since_new, since)
        iters = iters + keep.to(iters.dtype)
        it += 1
    return FiedlerResult(lam=lam, X=X, iters=iters, res=res)


# LOBPCG stops after this many outer iterations without a 3% residual
# improvement near its precision floor.
LOBPCG_STALL_PATIENCE = 8


def lobpcg_fiedler(
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    X0: torch.Tensor,
    lnorm: torch.Tensor,
    *,
    xprev0: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    agree: Callable = bool,
) -> FiedlerResult:
    """The q smallest nonzero eigenpairs of a graph Laplacian by LOBPCG
    (mac_tpu.ops.lobpcg.lobpcg_fiedler): Rayleigh-Ritz on span[X, W, P]
    of the shifted operator, W the preconditioned residual and P the
    previous iterate, seeded by `xprev0` (None: default_xprev's; the
    reference draws it from jax.random, which torch cannot reproduce).

    apply_L: (n, k) -> (n, k) Laplacian product. X0: (n, q) start block.
    lnorm: ||L||_inf, also the nullspace shift. precond: approximate inverse
    of L on 1^perp, the identity if None. agree: as in tracemin_fiedler."""
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
    if xprev0 is None:
        xprev0 = default_xprev(n, q, dtype, X0.device)
    Xprev = project(xprev0.to(dtype))

    def residual(lam, X, AX):
        r = AX[:, 0] - lam[0] * X[:, 0]
        return torch.sum(torch.abs(r)) / lnorm.to(dtype)

    it = 0
    res = residual(lam, X, AX)
    best = res
    since = 0
    while it < maxiter and agree(float(res) > eff_tol
                                 and since < LOBPCG_STALL_PATIENCE):
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
    the top pair when n - 1 < q. L_dense (..., n, n) may hold a batch of
    Laplacians; lam is then (..., q) and X (..., n, q)."""
    n = L_dense.shape[-1]
    evals, V = torch.linalg.eigh((L_dense + L_dense.mT) / 2)
    hi = min(1 + q, n)
    lam, X = evals[..., 1:hi], V[..., 1:hi]
    pad = q - lam.shape[-1]
    if pad > 0:
        lam = torch.cat([lam, evals[..., -1:].expand(
            *lam.shape[:-1], pad)], dim=-1)
        X = torch.cat([X, V[..., -1:].expand(*X.shape[:-1], pad)], dim=-1)
    return FiedlerResult(lam=lam, X=X, iters=0,
                         res=torch.zeros(L_dense.shape[:-2],
                                         dtype=L_dense.dtype,
                                         device=L_dense.device))

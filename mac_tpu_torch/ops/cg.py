"""Preconditioned conjugate gradients over a block of right-hand sides
(PyTorch counterpart of mac_tpu.ops.cg).

  * `pcg_fixed`: a fixed number of steps, no stop test -- the eigensolver's
    inexact shift-invert.
  * `pcg`: to a relative tolerance per column, converged columns frozen --
    GreedyESP's batched effective-resistance solves. The stop test is read
    from the device once per step.
"""

from typing import Callable, NamedTuple, Optional

import torch


def _identity(B):
    return B


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b where |b| > tiny, else 0: exhausted columns stay inert rather
    than NaN."""
    big = b.abs() > torch.finfo(b.dtype).tiny
    return a / torch.where(big, b, torch.ones_like(b)) * big


def pcg_fixed(apply_A: Callable, B: torch.Tensor,
              Minv: Optional[Callable] = None, iters: int = 16,
              X0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`iters` PCG steps toward A X = B from X0 (default 0),
    preconditioned by Minv (the identity if None). B is (n, q), or
    (R, n, q) for R lanes. Columnwise step sizes; division guards make
    exhausted columns inert rather than NaN."""
    if Minv is None:
        Minv = _identity
    if X0 is None:
        X, R = torch.zeros_like(B), B
    else:
        X, R = X0, B - apply_A(X0)
    Z = Minv(R)
    P = Z
    rz = torch.sum(R * Z, dim=-2)
    for _ in range(int(iters)):
        AP = apply_A(P)
        alpha = _safe_div(rz, torch.sum(P * AP, dim=-2)).unsqueeze(-2)
        X = X + alpha * P
        R = R - alpha * AP
        Z = Minv(R)
        rz_new = torch.sum(R * Z, dim=-2)
        beta = _safe_div(rz_new, rz).unsqueeze(-2)
        P = Z + beta * P
        rz = rz_new
    return X


class CGResult(NamedTuple):
    X: torch.Tensor
    iters: int              # steps taken
    resnorm: torch.Tensor   # (q,) final residual 2-norms


def pcg(apply_A: Callable, B: torch.Tensor, Minv: Optional[Callable] = None,
        tol: float = 1e-10, maxiter: int = 1000,
        X0: Optional[torch.Tensor] = None) -> CGResult:
    """PCG to ||r_j|| <= tol * ||b_j|| per column j. A column that has met
    its tolerance is frozen (its step sizes are masked to 0) while the
    others go on; the loop ends when every column has, or after maxiter
    steps."""
    if Minv is None:
        Minv = _identity
    thresh = tol * torch.clamp(torch.linalg.vector_norm(B, dim=0),
                               min=torch.finfo(B.dtype).tiny)
    if X0 is None:
        X, R = torch.zeros_like(B), B
    else:
        X, R = X0, B - apply_A(X0)
    Z = Minv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    it = 0
    while it < maxiter:
        act = torch.linalg.vector_norm(R, dim=0) > thresh
        if not bool(act.any()):
            break
        active = act.to(B.dtype)
        AP = apply_A(P)
        alpha = _safe_div(rz, torch.sum(P * AP, dim=0)) * active
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = Minv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = _safe_div(rz_new, rz) * active
        P = Z * active[None, :] + beta[None, :] * P
        rz = torch.where(act, rz_new, rz)
        it += 1
    return CGResult(X=X, iters=it,
                    resnorm=torch.linalg.vector_norm(R, dim=0))

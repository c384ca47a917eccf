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

from mac_tpu_torch.ops.kernels import pcg as _k6
from mac_tpu_torch.ops.kernels.pcg import safe_div as _safe_div


def _identity(B):
    return B


def pcg_fixed(apply_A: Callable, B: torch.Tensor,
              Minv: Optional[Callable] = None, iters: int = 16,
              X0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`iters` PCG steps toward A X = B from X0 (default 0),
    preconditioned by Minv (the identity if None). B is (n, q), or
    (R, n, q) for R lanes. Columnwise step sizes; division guards make
    exhausted columns inert rather than NaN. On CUDA tensors the step's
    update runs in kernel K6 (pcg_fixed_steps), else as PyTorch ops
    (pcg_fixed_plain)."""
    if B.is_cuda:
        return pcg_fixed_steps(apply_A, B, Minv, iters, X0)
    return pcg_fixed_plain(apply_A, B, Minv, iters, X0)


def pcg_fixed_plain(apply_A: Callable, B: torch.Tensor,
                    Minv: Optional[Callable] = None, iters: int = 16,
                    X0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pcg_fixed as PyTorch ops (the reference's loop body, op for op)."""
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


def pcg_fixed_steps(apply_A: Callable, B: torch.Tensor,
                    Minv: Optional[Callable] = None, iters: int = 16,
                    X0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pcg_fixed through K6's wrappers (mac_tpu_torch.ops.kernels.pcg), on
    any device: the kernels on CUDA tensors, their plain versions on the
    CPU. Per step: A P with the column dots P . AP, K6's first pass (alpha,
    X, R and R's column sums), Z = Minv(R), and K6's second pass with the
    dots (R . Z, then beta, P, rz and P's column sums). Where apply_A has
    `product` (ops.banded.BandedProduct, K5, or ops.laplacian.EllProduct,
    K8: A P with the dots, and the start's residual, in one launch) and
    Minv has `cycle` (ops.banded.VCycle or ops.twogrid.EllVCycle: their
    kernels return x uncentred with its column sums, and K6 centres Z =
    x - mean(x) on the fly), a step is nine launches on city10000's banded
    route and on the n = 100000 matrix-free one; otherwise apply_A and
    Minv run as they are, with the dots P . AP from K6's col_sums. X0 is
    not changed."""
    product = getattr(apply_A, "product", None)
    cycle = getattr(Minv, "cycle", None)
    B = B.contiguous()
    if X0 is None:
        X, R = torch.zeros_like(B), B.clone()
    else:
        X = X0.clone(memory_format=torch.contiguous_format)
        if product is not None:
            R = product(X, vsum=_k6.col_sums(X), B=B)
        else:
            R = (B - apply_A(X0)).contiguous()

    def precondition(R, rsum):
        if cycle is not None:
            return cycle(R, rsum)
        if Minv is None:
            return R, None
        return Minv(R).contiguous(), None

    rsum = _k6.col_sums(R) if cycle is not None else None
    Z, zsum = precondition(R, rsum)
    rz = torch.empty(B.shape[:-2] + B.shape[-1:], dtype=B.dtype,
                     device=B.device)
    P = torch.empty_like(B)
    sums = product is not None
    psum, _ = _k6.cg_direction_dots(P, R, Z, zsum, rz, init=True,
                                    sums=sums)
    for _ in range(int(iters)):
        if product is not None:
            AP, pap = product(P, vsum=psum, dot=True)
        else:
            AP = apply_A(P).contiguous()
            pap = _k6.col_sums(P, AP)
        rsum = _k6.cg_update(X, R, P, AP, rz, pap, sums=cycle is not None)
        Z, zsum = precondition(R, rsum)
        psum, _ = _k6.cg_direction_dots(P, R, Z, zsum, rz, sums=sums)
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

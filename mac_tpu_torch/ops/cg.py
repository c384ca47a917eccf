"""Fixed-step preconditioned conjugate gradients over a block of right-hand
sides (PyTorch counterpart of mac_tpu.ops.cg.pcg_fixed): the eigensolver's
inexact shift-invert."""

from typing import Callable, Optional

import torch


def pcg_fixed(apply_A: Callable, B: torch.Tensor, Minv: Callable,
              iters: int, X0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`iters` PCG steps toward A X = B from X0 (default 0),
    preconditioned by Minv. Columnwise step sizes; division guards make
    exhausted columns inert rather than NaN."""
    tiny = torch.finfo(B.dtype).tiny

    def safe_div(a, b):
        big = b.abs() > tiny
        return a / torch.where(big, b, torch.ones_like(b)) * big

    if X0 is None:
        X, R = torch.zeros_like(B), B
    else:
        X, R = X0, B - apply_A(X0)
    Z = Minv(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    for _ in range(int(iters)):
        AP = apply_A(P)
        alpha = safe_div(rz, torch.sum(P * AP, dim=0))
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = Minv(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = safe_div(rz_new, rz)
        P = Z + beta[None, :] * P
        rz = rz_new
    return X

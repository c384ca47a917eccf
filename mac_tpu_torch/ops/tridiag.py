"""Symmetric tridiagonal LDL^T factorization and solves.

PyTorch counterpart of mac_tpu.ops.tridiag. The tridiagonal part of a
pose-graph Laplacian (degrees plus the odometry chain) is the smoother of
the banded two-level preconditioner (mac_tpu_torch.ops.banded) and of the
matrix-free two-grid V-cycle (mac_tpu_torch.ops.twogrid):

  1. LDL^T pivots d'_i = d_i - e_{i-1}^2 / d'_{i-1}: a continued-fraction
     (Moebius) recurrence in float64, factored by the hand-written CUDA
     kernels K3 (the exact factor, tridiag_ldl: projective 2x2 maps of
     short chunks, carried in order, then a three-term recurrence per
     chunk) and K3b (segments of `block` rows decoupled,
     tridiag_ldl_blocked: one thread per segment) on the card
     (mac_tpu_torch.ops.kernels.ldl), and by their plain versions
     elsewhere (a doubling scan of the maps; a `block`-step recurrence
     vectorised over the segments).
  2. Forward and backward substitution: affine recurrences, solved by the
     hand-written CUDA kernels K1 (whole rows) and K1b (decoupled segments)
     on the card, in float32 or float64 (mac_tpu_torch.ops.kernels.tridiag),
     and by their plain scan versions elsewhere.

Every function here also takes R lanes (the budget sweep): d, e of shape
(R, n) and (R, n - 1) factor R matrices at once, into dp, l of shape
(R, n); the solves then take B of shape (R, n, q).
"""

from typing import Optional

import torch

from mac_tpu_torch.ops.kernels import ldl as _ldl
from mac_tpu_torch.ops.kernels import tridiag as _kernels

# Largest n factored exactly by tridiag_ldl_auto and solved by the whole-row
# kernel K1 for any factor; beyond it a segment-decoupled factor goes to the
# segment-parallel kernel K1b.
TRIDIAG_SCAN_MAX_N = 32768
# Segment length of K1b's solves (the TPU kernel's block).
SOLVE_BLOCK = 1024


class TridiagFactor:
    """LDL^T factor of an SPD tridiagonal matrix: T = L diag(dp) L^T with
    unit-lower-bidiagonal L, subdiagonal l (l[0] = 0).

    `seg` records how the factor was produced: None = exact factorization
    (tridiag_ldl); an integer = segment-decoupled factor with couplings
    zeroed at every `seg` boundary (tridiag_ldl_blocked). The solve
    dispatch reads it to decide which kernels are valid for the factor."""

    __slots__ = ("dp", "l", "seg")

    def __init__(self, dp: torch.Tensor, l: torch.Tensor,
                 seg: Optional[int] = None):
        self.dp = dp
        self.l = l
        self.seg = seg

    def __repr__(self):
        return f"TridiagFactor(dp={self.dp!r}, l={self.l!r}, seg={self.seg})"


def tridiag_ldl(d: torch.Tensor, e: torch.Tensor) -> TridiagFactor:
    """Exact LDL^T pivots of the SPD tridiagonal matrix with diagonal d (n,)
    and off-diagonal e (n-1,), or of R lanes (d (R, n), e (R, n-1)):
    kernel K3 on the card, its plain float64 doubling scan on the CPU. The
    factor comes back in the input dtype, pivots floored at 8 eps max(d)."""
    dp, l = _ldl.tridiag_ldl(d, e)
    return TridiagFactor(dp=dp, l=l)


def tridiag_ldl_blocked(d: torch.Tensor, e: torch.Tensor,
                        block: int = 1024) -> TridiagFactor:
    """Segment-decoupled LDL^T: `block`-node chain segments factor
    independently (the couplings across segment boundaries are dropped --
    the factor is a preconditioner, and the coarse level owns the global
    modes). Kernel K3b on the card, one thread per segment; its plain
    `block`-step float64 recurrence on the CPU; bitwise the same."""
    dp, l = _ldl.tridiag_ldl_blocked(d, e, block)
    return TridiagFactor(dp=dp, l=l, seg=int(block))


def tridiag_ldl_auto(d: torch.Tensor, e: torch.Tensor) -> TridiagFactor:
    """tridiag_ldl up to TRIDIAG_SCAN_MAX_N, the blocked factor beyond."""
    if d.shape[-1] <= TRIDIAG_SCAN_MAX_N:
        return tridiag_ldl(d, e)
    return tridiag_ldl_blocked(d, e)


def tridiag_solve_factored(f: TridiagFactor, B: torch.Tensor) -> torch.Tensor:
    """Solve T X = B given the LDL^T factor; B is (n, q), or (R, n, q) for
    a factor of R lanes or one shared by every lane. Plain scans."""
    return _kernels.tridiag_solve_plain(f.dp, f.l, B)


def tridiag_solve(d: torch.Tensor, e: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """Solve the SPD tridiagonal system (diagonal d, off-diagonal e)
    against the (n, q) block B: the exact factor, then the plain scans."""
    return tridiag_solve_factored(tridiag_ldl(d, e), B)


def tridiag_solve_factored_fast(f: TridiagFactor,
                                B: torch.Tensor) -> torch.Tensor:
    """The kernels for float32 and float64 blocks of any width (the
    dispatch rule of mac_tpu.ops.tridiag): K1 up to TRIDIAG_SCAN_MAX_N;
    beyond it K1b (segments of SOLVE_BLOCK rows) for a factor already
    decoupled at those boundaries (f.seg divides SOLVE_BLOCK), and K1 for
    any other factor. The TPU's 32768-row and 32-column limits were its
    VMEM budget; the CUDA kernels have neither. Each kernel wrapper runs
    the CUDA kernel on a CUDA tensor and its plain version on a CPU tensor,
    so no block on the card reaches the plain scans, and a kernel that
    fails to build or launch raises.

    A float64 block runs the float64 instantiation of the same kernel: a
    deliberate difference from the reference, whose kernels are float32
    only because the TPU cannot take float64 through a Pallas call, so that
    its dispatch sends every other block to its scan solve.
    Lanes (B (R, n, q), a factor of R lanes or a shared one) go to the same
    kernel in one launch."""
    n = B.shape[-2]
    dp = f.dp if f.dp.dtype == B.dtype else f.dp.to(B.dtype)
    l = f.l if f.l.dtype == B.dtype else f.l.to(B.dtype)
    if (n > TRIDIAG_SCAN_MAX_N and f.seg is not None
            and SOLVE_BLOCK % int(f.seg) == 0):
        return _kernels.tridiag_solve_blocked(dp, l, B, block=SOLVE_BLOCK)
    return _kernels.tridiag_solve(dp, l, B)

"""Symmetric tridiagonal LDL^T factorization and solves.

PyTorch counterpart of mac_tpu.ops.tridiag. The tridiagonal part of a
pose-graph Laplacian (degrees plus the odometry chain) is the smoother of
the banded two-level preconditioner (mac_tpu_torch.ops.banded) and of the
matrix-free two-grid V-cycle (mac_tpu_torch.ops.twogrid):

  1. LDL^T pivots d'_i = d_i - e_{i-1}^2 / d'_{i-1}: a continued-fraction
     (Moebius) recurrence, composed projectively as normalised 2x2 matrix
     products by a float64 doubling scan (tridiag_ldl), or run as a
     `block`-step float64 recurrence vectorised over chain segments
     (tridiag_ldl_blocked).
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


def _mobius_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b @ a for stacks of projective 2x2 maps, normalised by the largest
    entry (b follows a in sequence order)."""
    m = b @ a
    scale = m.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return m / scale


def tridiag_ldl(d: torch.Tensor, e: torch.Tensor) -> TridiagFactor:
    """Exact LDL^T pivots of the SPD tridiagonal matrix with diagonal d (n,)
    and off-diagonal e (n-1,). The doubling scan runs in float64 (the
    Moebius products span a wide dynamic range) and the factor comes back
    in the input dtype, pivots floored at 8 eps max(d)."""
    out_dtype = d.dtype
    d = d.double()
    e = e.double()
    zero = torch.zeros((*d.shape[:-1], 1), dtype=d.dtype, device=d.device)
    e2 = torch.cat([zero, e * e], dim=-1)  # e2[i] = e_{i-1}^2
    # x_i = d_i - e2_i / x_{i-1} as [[d_i, -e2_i], [1, 0]] acting projectively.
    M = torch.stack([torch.stack([d, -e2], dim=-1),
                     torch.stack([torch.ones_like(d), torch.zeros_like(d)],
                                 dim=-1)], dim=-2)  # (..., n, 2, 2)
    n = d.shape[-1]
    k = 1
    while k < n:
        M = torch.cat([M[..., :k, :, :],
                       _mobius_combine(M[..., :-k, :, :], M[..., k:, :, :])],
                      dim=-3)
        k *= 2
    dp = M[..., 0, 0] / M[..., 1, 0]
    floor = 8 * torch.finfo(out_dtype).eps * d.amax(dim=-1, keepdim=True)
    dp = torch.maximum(dp, floor)
    l = torch.cat([zero, e / dp[..., :-1]], dim=-1)
    return TridiagFactor(dp=dp.to(out_dtype), l=l.to(out_dtype))


def tridiag_ldl_blocked(d: torch.Tensor, e: torch.Tensor,
                        block: int = 1024) -> TridiagFactor:
    """Segment-decoupled LDL^T: `block`-node chain segments factor
    independently (the couplings across segment boundaries are dropped --
    the factor is a preconditioner, and the coarse level owns the global
    modes). A `block`-step float64 recurrence over (n / block,) vectors."""
    out_dtype = d.dtype
    dev = d.device
    lead, n = d.shape[:-1], d.shape[-1]
    nb = -(-n // block)
    n_pad = nb * block
    f64 = torch.float64
    d64 = torch.cat([d, torch.ones((*lead, n_pad - n), dtype=d.dtype,
                                   device=dev)], dim=-1).to(f64)
    e2 = torch.cat([torch.zeros((*lead, 1), dtype=f64, device=dev),
                    (e * e).to(f64),
                    torch.zeros((*lead, n_pad - n), dtype=f64, device=dev)],
                   dim=-1)
    pos = torch.arange(n_pad, device=dev) % block
    e2 = torch.where(pos == 0, torch.zeros_like(e2), e2)
    dB = d64.reshape(*lead, nb, block)
    eB = e2.reshape(*lead, nb, block)
    prev = torch.ones((*lead, nb), dtype=f64, device=dev)
    cols = []
    for i in range(block):  # every lane's segments in each step
        prev = dB[..., i] - eB[..., i] / prev
        cols.append(prev)
    dp = torch.stack(cols, dim=-1).reshape(*lead, n_pad)[..., :n]
    floor = 8 * torch.finfo(out_dtype).eps * d.to(f64).amax(dim=-1,
                                                            keepdim=True)
    dp = torch.maximum(dp, floor)
    e64 = e.to(f64)
    if n > 1:
        cut = (torch.arange(1, n, device=dev) % block) == 0
        e64 = torch.where(cut, torch.zeros_like(e64), e64)
    l = torch.cat([torch.zeros((*lead, 1), dtype=f64, device=dev),
                   e64 / dp[..., :-1]], dim=-1)
    return TridiagFactor(dp=dp.to(out_dtype), l=l.to(out_dtype),
                         seg=int(block))


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

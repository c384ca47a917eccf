"""Two-grid preconditioner for graph Laplacians: exact-chain smoother and a
dense coarse-grid correction (PyTorch counterpart of mac_tpu.ops.twogrid).

  * Smoother: the LDL^T solve of the tridiagonal part of L(w) (degrees and
    the odometry-chain band), exact up to n = 32768 (kernel K1) and
    segment-decoupled at 1024 nodes beyond (kernel K1b).
  * Coarse level: s consecutive nodes per aggregate, nc = ceil(n / s)
    aggregates, piecewise-constant prolongation. Lc = P^T L(w) P is the
    (nc, nc) Laplacian of the coarse edges, accumulated in float64 by one
    scatter-add in a fixed order (the TPU assembled it from one-hot matrix
    products because its scatters are slow), shifted by (cshift / nc)
    1 1^T to make it SPD and inverted once per weight vector through a
    float64 Cholesky factor (regularised when the graph's components leave
    it singular).
  * One symmetric V-cycle: pre-smooth, coarse-correct, post-smooth, with
    the input and output centred (the preconditioner acts on 1^perp). Over
    the ELL product (ops.laplacian.EllProduct) it is an EllVCycle, whose
    form on the card is five hand-written kernels (K1p, K8, K7, K8, K1p)
    with the identity permutation; over any other product (the mesh's
    sharded one, parallel/sharded.py) the PyTorch cycle.

With R weight vectors w (R, m) (the budget sweep), one V-cycle per lane on
blocks (R, n, q): a chain factor and a coarse level each, the chain solves
of all lanes in one kernel launch.
"""

from typing import Callable

import torch

from mac_tpu_torch.ops.kernels import banded as _kb
from mac_tpu_torch.ops.kernels import pcg as _kp
from mac_tpu_torch.ops.kernels import tridiag as _k1
from mac_tpu_torch.ops.laplacian import (EllProduct, GraphOperator, add_at,
                                         lap_tridiagonal_part)
from mac_tpu_torch.ops.lobpcg import batched_trace, cholesky_upper
from mac_tpu_torch.ops.tridiag import (TridiagFactor, tridiag_ldl_auto,
                                       tridiag_solve_factored_fast)


def coarse_laplacian(op: GraphOperator, w: torch.Tensor) -> torch.Tensor:
    """Lc = sum_e w_e (p_i - p_j)(p_i - p_j)^T over the coarse endpoints,
    in float64; edges inside one aggregate contribute nothing. (R, nc, nc)
    for lanes."""
    nc = op.coarse_nc
    lead = w.shape[:-1]
    ci, cj = op.coarse_idx[:, 0], op.coarse_idx[:, 1]
    w64 = torch.where(ci != cj, w.double(), torch.zeros_like(w.double()))
    flat = torch.cat([ci * nc + cj, cj * nc + ci, ci * nc + ci, cj * nc + cj])
    vals = torch.cat([-w64, -w64, w64, w64], dim=-1)
    Lc = torch.zeros((*lead, nc * nc), dtype=torch.float64, device=w.device)
    return add_at(Lc, flat, vals).reshape(*lead, nc, nc)


def twogrid_level(op: GraphOperator, w: torch.Tensor, sharded=None,
                  guards=None):
    """(chain factor, Lc_inv): what the V-cycle of L(w) reads beyond the
    product, built once per weight vector (lanes: one of each per lane).
    sharded: on a mesh, the ELL operator's sharded form
    (mac_tpu_torch.parallel.sharded), whose collectives build the
    tridiagonal part and Lc identically on every rank. guards: None reads
    on the host whether the coarse factor is singular and regularises it
    then; a dict (ops.graphs, whose captured set-up cannot read the host)
    takes the factor as it is and records the test as a device flag in
    guards["coarse_singular"] instead; the caller redoes the step without
    `guards` when it is set."""
    nc = op.coarse_nc
    dtype = w.dtype
    eps = torch.finfo(dtype).eps

    if sharded is None:
        d, e = lap_tridiagonal_part(op, w)
    else:
        d, e = sharded.tridiagonal_part(w)
    fac = tridiag_ldl_auto(d + 100 * eps * d.amax(dim=-1, keepdim=True), e)

    Lc = (coarse_laplacian(op, w) if sharded is None
          else sharded.coarse_laplacian(w))
    diag = torch.diagonal(Lc, dim1=-2, dim2=-1)
    cshift = (2.0 * diag.amax(dim=-1) + 1.0)[..., None, None]
    Lc_reg = Lc + (cshift / nc) * torch.ones_like(Lc)
    eye = torch.eye(nc, dtype=torch.float64, device=w.device)
    Rc = cholesky_upper(Lc_reg)
    piv = torch.diagonal(Rc, dim1=-2, dim2=-1)
    singular = ~(piv.amin(dim=-1) > 1e-7 * piv.amax(dim=-1))
    if guards is not None:
        guards["coarse_singular"] = singular.any()
    elif bool(singular.any()):
        # The constant shift lifts one null vector. A graph of several
        # components made of whole aggregates leaves Lc a null vector per
        # component (lambda_2 = 0), so the factor's last pivot is 0 up to
        # rounding, or NaN. The banded preconditioner's jitter, 1% of the
        # mean diagonal, makes such a coarse level a bounded smoother of
        # those modes and leaves them to the eigensolver.
        jit = (1e-2 * batched_trace(Lc) / nc)[..., None, None]
        Rc = torch.where(singular[..., None, None],
                         cholesky_upper(Lc_reg + jit * eye), Rc)
    Rc_inv = torch.linalg.solve_triangular(Rc, eye.expand_as(Rc), upper=True)
    return fac, (Rc_inv @ Rc_inv.mT).to(dtype)


def twogrid_cycle(op: GraphOperator, fac: TridiagFactor,
                  Lc_inv: torch.Tensor,
                  apply_L: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The symmetric V-cycle over a chain factor and a coarse inverse (what
    twogrid_level builds) and the product apply_L: a function (n, q) ->
    (n, q), or (R, n, q) -> (R, n, q) for lanes. It builds nothing, so
    ops.graphs builds it again over static copies of fac and Lc_inv. Over
    the ELL product of op (an unshifted EllProduct) it is an EllVCycle
    (its kernels on the card); over any other product, the mesh's sharded
    one among them, the PyTorch cycle."""
    n, s, nc = op.n, op.coarse_s, op.coarse_nc
    pad = nc * s - n

    def center(B):
        return B - B.mean(dim=-2, keepdim=True)

    def smooth(B):
        return tridiag_solve_factored_fast(fac, B)

    def restrict(R):  # (..., n, q) -> (..., nc, q): sums within aggregates
        lead = R.shape[:-2]
        if pad:
            R = torch.cat([R, R.new_zeros((*lead, pad, R.shape[-1]))],
                          dim=-2)
        return R.reshape(*lead, nc, s, -1).sum(dim=-2)

    def prolong(Xc):  # (..., nc, q) -> (..., n, q): piecewise constant
        return torch.repeat_interleave(Xc, s, dim=-2)[..., :n, :]

    def precond(B):
        B = center(B)
        x = smooth(B)
        r = B - apply_L(x)
        x = x + prolong(Lc_inv @ restrict(r))
        # Post-smoothing makes the cycle symmetric, as CG needs.
        r2 = B - apply_L(x)
        x = x + smooth(r2)
        return center(x)

    if (isinstance(apply_L, EllProduct) and apply_L.c is None
            and apply_L.op is op):
        return EllVCycle(op, fac, Lc_inv, apply_L, plain=precond)
    return precond


class EllVCycle:
    """twogrid_cycle's symmetric V-cycle over the ELL product: smooth,
    coarse-correct the residual, smooth again, on the centred right-hand
    side, the result centred; the counterpart of ops.banded.VCycle.

    `plain(B)` is twogrid_cycle's cycle as PyTorch ops around the chain
    solve's kernel: the CPU's form, the reference's order. On the card the
    cycle is six launches of hand-written kernels, `cycle(R, rsum)`: K1p
    (the chain solve of R centred by its column sums rsum, through the
    identity permutation op.ident32), K8's residual form, K7's two
    (restrict, then the coarse product and the prolong-add into x), K8 and
    K1p adding into x, which returns x uncentred with its column sums
    (float64): pcg_fixed's K6 centres it on the fly. K1p takes the
    factor's `seg`: the factor decoupled every 1024 rows past
    TRIDIAG_SCAN_MAX_N nodes goes to its segment body, an exact one to its
    cluster body. Calling the cycle on CUDA tensors runs `cycle` (through
    _ell_vcycle_kernels) and centres its result."""

    def __init__(self, op: GraphOperator, fac: TridiagFactor,
                 Lc_inv: torch.Tensor, apply_L: EllProduct, *,
                 plain: Callable):
        self.op, self.fac, self.Lc_inv, self.apply_L = op, fac, Lc_inv, apply_L
        self._plain = plain

    def plain(self, B: torch.Tensor) -> torch.Tensor:
        return self._plain(B)

    def _smooth_kernels(self, B, bsum=None, X=None, sums=False):
        op, fac = self.op, self.fac
        dp = fac.dp if fac.dp.dtype == B.dtype else fac.dp.to(B.dtype)
        l = fac.l if fac.l.dtype == B.dtype else fac.l.to(B.dtype)
        return _k1.tridiag_solve_permuted(dp, l, B, op.ident32, op.ident32,
                                          bsum=bsum, X=X, sums=sums,
                                          seg=fac.seg)

    def cycle(self, R: torch.Tensor, rsum: torch.Tensor):
        """The cycle's kernels on R (contiguous) with its column sums rsum
        (float64): (x, x's column sums), x uncentred."""
        op = self.op
        x = self._smooth_kernels(R, bsum=rsum)
        r = self.apply_L.product(x, B=R, bsum=rsum)
        Lc_inv = self.Lc_inv if self.Lc_inv.dtype == R.dtype else \
            self.Lc_inv.to(R.dtype)
        x = _kb.coarse_correct(r, x, op.ident32, op.ident32, Lc_inv,
                               op.coarse_s)
        r2 = self.apply_L.product(x, B=R, bsum=rsum)
        return self._smooth_kernels(r2, X=x, sums=True)

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        if B.is_cuda:
            return _ell_vcycle_kernels(self, B)
        return self.plain(B)


def _ell_vcycle_kernels(cyc: EllVCycle, B: torch.Tensor) -> torch.Tensor:
    """The cycle on the card, centred: K6's column sums of B, the cycle's
    kernels, and x less its column means."""
    B = B.contiguous()
    x, xsum = cyc.cycle(B, _kp.col_sums(B))
    return x - (xsum / cyc.op.n).to(x.dtype).unsqueeze(-2)


def make_twogrid_precond(
    op: GraphOperator,
    w: torch.Tensor,
    apply_L: Callable[[torch.Tensor], torch.Tensor],
    sharded=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The V-cycle preconditioner for L(w) restricted to 1^perp, a function
    (n, q) -> (n, q), or (R, n, q) -> (R, n, q) for lanes w (R, m); rebuild
    it when w changes. sharded: as in twogrid_level."""
    fac, Lc_inv = twogrid_level(op, w, sharded)
    return twogrid_cycle(op, fac, Lc_inv, apply_L)

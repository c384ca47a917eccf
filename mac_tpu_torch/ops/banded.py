"""Block-banded formulation of the graph Laplacian (RCM-ordered).

PyTorch counterpart of mac_tpu.ops.banded. Pose graphs are spatially local,
so a reverse-Cuthill-McKee relabelling gives a small matrix bandwidth, and
within 128-node blocks L(w) is block-banded with a handful of dense 128x128
block diagonals: L(w) @ V is a few batched matrix products.

Float32 stability: each block-row output is computed against locally
centred inputs, out_b = sum_o BD[o, b] @ (V_{b+o-half} - c_b), with c_b the
mean of V over block b's window. This is exact for any c_b (Laplacian rows
sum to zero inside the window) and scales the float32 rounding to the local
variation of V instead of its magnitude.

Assembly (assemble_bd) writes the transposed upper block diagonals through
the hand-written kernel K2/K2b (mac_tpu_torch.ops.kernels.assemble); the
lower diagonals are never materialised -- the apply reads them as
transposed products of the uppers.

The companion preconditioner (make_banded_precond) is a symmetric two-level
cycle: an exact odometry-chain tridiagonal solve applied through the RCM
permutation (kernel K1, mac_tpu_torch.ops.kernels.tridiag) around a dense
coarse-grid correction over original-order aggregates. Its other variants,
which no route takes: a block-Jacobi smoother (exact solves of the RCM
diagonal blocks) and the additive cycle M^-1 = S + P Lc^-1 R.

Lanes (the budget sweep): assemble_bd, banded_apply, chain_factor and
make_banded_precond (without a carried PrecondState) also take R weight
vectors w (R, m) at once, with BD (R, ...) and blocks V (R, n, q): one
kernel launch and one batched product for all lanes, one chain factor and
one coarse level per lane.

Numerics: every product here runs in full float32 (TF32 is off, see
mac_tpu_torch.device). The TPU reference runs the preconditioner-internal
products (the coarse R^T (L R) and the residual applies) at its DEFAULT
precision, a single bf16 pass; this port keeps them in float32.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mac_tpu_torch.ops.kernels import banded as _kb
from mac_tpu_torch.ops.kernels import pcg as _kp
from mac_tpu_torch.ops.kernels import tridiag as _k1
from mac_tpu_torch.ops.kernels.assemble import assemble_ut
from mac_tpu_torch.ops.lobpcg import (Operator, batched_trace,
                                      cholesky_upper)
from mac_tpu_torch.ops.tridiag import (
    TridiagFactor,
    tridiag_ldl_auto,
    tridiag_ldl_blocked,
    tridiag_solve_factored_fast,
)

BS = 128  # node-block size
# The banded path applies only when the RCM bandwidth keeps the band narrow.
MAX_BANDWIDTH = 640
# Largest per-block overflow the assembly tables take (see build_banded).
OV_CAP = 6
# Target coarse-grid size of the two-level preconditioner.
COARSE_NC = 512
# Segment length of the chain smoother's blocked LDL^T for n > 4096.
CHAIN_LDL_BLOCK = 128
# Newton-Schulz refinement steps per warm coarse-inverse rebuild.
NS_COARSE_STEPS = 3
# The preconditioner's smoothers and cycle forms (make_banded_precond);
# PRECOND_KIND is the form every route takes.
SMOOTHERS = ("chain", "bjacobi")
KINDS = ("mult", "additive")
PRECOND_KIND = "mult"

TABLES = ("ueid_tbl", "dcol_tbl", "agg", "perm", "iperm", "chain_eid",
          "oeid_tbl", "ocol_tbl", "olane_tbl")
STATICS = ("n", "nb", "ndiag", "coarse_s", "coarse_nc", "du_dense", "ov_rows")


class BDRep(NamedTuple):
    """Assembled weight-dependent operator data: ut (half+1, nb, BS, BS) with
    ut[t][b][c, r] = L[b BS + r, (b + t) BS + c] (t = 0 holds the strict
    upper triangle, transposed), and deg (nb, BS), the diagonal of L; with
    lanes, a leading lane dimension on both."""

    ut: torch.Tensor
    deg: torch.Tensor


class BandedOperator(nn.Module):
    """Static (per-topology) tables for block-banded L(w) products, held as
    int32 buffers so `.to(device)` moves them.

    ueid_tbl (du, n_pad): upper-neighbour edge ids per node (edge (i, j > i)
        at column i), sentinel m (weight 0) in padding.
    dcol_tbl (du, n_pad): sheared column BS + (j - i) + (i mod BS) of each
        slot (0 for padding).
    oeid_tbl / ocol_tbl / olane_tbl (ov_rows, nb): the overflow split --
        slots >= du_dense live in per-block tables of edge id, sheared
        column and lane (see build_banded).
    agg (n_pad,): coarse aggregate of each RCM row (nc for padding).
    perm / iperm (n,): perm[k] = original id of RCM node k; iperm[orig] =
        RCM id.
    chain_eid (max(n-1, 1),): edge id joining original nodes (k, k+1),
        sentinel m where absent.
    graph_routes: the eigensolver's routes on these tables and their
    captured CUDA graphs (mac_tpu_torch.ops.graphs), filled by the first
    solve.
    """

    def __init__(self, tables: dict, n: int, nb: int, ndiag: int,
                 coarse_s: int, coarse_nc: int, du_dense: int = 0,
                 ov_rows: int = 0):
        super().__init__()
        for name in TABLES:
            table = np.array(tables[name], dtype=np.int32)  # a fresh copy
            self.register_buffer(name, torch.from_numpy(table))
        self.n = int(n)
        self.nb = int(nb)
        self.ndiag = int(ndiag)
        self.coarse_s = int(coarse_s)
        self.coarse_nc = int(coarse_nc)
        self.du_dense = int(du_dense)
        self.ov_rows = int(ov_rows)
        self.graph_routes = {}

    @property
    def half(self) -> int:
        return self.ndiag // 2

    @property
    def n_pad(self) -> int:
        return self.nb * BS


def rcm_order(idx: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Reverse-Cuthill-McKee node permutation for an edge list.

    Returns (perm, inv, bandwidth): perm[k] = original id of new node k,
    inv[orig] = new id, bandwidth = max |i' - j'| over relabelled edges.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    idx = np.asarray(idx).reshape(-1, 2)
    m = idx.shape[0]
    A = sp.coo_matrix((np.ones(m), (idx[:, 0], idx[:, 1])), shape=(n, n))
    perm = np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A + A.T),
                                            symmetric_mode=True))
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    r = inv[idx]
    bw = int(np.abs(r[:, 0] - r[:, 1]).max(initial=0))
    return perm, inv, bw


def build_banded_rcm(idx: np.ndarray, num_nodes: int,
                     dtype=torch.float32, target_nc: int = COARSE_NC):
    """RCM-relabel an edge list and build the banded tables.

    Returns (bop, relabeled_idx) or (None, None) when the graph admits no
    narrow band. The permutation and the original-order chain table are
    recorded on the operator so the preconditioner smooths in the original
    (odometry-chain) ordering. dtype is accepted for the reference's call
    form and unused: the tables are integers.
    """
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    n = int(num_nodes)
    if idx.shape[0] == 0 or n < 4 * BS:
        return None, None
    perm, inv, bw = rcm_order(idx, n)
    if bw == 0 or bw > MAX_BANDWIDTH:
        return None, None
    ridx = inv[idx]
    bop = build_banded(ridx, n, target_nc=target_nc, perm=perm, iperm=inv,
                       orig_idx=idx)
    return bop, (None if bop is None else ridx.astype(np.int32))


def build_banded(idx: np.ndarray, num_nodes: int, dtype=torch.float32,
                 target_nc: int = COARSE_NC, perm=None, iperm=None,
                 orig_idx=None) -> Optional[BandedOperator]:
    """Build the block-banded tables for an (already relabelled) edge list on
    the host. Returns None when no narrow band exists. Duplicate (i, j)
    edges occupy separate slots and sum. perm/iperm/orig_idx: see
    build_banded_rcm -- identity when omitted. dtype: unused, as in
    build_banded_rcm."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    n = int(num_nodes)
    m = idx.shape[0]
    if m == 0 or n < 4 * BS:
        return None
    lo = idx.min(axis=1)
    hi = idx.max(axis=1)
    bw = int((hi - lo).max(initial=0))
    if bw == 0 or bw > MAX_BANDWIDTH:
        return None
    # Max block-diagonal offset: (i % BS + bw) // BS <= (BS - 1 + bw) // BS.
    half = (BS - 1 + bw) // BS
    ndiag = 2 * half + 1
    nb = -(-n // BS)
    n_pad = nb * BS

    # Upper-neighbour slots: edge (i, j) contributes -w at sheared column
    # BS + (j - i) + (i % BS) of row i; a stable sort by row ranks each
    # edge within its row.
    counts = np.zeros(n_pad, dtype=np.int64)
    np.add.at(counts, lo, 1)
    du = max(int(counts.max(initial=0)), 1)
    ueid = np.full((n_pad, du), m, dtype=np.int32)
    dcol = np.zeros((n_pad, du), dtype=np.int32)
    order = np.argsort(lo, kind="stable")
    lo_s = lo[order]
    slot = np.arange(m) - np.searchsorted(lo_s, lo_s, side="left")
    ueid[lo_s, slot] = order.astype(np.int32)
    dcol[lo_s, slot] = (BS + (hi[order] - lo_s) + (lo_s % BS)).astype(np.int32)

    # Overflow split: upper degrees are heavy-tailed, so the trailing slots
    # hold a handful of edges each. Take the smallest dense slot count whose
    # per-block overflow fits OV_CAP entries, when that drops >= 2 slots.
    du_dense, ov_rows = du, 0
    oeid_t = np.zeros((0, nb), dtype=np.int32)
    ocol_t = np.zeros((0, nb), dtype=np.int32)
    olane_t = np.zeros((0, nb), dtype=np.int32)
    if du > 3:
        occ_blk = (ueid != m).reshape(nb, BS, du).sum(axis=1)  # (nb, du)
        tail = np.cumsum(occ_blk[:, ::-1], axis=1)[:, ::-1]    # >= slot d
        for d in range(2, du - 1):
            ov_max = int(tail[:, d].max(initial=0))
            if ov_max <= OV_CAP:
                du_dense, ov_rows = d, ov_max
                break
    if ov_rows > 0:
        oeid_t = np.full((ov_rows, nb), m, dtype=np.int32)
        ocol_t = np.zeros((ov_rows, nb), dtype=np.int32)
        olane_t = np.zeros((ov_rows, nb), dtype=np.int32)
        node, sl = np.nonzero(ueid[:, du_dense:] != m)
        blk = node // BS
        # Rank within block (np.nonzero iterates row-major: node ascending).
        pos = np.arange(len(blk)) - np.searchsorted(blk, blk, side="left")
        oeid_t[pos, blk] = ueid[node, du_dense + sl]
        ocol_t[pos, blk] = dcol[node, du_dense + sl]
        olane_t[pos, blk] = (node % BS).astype(np.int32)

    if perm is None:
        perm = np.arange(n, dtype=np.int64)
        iperm = perm
    if orig_idx is None:
        orig_idx = idx

    # Coarse aggregates: s consecutive ORIGINAL-order nodes each (the
    # trajectory is the physically meaningful locality), sized by the real
    # node count so no aggregate is all padding.
    s = max(1, -(-n // target_nc))
    nc = -(-n // s)
    agg = np.concatenate([np.asarray(perm) // s,
                          np.full(n_pad - n, nc, dtype=np.int64)])
    orig_idx = np.asarray(orig_idx, dtype=np.int64).reshape(-1, 2)
    olo = orig_idx.min(axis=1)
    ohi = orig_idx.max(axis=1)
    chain_eid = np.full(max(n - 1, 1), m, dtype=np.int32)
    is_chain = (ohi - olo) == 1
    chain_eid[olo[is_chain]] = np.arange(m, dtype=np.int32)[is_chain]

    tables = dict(ueid_tbl=np.ascontiguousarray(ueid.T),
                  dcol_tbl=np.ascontiguousarray(dcol.T), agg=agg, perm=perm,
                  iperm=iperm, chain_eid=chain_eid, oeid_tbl=oeid_t,
                  ocol_tbl=ocol_t, olane_tbl=olane_t)
    return BandedOperator(tables, n=n, nb=nb, ndiag=ndiag, coarse_s=s,
                          coarse_nc=nc, du_dense=du_dense, ov_rows=ov_rows)


def assemble_bd(bop: BandedOperator, w: torch.Tensor) -> BDRep:
    """BD(w): the transposed upper block diagonals of L(w) and its degree
    vector. The dense slots' weights are gathered here (w_pad[ueid_tbl],
    sentinel m = weight 0) and the overflow tail through its own tables;
    kernel K2/K2b writes ut (its plain version on the CPU). w (m,), or
    (R, m) for R lanes in one launch."""
    w_pad = torch.cat([-w, w.new_zeros((*w.shape[:-1], 1))], dim=-1)
    dd = bop.du_dense
    dcol = bop.dcol_tbl[:dd]
    wu = w_pad[..., bop.ueid_tbl[:dd]]
    ow = w_pad[..., bop.oeid_tbl]
    ut = assemble_ut(dcol, wu, bop.ocol_tbl, bop.olane_tbl, ow, bop.half,
                     bop.nb)
    return BDRep(ut=ut, deg=_deg_from_ut(ut))


def _deg_from_ut(ut: torch.Tensor) -> torch.Tensor:
    """deg_i = -(row sums + column sums over the uppers); the column sums of
    block diagonal t land t blocks below (lower-diagonal symmetry)."""
    lead = ut.shape[:-4]
    half = ut.shape[-4] - 1
    nb = ut.shape[-3]
    rowsum = ut.sum(dim=-2)  # (..., half+1, nb, BS)
    colsum = ut.sum(dim=-1)
    deg = -rowsum[..., 0, :, :] - colsum[..., 0, :, :]
    for t in range(1, half + 1):
        deg = deg - rowsum[..., t, :, :]
        deg = deg - torch.cat(
            [ut.new_zeros((*lead, t, BS)), colsum[..., t, : nb - t, :]],
            dim=-2)
    return deg


def banded_apply(bop: BandedOperator, BD: BDRep,
                 V: torch.Tensor) -> torch.Tensor:
    """L(w) @ V for V of shape (n, q), in full float32 (or V's dtype): per
    block row, the degree term, the diagonal block's strict upper part and
    its transpose, and each off block diagonal read directly at +t and
    transposed at -t, all against locally centred inputs. With lanes (BD
    and V (R, n, q)), lane r's operator on lane r's block. Kernel K5
    (mac_tpu_torch.ops.kernels.banded) on the card, one launch; its plain
    version, PyTorch's batched products, on the CPU. The kernel reads each
    lane of V row-major: another layout is copied so first."""
    if V.is_cuda and not _kb.one_lane_contiguous(V, 2):
        V = V.contiguous()
    return _kb.banded_product(BD.ut, BD.deg, V, bop.n)


class BandedProduct(Operator):
    """L(w) V on the banded operator (banded_apply), or TRACEMIN's shifted
    operators over it: (L V + (c / n) 1 1^T V) with c, and + sigma V with
    sigma too (c, sigma 0-d, or (R,) with lanes), all through K5's wrapper
    (the kernel on the card, its plain version on the CPU). `product`
    gives pcg_fixed K5's other forms (the residual B - A V, the column
    dots of V and A V), from V's column sums `vsum` (float64) where the
    shift needs them."""

    def __init__(self, bop: BandedOperator, BD: BDRep,
                 c: Optional[torch.Tensor] = None,
                 sigma: Optional[torch.Tensor] = None):
        self.bop, self.BD, self.c, self.sigma = bop, BD, c, sigma

    def shifted(self, c: torch.Tensor,
                sigma: Optional[torch.Tensor] = None) -> "BandedProduct":
        return BandedProduct(self.bop, self.BD, c, sigma)

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        if self.c is None:
            return banded_apply(self.bop, self.BD, V)
        V = V.contiguous()
        return self.product(V, vsum=_kp.col_sums(V))

    def product(self, V: torch.Tensor, vsum: Optional[torch.Tensor] = None,
                B: Optional[torch.Tensor] = None, dot: bool = False):
        """K5 on V: A V, or B - A V with B; (that, the column dots of V and
        it) with dot. vsum: V's column sums (float64), which the shift
        needs (ignored without c)."""
        shifted = self.c is not None
        return _kb.banded_product(
            self.BD.ut, self.BD.deg, V, self.bop.n, B=B,
            vsum=vsum if shifted else None, c=self.c,
            sigma=self.sigma if shifted else None, dot=dot)


def banded_upper(ut: torch.Tensor, nb: int, b0: int = 0) -> torch.Tensor:
    """The upper triangle of L(w), (..., nb BS, nb BS), in the operator's
    (RCM) node ids, holding the block rows [b0, b0 + ut's rows) that ut
    (..., half+1, rows, BS, BS) assembles: block (b, b + t) is ut[t][b]^T
    (t = 0: the strict upper part of the diagonal block); zeros elsewhere."""
    lead = ut.shape[:-4]
    half, rows = ut.shape[-4] - 1, ut.shape[-3]
    # U[..., block row, block column + t, r, c]; columns past nb stay empty.
    U = ut.new_zeros((*lead, rows, nb + half, BS, BS))
    for t in range(half + 1):
        torch.diagonal(U[..., b0 + t:b0 + t + rows, :, :], dim1=-4,
                       dim2=-3).copy_(ut[..., t, :, :, :].transpose(-1, -2)
                                      .movedim(-3, -1))
    U = U[..., :nb, :, :].movedim(-3, -2)  # (..., rows, BS, nb, BS)
    full = ut.new_zeros((*lead, nb, BS, nb, BS))
    full[..., b0:b0 + rows, :, :, :] = U
    return full.reshape(*lead, nb * BS, nb * BS)


def dense_from_upper(U: torch.Tensor, deg: torch.Tensor,
                     n: int) -> torch.Tensor:
    """L(w) (..., n, n) from its strict upper triangle U (..., n_pad, n_pad)
    and its diagonal deg (..., nb, BS)."""
    L = U + U.mT
    L = L + torch.diag_embed(deg.reshape(*deg.shape[:-2], -1))
    return L[..., :n, :n]


def banded_dense(bop: BandedOperator, BD: BDRep) -> torch.Tensor:
    """L(w) as a dense (n, n) matrix (with lanes (R, n, n)) in the
    operator's (RCM) node ids, read off BD: the exact dense eigh of
    fiedler_method="dense" runs on it."""
    return dense_from_upper(banded_upper(BD.ut, bop.nb), BD.deg, bop.n)


class PrecondState(NamedTuple):
    """Carryable preconditioner state across Frank-Wolfe steps: the explicit
    coarse inverse and the chain smoother's LDL^T factor (original order).
    A warm rebuild refines the previous inverse with Newton-Schulz; a
    rebuild=False step reuses the whole state."""

    Lc_inv: torch.Tensor                     # (nc, nc)
    chain_dp: Optional[torch.Tensor] = None  # (n,) LDL pivots
    chain_l: Optional[torch.Tensor] = None   # (n,) unit-L subdiagonal


def chain_factor(bop: BandedOperator, BD: BDRep,
                 w: torch.Tensor) -> TridiagFactor:
    """LDL^T factor of the tridiagonal part of L(w) in ORIGINAL node order
    (the odometry chain): the degrees gathered through the permutation,
    lifted by 100 eps max(deg), and the chain edge weights. Exact for
    n <= 4096, segment-decoupled at CHAIN_LDL_BLOCK nodes beyond. With
    lanes (w (R, m)), one factor per lane: dp, l (R, n)."""
    n, n_pad = bop.n, bop.n_pad
    lead = w.shape[:-1]
    dtype = BD.deg.dtype
    eps = torch.finfo(dtype).eps
    d_nat = BD.deg.reshape(*lead, n_pad)[..., :n][..., bop.iperm]
    w_pad = torch.cat([w, w.new_zeros((*lead, 1))], dim=-1)
    e_nat = -w_pad[..., bop.chain_eid][..., : max(n - 1, 1)].to(dtype)
    dd = d_nat + 100 * eps * d_nat.amax(dim=-1, keepdim=True)
    if n > 4096:
        return tridiag_ldl_blocked(dd, e_nat, block=CHAIN_LDL_BLOCK)
    return tridiag_ldl_auto(dd, e_nat)


def diag_blocks(BD: BDRep) -> torch.Tensor:
    """The BS x BS diagonal blocks of L(w) of the block rows BD holds,
    (..., rows, BS, BS): ut[0] + ut[0]^T + diag(deg)."""
    ut0 = BD.ut[..., 0, :, :, :]
    return ut0 + ut0.mT + torch.diag_embed(BD.deg)


def bjacobi_inverse(Dblk: torch.Tensor) -> torch.Tensor:
    """The block-Jacobi smoother's inverses of the diagonal blocks Dblk
    (..., nb, BS, BS): each block lifted by 100 eps max|Dblk| (the max over
    every block of a lane), factored as R^T R by an upper Cholesky (NaN
    where a block is not positive definite, as JAX's) and inverted as
    R^-1 R^-T."""
    eps = torch.finfo(Dblk.dtype).eps
    eye = torch.eye(BS, dtype=Dblk.dtype, device=Dblk.device)
    reg = 100 * eps * Dblk.abs().amax(dim=(-3, -2, -1), keepdim=True)
    Rchol = cholesky_upper(Dblk + reg * eye)
    Rinv = torch.linalg.solve_triangular(Rchol, eye.expand_as(Rchol),
                                         upper=True)
    return Rinv @ Rinv.mT


def make_banded_precond(bop: BandedOperator, BD: BDRep,
                        w: Optional[torch.Tensor] = None,
                        smoother: str = "chain",
                        prev_state: Optional[PrecondState] = None,
                        use_prev: Optional[bool] = None,
                        return_state: bool = False,
                        kind: Optional[str] = None,
                        rebuild: Optional[bool] = None, sharded=None,
                        guards: Optional[dict] = None):
    """Two-level symmetric preconditioner for L(w) restricted to 1^perp.

    smoother: "chain" (the default; needs w unless a carried state gives
    its factor) is the exact solve of the odometry chain's tridiagonal
    part in the original node order, through the RCM permutation (kernel
    K1, its factor by K3/K3b); "bjacobi" solves
    the BS x BS RCM diagonal blocks exactly (batched products of their
    Cholesky inverses, no permutation), cheaper per application and weaker,
    leaving all coupling between blocks to the coarse level.

    kind: "mult", the symmetric V-cycle (smooth, coarse-correct the
    residual, smooth again: six permutation gathers with the chain
    smoother, two residual products), or "additive", M^-1 = S + P Lc^-1 R
    (both corrections read B: two gathers with the chain smoother, no
    residual product, weaker per iteration); None takes PRECOND_KIND.

    prev_state / use_prev / return_state: warm-rebuild protocol. With
    prev_state, use_prev=False builds the coarse inverse cold (Cholesky),
    use_prev=True refines prev_state.Lc_inv by Newton-Schulz (trace
    damping, a residual check against the damped start, and a cold rebuild
    when the carried inverse is not finite). return_state=True returns
    (precond_fn, PrecondState); block-Jacobi's state carries no chain
    factor.

    rebuild: with prev_state, False reuses prev_state as it is (coarse
    inverse and chain factor; block-Jacobi's block inverses are rebuilt);
    None always rebuilds.

    sharded: a mac_tpu_torch.parallel.sharded.ShardedBanded whose BD this
    is (the rank's ut rows, the whole deg): the residual products and the
    coarse operator then come from its row-sharded products, the diagonal
    blocks from each rank's own rows by one all-gather; the chain factor,
    the block inverses, the coarse inverse and Newton-Schulz stay
    replicated.

    guards: None reads Newton-Schulz's guard (is the damped start finite?)
    on the host and rebuilds cold when it fails. A dict (ops.graphs, whose
    captured set-up cannot read the host) takes the refined inverse and
    records the failed guard as a device flag in guards["ns_start_nonfinite"]
    instead; the caller redoes the step without `guards` when it is set.

    Returns a function (n, q) -> (n, q) in RCM order. With lanes (BD and w
    of R lanes, no prev_state), one smoother and one coarse level per lane,
    built by Cholesky, and a function (R, n, q) -> (R, n, q).
    """
    if rebuild is not None and prev_state is None:
        raise ValueError("rebuild cadence requires a carried PrecondState "
                         "(prev_state)")
    if smoother not in SMOOTHERS:
        raise ValueError(f"smoother {smoother!r} is not one of {SMOOTHERS}")
    if kind is None:
        kind = PRECOND_KIND
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    dtype = BD.ut.dtype
    dev = BD.ut.device
    s, nc = bop.coarse_s, bop.coarse_nc
    n, n_pad, nb = bop.n, bop.n_pad, bop.nb
    eps = torch.finfo(dtype).eps
    lead = BD.deg.shape[:-2]

    def pad(B):  # (..., n, q) -> (..., n_pad, q)
        return torch.cat([B, B.new_zeros((*lead, n_pad - n, B.shape[-1]))],
                         dim=-2)

    fac = None
    if smoother == "chain":
        if (prev_state is not None and rebuild is not None and not rebuild
                and prev_state.chain_dp is not None):
            fac = TridiagFactor(dp=prev_state.chain_dp, l=prev_state.chain_l,
                                seg=CHAIN_LDL_BLOCK if n > 4096 else None)
        elif w is None:
            raise ValueError("the 'chain' smoother needs the weight vector w "
                             "to build its factor")
        else:
            fac = chain_factor(bop, BD, w)

        def smooth(B):  # B in RCM order, (..., n, q)
            return tridiag_solve_factored_fast(
                fac, B[..., bop.iperm, :])[..., bop.perm, :]
    else:
        Dinv = bjacobi_inverse(diag_blocks(BD) if sharded is None
                               else sharded.diag_blocks(BD))

        def smooth(B):  # B in RCM order, (..., n, q)
            X = Dinv @ pad(B).reshape(*lead, nb, BS, B.shape[-1])
            return X.reshape(*lead, n_pad, -1)[..., :n, :]

    eye = torch.eye(nc, dtype=dtype, device=dev)

    def _assemble_Lc_reg():
        # Coarse operator Lc = R^T (L R): one banded apply on nc columns,
        # rows restricted through the permutation (aggregates live in the
        # original ordering).
        Rmat = (bop.agg[:n, None] == torch.arange(nc, dtype=bop.agg.dtype,
                                                  device=dev)[None, :]
                ).to(dtype)
        if sharded is not None:
            Lc = sharded.coarse(BD, Rmat)
        else:
            LR = banded_apply(bop, BD, Rmat.expand(*lead, n, nc))
            LRn = LR[..., bop.iperm, :]
            LRp = torch.cat([LRn, LRn.new_zeros((*lead, nc * s - n, nc))],
                            dim=-2)
            Lc = LRp.reshape(*lead, nc, s, nc).sum(dim=-2)
        Lc = (Lc + Lc.mT) / 2
        # Rank-one constant-mode shift makes Lc SPD; the 1%-of-trace jitter
        # dominates the assembly error.
        diag = torch.diagonal(Lc, dim1=-2, dim2=-1)
        cshift = (2.0 * diag.amax(dim=-1) + 1.0)[..., None, None]
        jit_c = (1e-2 * (batched_trace(Lc) / nc) + 100 * eps)[..., None, None]
        return Lc + (cshift / nc) * torch.ones_like(Lc) + jit_c * eye

    def _chol_from(Lc_reg):
        Rc = cholesky_upper(Lc_reg)
        Rc_inv = torch.linalg.solve_triangular(Rc, eye.expand_as(Rc),
                                               upper=True)
        return Rc_inv @ Rc_inv.mT

    def _ns_refine(Lc_reg, Xp):
        # Newton-Schulz from the previous step's inverse with three
        # safeguards: (1) trace damping pulls the spectrum of Lc_reg Xp into
        # the (0, 2) basin; (2) the refined iterate is kept only when it is
        # finite and its residual beats the damped start's; (3) a
        # non-finite start (a poisoned carry) rebuilds cold.
        tr = torch.sum(Lc_reg.T * Xp)  # trace(Lc_reg @ Xp)
        X0 = Xp * (nc / torch.clamp(tr, min=torch.finfo(dtype).tiny))
        X = X0
        for _ in range(NS_COARSE_STEPS):
            X = X @ (2.0 * eye - Lc_reg @ X)

        def resid(Y):
            R = eye - Lc_reg @ Y
            return torch.sum(R * R)

        ok = torch.isfinite(X).all() & (resid(X) < resid(X0))
        refined = torch.where(ok, X, X0)
        if guards is not None:
            guards["ns_start_nonfinite"] = ~torch.isfinite(X0).all()
            return refined
        if bool(torch.isfinite(X0).all()):
            return refined
        return _chol_from(Lc_reg)

    def _refresh(Xp):
        Lc_reg = _assemble_Lc_reg()
        if use_prev:
            return _ns_refine(Lc_reg, Xp)
        return _chol_from(Lc_reg)

    if prev_state is None:
        Lc_inv = _chol_from(_assemble_Lc_reg())
    elif rebuild is None or rebuild:
        Lc_inv = _refresh(prev_state.Lc_inv)
    else:
        Lc_inv = prev_state.Lc_inv

    def apply_fast(V):
        if sharded is not None:
            return sharded.apply(BD, V)
        return banded_apply(bop, BD, V)

    def center(B):
        return B - B.mean(dim=-2, keepdim=True)

    # The coarse aggregates live in the original node order.
    def restrict_nat(Bn):  # (..., n, q) original -> (..., nc, q)
        Bp = torch.cat([Bn, Bn.new_zeros((*lead, nc * s - n, Bn.shape[-1]))],
                       dim=-2)
        return Bp.reshape(*lead, nc, s, -1).sum(dim=-2)

    def prolong_nat(Xc):  # (..., nc, q) -> (..., n, q) original
        return torch.repeat_interleave(Xc, s, dim=-2)[..., :n, :]

    def restrict(Rv):  # (..., n, q) RCM -> (..., nc, q)
        return restrict_nat(Rv[..., bop.iperm, :])

    def prolong(Xc):  # (..., nc, q) -> (..., n, q) RCM
        return prolong_nat(Xc)[..., bop.perm, :]

    def precond(B):
        B = center(B)
        x = smooth(B)
        r = B - apply_fast(x)
        xc = Lc_inv @ restrict(r)
        x = x + prolong(xc)
        r2 = B - apply_fast(x)
        x = x + smooth(r2)
        return center(x)

    def precond_additive(B):
        B = center(B)
        if fac is not None:
            # The whole cycle in the original order: one gather in, the
            # chain solve and the coarse correction, one gather out.
            Bn = B[..., bop.iperm, :]
            xn = tridiag_solve_factored_fast(fac, Bn)
            xn = xn + prolong_nat(Lc_inv @ restrict_nat(Bn))
            return center(xn[..., bop.perm, :])
        return center(smooth(B) + prolong(Lc_inv @ restrict(B)))

    chosen = precond_additive if kind == "additive" else precond
    if kind == "mult" and fac is not None and sharded is None:
        chosen = VCycle(bop, BD, fac, Lc_inv, plain=precond)
    if return_state:
        if fac is None:
            return chosen, PrecondState(Lc_inv=Lc_inv)
        return chosen, PrecondState(Lc_inv=Lc_inv, chain_dp=fac.dp,
                                    chain_l=fac.l)
    return chosen


class VCycle:
    """make_banded_precond's symmetric V-cycle with the chain smoother
    (kind "mult", no mesh): smooth, coarse-correct the residual, smooth
    again, on the centred right-hand side, the result centred.

    `plain(B)` is make_banded_precond's cycle as PyTorch ops around the
    chain solve's kernel: the CPU's form, the reference's order. On the
    card the cycle is six launches of hand-written kernels, `cycle(R,
    rsum)`: K1p (the chain solve reading R's rows through the permutation,
    centred by R's column sums rsum), K5's residual form, K7's two
    (restrict, then the coarse product and the prolong-add into x), K5 and
    K1p adding into x, which returns x uncentred with its column sums
    (float64): pcg_fixed's K6 centres it on the fly. K1p takes the factor's
    `seg`: a factor decoupled every seg rows (every banded graph past 4096
    nodes, the budget sweep's lanes too) goes to its segment body, an exact
    one to its cluster body. Calling the cycle on CUDA tensors runs `cycle`
    (through _vcycle_kernels) and centres its result."""

    def __init__(self, bop: BandedOperator, BD: BDRep, fac: TridiagFactor,
                 Lc_inv: torch.Tensor, *, plain: Callable):
        self.bop, self.BD, self.fac, self.Lc_inv = bop, BD, fac, Lc_inv
        self._plain = plain

    def plain(self, B: torch.Tensor) -> torch.Tensor:
        return self._plain(B)

    def _smooth_kernels(self, B, bsum=None, X=None, sums=False):
        bop, fac = self.bop, self.fac
        dp = fac.dp if fac.dp.dtype == B.dtype else fac.dp.to(B.dtype)
        l = fac.l if fac.l.dtype == B.dtype else fac.l.to(B.dtype)
        return _k1.tridiag_solve_permuted(dp, l, B, bop.iperm, bop.perm,
                                          bsum=bsum, X=X, sums=sums,
                                          seg=fac.seg)

    def cycle(self, R: torch.Tensor, rsum: torch.Tensor):
        """The cycle's kernels on R (RCM order, contiguous) with its column
        sums rsum (float64): (x, x's column sums), x uncentred."""
        bop, BD = self.bop, self.BD
        x = self._smooth_kernels(R, bsum=rsum)
        r = _kb.banded_product(BD.ut, BD.deg, x, bop.n, B=R, bsum=rsum)
        x = _kb.coarse_correct(r, x, bop.iperm, bop.perm, self.Lc_inv,
                               bop.coarse_s)
        r2 = _kb.banded_product(BD.ut, BD.deg, x, bop.n, B=R, bsum=rsum)
        return self._smooth_kernels(r2, X=x, sums=True)

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        if B.is_cuda:
            return _vcycle_kernels(self, B)
        return self.plain(B)


def _vcycle_kernels(cyc: VCycle, B: torch.Tensor) -> torch.Tensor:
    """The cycle on the card, centred: K6's column sums of B, the cycle's
    kernels, and x less its column means."""
    B = B.contiguous()
    x, xsum = cyc.cycle(B, _kp.col_sums(B))
    return x - (xsum / cyc.bop.n).to(x.dtype).unsqueeze(-2)


"""Matrix-free weighted-Laplacian operators.

PyTorch counterpart of mac_tpu.ops.laplacian. L(w) = sum_e w_e (e_i - e_j)
(e_i - e_j)^T is never held as a sparse matrix on the device. Two apply
paths:

  * ``dense`` (n <= DENSE_MAX_N): L(w) materialised as an (n, n) matrix,
    applied by matrix products; small graphs also get an exact eigh.
  * ``ell``: padded adjacency (ELLPACK) tables of (neighbour, edge id) per
    node, and the difference-form gather apply
        (L(w) V)_i = sum_k w_ik (V_i - V_{nbr_ik}),
    kernel K8 on the card (mac_tpu_torch.ops.kernels.ell) over the tables
    held slot-major (dmax, n), each row walked to its filled slots, its
    plain version, the gather on the (q, n) layout, on the CPU;
    `EllProduct` gives it with TRACEMIN's shifted forms.

The tables are static per topology; only the weight vector changes across
Frank-Wolfe steps. Every function of w also takes R weight vectors w (R, m)
at once (the budget sweep: one operator per lane), with blocks V (R, n, q).
The operator also carries the bookkeeping of the two-grid preconditioner
(mac_tpu_torch.ops.twogrid): which edges join consecutive nodes (the chain
band) and each edge's coarse aggregates.
"""

from typing import Optional

import numpy as np
import torch

from mac_tpu_torch.ops.kernels import ell as _k8
from mac_tpu_torch.ops.kernels import pcg as _kp
from mac_tpu_torch.ops.lobpcg import Operator

# Graphs with n <= DENSE_MAX_N take the dense path; larger ones the ELL
# gather path (whose difference form is also the float32-stable one).
DENSE_MAX_N = 256
# Approximate coarse-grid size of the two-grid preconditioner.
TARGET_NC = 512

TABLES = ("idx", "nbr_tbl", "eid_tbl", "chain_slot", "chain_mask",
          "coarse_idx")


class GraphOperator:
    """Static per-topology data for matrix-free L(w) products.

    idx (m, 2): edge endpoints. nbr_tbl / eid_tbl (n, dmax): neighbour node
    and edge id per adjacency slot (ELL); padding slots point at node 0 and
    the sentinel edge m (weight 0). On the dense path both are (1, 1)
    placeholders. chain_slot (m,): the lower endpoint of an edge between
    consecutive nodes, else the sentinel n - 1; chain_mask (m,): whether it
    joins consecutive nodes. coarse_idx (m, 2): endpoints // coarse_s.
    Index tables are int64 tensors; `to(device)` returns a moved copy.
    Made with the operator, on its device (never inside a graph capture),
    the slot-major tables kernel K8 reads: slot_nbr (dmax, n) int32,
    nbr_tbl transposed; slot_eid (dmax, n), eid_tbl transposed, which
    lap_weight_table gathers the weights through; slot_count (n,) int32,
    each row's filled slots (those whose edge is not the sentinel; the
    padding follows them); and ident32, the identity permutation (n,)
    int32 that the V-cycle's kernels K1p and K7 take on this route.
    graph_routes: the eigensolver's routes on this operator and their
    captured CUDA graphs (mac_tpu_torch.ops.graphs), filled by the first
    solve.
    """

    def __init__(self, idx, nbr_tbl, eid_tbl, chain_slot, chain_mask,
                 coarse_idx, n: int, mode: str, coarse_s: int,
                 coarse_nc: int):
        self.idx, self.nbr_tbl, self.eid_tbl = idx, nbr_tbl, eid_tbl
        self.chain_slot, self.chain_mask = chain_slot, chain_mask
        self.coarse_idx = coarse_idx
        self.n = int(n)
        self.mode = mode
        self.coarse_s = int(coarse_s)
        self.coarse_nc = int(coarse_nc)
        self.slot_nbr = nbr_tbl.T.to(torch.int32).contiguous()
        self.slot_eid = eid_tbl.T.contiguous()
        self.slot_count = (eid_tbl != idx.shape[0]).sum(dim=1).to(
            torch.int32)
        self.ident32 = torch.arange(self.n, dtype=torch.int32,
                                    device=nbr_tbl.device)
        self.graph_routes = {}

    @property
    def m(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.idx.device

    def to(self, device) -> "GraphOperator":
        return GraphOperator(**{name: getattr(self, name).to(device)
                                for name in TABLES}, n=self.n,
                             mode=self.mode, coarse_s=self.coarse_s,
                             coarse_nc=self.coarse_nc)


def build_operator(idx: np.ndarray, num_nodes: int,
                   mode: Optional[str] = None,
                   target_nc: int = TARGET_NC) -> GraphOperator:
    """GraphOperator from an (m, 2) edge-index array, on the CPU.

    mode: 'dense', 'ell', or None (dense iff n <= DENSE_MAX_N).
    target_nc: approximate coarse-grid size (contiguous aggregates of
    s = ceil(n / target_nc) nodes).

    Slot order is that of the JAX package's loop: node v's slots follow its
    occurrences in (i_0, j_0, i_1, j_1, ...), so the tables are equal.
    """
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    n = int(num_nodes)
    m = idx.shape[0]
    if mode is None:
        mode = "dense" if n <= DENSE_MAX_N else "ell"
    if mode == "dense":
        nbr = np.zeros((1, 1), dtype=np.int64)
        eid = np.zeros((1, 1), dtype=np.int64)
    else:
        ends = idx.reshape(-1)               # i_0, j_0, i_1, j_1, ...
        others = idx[:, ::-1].reshape(-1)    # the other endpoint of each
        order = np.argsort(ends, kind="stable")
        counts = np.bincount(ends, minlength=n)
        dmax = max(int(counts.max(initial=0)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        node = ends[order]
        slot = np.arange(2 * m) - starts[node]
        nbr = np.zeros((n, dmax), dtype=np.int64)
        eid = np.full((n, dmax), m, dtype=np.int64)
        nbr[node, slot] = others[order]
        eid[node, slot] = order // 2
    lo = idx.min(axis=1) if m else np.zeros(0, np.int64)
    hi = idx.max(axis=1) if m else np.zeros(0, np.int64)
    is_chain = (hi - lo) == 1
    slot = np.where(is_chain, lo, max(n - 1, 0))
    s = max(1, int(np.ceil(n / target_nc)))
    nc = int(np.ceil(n / s))
    tables = dict(idx=idx, nbr_tbl=nbr, eid_tbl=eid, chain_slot=slot,
                  chain_mask=is_chain, coarse_idx=idx // s)
    return GraphOperator(**{k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in tables.items()}, n=n, mode=mode,
                         coarse_s=s, coarse_nc=nc)


def lap_dense(op: GraphOperator, w: torch.Tensor) -> torch.Tensor:
    """L(w) as a dense (n, n) matrix (one scatter-add); (R, n, n) for lanes."""
    n = op.n
    lead = w.shape[:-1]
    i, j = op.idx[:, 0], op.idx[:, 1]
    flat = torch.cat([i * n + j, j * n + i, i * n + i, j * n + j])
    vals = torch.cat([-w, -w, w, w], dim=-1)
    L = torch.zeros((*lead, n * n), dtype=w.dtype, device=w.device)
    return L.index_add_(-1, flat, vals).reshape(*lead, n, n)


def _w_pad(w: torch.Tensor) -> torch.Tensor:
    # sentinel edge m: weight 0
    return torch.cat([w, w.new_zeros((*w.shape[:-1], 1))], dim=-1)


def add_at(target: torch.Tensor, index: torch.Tensor,
           values: torch.Tensor) -> torch.Tensor:
    """target[..., index] += values along the last dimension, in place,
    with the leading (lane) dimensions of target and values in step;
    duplicate indices sum in a fixed order on every device (index_put_
    with accumulate sorts on CUDA, where index_add_'s atomics add in no
    fixed order, so a solve would not repeat itself bit for bit). On the
    CPU, float64 sums run in index order, as index_add_'s."""
    lead = target.shape[:-1]
    size = target.shape[-1]
    values = values.expand(*lead, index.shape[0])
    if lead:
        rows = torch.arange(target[..., 0].numel(), device=index.device)
        index = (rows[:, None] * size + index[None, :]).reshape(-1)
    target.view(-1).index_put_((index,), values.reshape(-1),
                               accumulate=True)
    return target


def lap_degrees(op: GraphOperator, w: torch.Tensor) -> torch.Tensor:
    """Weighted degrees deg_i = sum_{e ni i} w_e (the diagonal of L(w))."""
    if op.mode == "ell":
        return _w_pad(w)[..., op.eid_tbl].sum(dim=-1)
    deg = torch.zeros((*w.shape[:-1], op.n), dtype=w.dtype, device=w.device)
    return deg.index_add_(-1, op.idx[:, 0], w).index_add_(-1, op.idx[:, 1], w)


def lap_inf_norm(op: GraphOperator, w: torch.Tensor) -> torch.Tensor:
    """||L(w)||_inf = 2 max weighted degree (per lane)."""
    return 2.0 * lap_degrees(op, w).amax(dim=-1)


def lap_tridiagonal_part(op: GraphOperator, w: torch.Tensor,
                         deg: Optional[torch.Tensor] = None):
    """(d, e): the diagonal (weighted degrees) and the first off-diagonal
    band (minus the summed weights between consecutive nodes) of L(w).
    deg: the degrees when the caller has them (a sharded operator's)."""
    d = lap_degrees(op, w) if deg is None else deg
    lead = w.shape[:-1]
    if op.n <= 1:
        return d, torch.zeros((*lead, 1), dtype=w.dtype, device=w.device)
    # Non-chain edges add 0 at the sentinel slot n - 1, one past the band,
    # which is cut off (the JAX scatter drops it as out of range).
    wc = torch.where(op.chain_mask, w, torch.zeros_like(w))
    e = torch.zeros((*lead, op.n), dtype=w.dtype, device=w.device)
    return d, e.index_add_(-1, op.chain_slot, -wc)[..., :op.n - 1]


class EllProduct(Operator):
    """L(w) V on the ELL operator from its weight table w_tbl (dmax, n),
    or (R, dmax, n) for lanes (lane by lane; one table (dmax, n) serves
    every lane of V (R, n, q)), in the difference form (L V)_i = sum_k
    w_ik (V_i - V_nbr_ik), not the equivalent deg_i V_i - sum_k w_ik
    V_nbr_ik: smooth eigenvectors make the latter cancel two O(deg |V|)
    terms down to O(lambda |V|) in float32, while neighbour differences of
    close values are exact. Or TRACEMIN's shifted operators over it:
    L V + (c / n) 1 1^T V with c, and + sigma V with sigma too (c, sigma
    0-d, or (R,) with lanes), all through K8's wrapper (the kernel on the
    card, its plain version on the CPU): the counterpart of
    ops.banded.BandedProduct. `product` gives pcg_fixed K8's other forms
    (the residual B - A V, the column dots of V and A V), from V's column
    sums `vsum` (float64) where the shift needs them."""

    def __init__(self, op: GraphOperator, w_tbl: torch.Tensor,
                 c: Optional[torch.Tensor] = None,
                 sigma: Optional[torch.Tensor] = None):
        self.op, self.w_tbl, self.c, self.sigma = op, w_tbl, c, sigma

    def shifted(self, c: torch.Tensor,
                sigma: Optional[torch.Tensor] = None) -> "EllProduct":
        return EllProduct(self.op, self.w_tbl, c, sigma)

    def __call__(self, V: torch.Tensor) -> torch.Tensor:
        V = V.contiguous()  # the kernel reads each lane row-major
        if self.c is None:
            return self.product(V)
        return self.product(V, vsum=_kp.col_sums(V))

    def product(self, V: torch.Tensor, vsum: Optional[torch.Tensor] = None,
                B: Optional[torch.Tensor] = None,
                bsum: Optional[torch.Tensor] = None, dot: bool = False):
        """K8 on V: A V, or B - A V with B (centred by its column sums
        bsum, float64, when given); (that, the column dots of V and it)
        with dot. vsum: V's column sums (float64), which the shift needs
        (ignored without c)."""
        shifted = self.c is not None
        return _k8.ell_product(
            self.op.slot_nbr, self.op.slot_count, self.w_tbl, V, B=B,
            bsum=bsum, vsum=vsum if shifted else None, c=self.c,
            sigma=self.sigma if shifted else None, dot=dot)


def lap_apply(op: GraphOperator, w: torch.Tensor, V: torch.Tensor,
              L_dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L(w) @ V for V of shape (n, q); on the dense path a materialised
    L_dense may be passed to amortise its build."""
    if op.mode == "dense" and L_dense is not None:
        return L_dense @ V
    return lap_applier(op, w)(V)


def lap_apply_reduced(op: GraphOperator, w: torch.Tensor, V: torch.Tensor,
                      L_dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The node-0-pinned (reduced) Laplacian on full-length vectors: row 0
    of V and of the product taken as zero, so CG on full-length vectors
    solves the (n-1)-dimensional reduced system."""
    V0 = V.clone()
    V0[0] = 0.0
    out = lap_apply(op, w, V0, L_dense)
    out[0] = 0.0
    return out


def lap_weight_table(op: GraphOperator, w: torch.Tensor) -> torch.Tensor:
    """The ELL operator's weight table, slot-major as kernel K8 reads it:
    (dmax, n), (R, dmax, n) for lanes, each adjacency slot's edge weight,
    0 in padding; one gather a weight vector."""
    return _w_pad(w)[..., op.slot_eid]


def ell_applier(op: GraphOperator, w_tbl: torch.Tensor) -> EllProduct:
    """V -> L(w) @ V on the ELL operator, from its weight table: an
    EllProduct (kernel K8 on the card)."""
    return EllProduct(op, w_tbl)


def lap_applier(op: GraphOperator, w: torch.Tensor):
    """V -> L(w) @ V with the per-weight work (the dense matrix, or the
    ELL weight table) done once, for an eigensolve's many products."""
    if op.mode == "dense":
        L_dense = lap_dense(op, w)
        return lambda V: L_dense @ V
    return ell_applier(op, lap_weight_table(op, w))

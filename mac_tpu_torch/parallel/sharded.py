"""Sharded Laplacian products and Frank-Wolfe pieces over the 'graph'
dimension of a mesh (PyTorch counterpart of mac_tpu.parallel.sharded).

The eigenvector block V (n, q) and the weight vector stay replicated on
every rank; each rank holds only its share of the operator's tables:

  * ShardedLaplacian: node-row blocks of the ELL tables. A rank computes
    its output rows by the difference form from the replicated V, and one
    all-gather replicates the (n, q) product.
  * EdgeShardedLaplacian: edges dealt round-robin. A rank applies the
    Laplacian of its own edges (ELL tables over all n nodes), and one
    all-reduce sums the partial products.
  * ShardedBanded: block rows of the banded operator (mac_tpu_torch.ops.
    banded). A rank assembles its block rows and a halo of `half` rows
    above them through kernel K2/K2b on its slice of the slot tables,
    computes its degrees and output rows, and all-gathers them; its share
    of the coarse operator R^T L R is summed by one all-reduce, and its
    diagonal blocks (the block-Jacobi smoother's) all-gathered.
  * sharded_candidate_gradient and sharded_top_k_indicator: the
    supergradient over the rank's slice of the candidates, and the
    two-stage top-k LP oracle.

Each operator object is what fiedler_pair_op takes in place of the meshless
operator (mac_tpu_torch.utils.fiedler); `agree` is its group's agreement on
a loop decision (mesh.MeshGroup.agree). The JAX package leaves the
partitioning of the banded products to its compiler; here it is explicit.
"""

import numpy as np
import torch

from mac_tpu_torch.ops.banded import (BS, BandedOperator, BDRep, _deg_from_ut,
                                      banded_upper, dense_from_upper,
                                      diag_blocks)
from mac_tpu_torch.ops.banded import TABLES as BANDED_TABLES
from mac_tpu_torch.ops.kernels.assemble import assemble_ut
from mac_tpu_torch.ops.laplacian import (TABLES, GraphOperator, _w_pad,
                                         lap_tridiagonal_part)
from mac_tpu_torch.ops.twogrid import coarse_laplacian
from mac_tpu_torch.parallel.mesh import MeshGroup, pad_to_multiple


def _graph_group(mesh) -> MeshGroup:
    return mesh if isinstance(mesh, MeshGroup) else MeshGroup(mesh)


def _pad(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """t with zeros appended along `dim` up to `size` (the equal shares an
    all-gather needs)."""
    short = size - t.shape[dim]
    if short == 0:
        return t
    shape = list(t.shape)
    shape[dim] = short
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _ell_operator(op: GraphOperator, keep, device) -> GraphOperator:
    """The per-edge tables of `op` (endpoints, chain band, coarse
    aggregates) for the edges `keep` (a mask or a slice), on `device`,
    without ELL tables: a sharded operator's products and degrees come
    from its own tables."""
    none = torch.zeros((0, 0), dtype=torch.int64)
    tables = {name: getattr(op, name)[keep] for name in TABLES
              if name not in ("nbr_tbl", "eid_tbl")}
    return GraphOperator(**tables, nbr_tbl=none, eid_tbl=none, n=op.n,
                         mode=op.mode, coarse_s=op.coarse_s,
                         coarse_nc=op.coarse_nc).to(device)


class _EllShards:
    """What the two shardings of the ELL operator share: the replicated
    per-edge tables (`base`), the group's agreement, and the parts of the
    V-cycle that ops.twogrid builds by scatter-adds, built here from this
    rank's share of the edges (round-robin) and summed by an all-reduce,
    so that they are the same on every rank (index_add_ on CUDA adds in no
    fixed order, and the replicated V the sharded product needs must not
    drift apart across ranks)."""

    def __init__(self, op: GraphOperator, mesh):
        if op.mode != "ell":
            raise ValueError("a sharded product takes an ELL operator")
        self.group = _graph_group(mesh)
        self.n, self.m = op.n, op.m
        dev = self.group.device
        own = torch.arange(op.m) % self.group.size == self.group.rank
        self._own = own.nonzero().squeeze(1).to(dev)
        self._edges = _ell_operator(op, own, dev)
        self.base = _ell_operator(op, slice(None), dev)
        self.agree = self.group.agree

    def tridiagonal_part(self, w: torch.Tensor):
        """ops.laplacian.lap_tridiagonal_part of L(w), replicated."""
        d = self.degrees(w)
        _, e = lap_tridiagonal_part(self._edges, w[..., self._own], d)
        return d, self.group.all_reduce(e)

    def coarse_laplacian(self, w: torch.Tensor) -> torch.Tensor:
        """ops.twogrid.coarse_laplacian of L(w), replicated."""
        return self.group.all_reduce(
            coarse_laplacian(self._edges, w[..., self._own]))


def _ell_rows(nbr: torch.Tensor, w_tbl: torch.Tensor, Vt: torch.Tensor,
              Vrows: torch.Tensor) -> torch.Tensor:
    """sum_k w_ik (V_i - V_nbr_ik) for the rows of an ELL table, in the
    (q, n) gather layout of ops.kernels.ell.ell_product_plain: Vt (..., q, n) the
    whole block, Vrows (..., q, rows) the table's own rows. Returns
    (..., rows, q)."""
    rows, dmax = nbr.shape
    Vd = Vrows[..., None] - Vt[..., nbr.reshape(-1)].reshape(
        *Vt.shape[:-1], rows, dmax)
    return (Vd * w_tbl.unsqueeze(-3)).sum(dim=-1).mT


class ShardedLaplacian(_EllShards):
    """Node-row-sharded ELL product over the 'graph' dimension of a mesh.

    op: the GraphOperator in ELL mode, on the host. Its rows are padded to
    a multiple of the group size (padding rows point at node 0 and the
    sentinel edge m, so they produce exact zeros and are cut off after the
    gather); this rank keeps rows [rank blk, (rank + 1) blk) of nbr_tbl and
    eid_tbl on its device."""

    def __init__(self, op: GraphOperator, mesh):
        super().__init__(op, mesh)
        g, r, dev = self.group.size, self.group.rank, self.group.device
        nbr, _ = pad_to_multiple(op.nbr_tbl.numpy(), g, axis=0, fill=0)
        eid, _ = pad_to_multiple(op.eid_tbl.numpy(), g, axis=0, fill=op.m)
        self.n_pad = nbr.shape[0]
        self.blk = self.n_pad // g
        rows = slice(r * self.blk, (r + 1) * self.blk)
        self.nbr_tbl = torch.as_tensor(nbr[rows], device=dev)
        self.eid_tbl = torch.as_tensor(eid[rows], device=dev)

    def degrees(self, w: torch.Tensor) -> torch.Tensor:
        """Weighted degrees (n,) (per lane for w (R, m)), replicated."""
        deg = _w_pad(w)[..., self.eid_tbl].sum(dim=-1)
        return self.group.all_gather(deg, dim=-1)[..., :self.n]

    def applier(self, w: torch.Tensor):
        """V (n, q) -> L(w) V, replicated (lanes: w (R, m), V (R, n, q))."""
        w_tbl = _w_pad(w)[..., self.eid_tbl]
        lo = self.group.rank * self.blk

        def apply(V):
            n = V.shape[-2]
            Vt = V.mT.contiguous()
            if self.n_pad != n:
                Vt = torch.cat([Vt, Vt.new_zeros(
                    (*Vt.shape[:-1], self.n_pad - n))], dim=-1)
            out = _ell_rows(self.nbr_tbl, w_tbl, Vt,
                            Vt[..., lo:lo + self.blk])
            return self.group.all_gather(out, dim=-2)[..., :n, :]

        return apply

    def apply(self, w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """L(w) @ V with V (n, q); returns (n, q), replicated."""
        return self.applier(w)(V)


def edge_shard_tables(idx: np.ndarray, n: int, g: int):
    """ELL tables (nbr, eid), each (g, n, dmax), of the g round-robin edge
    shards (edge t in shard t mod g), over all n nodes: eid holds global
    edge ids, padding slots node 0 and the sentinel m. dmax is the largest
    degree of any shard (at least 1). Node v's slots in a shard follow its
    occurrences in (i_t, j_t) over the shard's edges in ascending t: the
    slot order of the JAX package's loop."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1, 2)
    m = idx.shape[0]
    shard = np.repeat(np.arange(m) % g, 2)
    ends = idx.reshape(-1)
    others = idx[:, ::-1].reshape(-1)
    key = shard * n + ends                    # (shard, node) of each slot
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=g * n)
    dmax = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(2 * m) - starts[key[order]]
    nbr = np.zeros((g * n, dmax), dtype=np.int64)
    eid = np.full((g * n, dmax), m, dtype=np.int64)
    nbr[key[order], slot] = others[order]
    eid[key[order], slot] = order // 2
    return nbr.reshape(g, n, dmax), eid.reshape(g, n, dmax)


class EdgeShardedLaplacian(_EllShards):
    """Edge-sharded product over the 'graph' dimension: edges dealt
    round-robin, this rank's shard as ELL tables over all n nodes (global
    edge ids, edge_shard_tables), a partial product per rank and one
    all-reduce (sum). Per-rank gather work scales with m / g; the
    collective moves (n, q) floats."""

    def __init__(self, op: GraphOperator, mesh):
        super().__init__(op, mesh)
        nbr, eid = edge_shard_tables(op.idx.numpy(), op.n, self.group.size)
        r, dev = self.group.rank, self.group.device
        self.nbr_tbl = torch.as_tensor(nbr[r], device=dev)
        self.eid_tbl = torch.as_tensor(eid[r], device=dev)

    def degrees(self, w: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(_w_pad(w)[..., self.eid_tbl].sum(dim=-1))

    def applier(self, w: torch.Tensor):
        w_tbl = _w_pad(w)[..., self.eid_tbl]

        def apply(V):
            Vt = V.mT.contiguous()
            return self.group.all_reduce(
                _ell_rows(self.nbr_tbl, w_tbl, Vt, Vt))

        return apply

    def apply(self, w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """L(w) @ V, summed over the shards; V (n, q) -> (n, q)."""
        return self.applier(w)(V)


class ShardedBanded:
    """Block-row-sharded banded operator over the 'graph' dimension.

    bop: the BandedOperator on the host. Rank r owns output block rows
    [b0, b1) of the nb (ceil(nb / g) each, the last rank fewer); output
    block b reads ut[t][b] and ut[t][b - t] for t <= half, so the rank
    assembles ut block rows [h0, b1), h0 = max(b0 - half, 0): its own rows
    and a halo. `bop` here is a BandedOperator whose slot tables are that
    slice (the kernel's columns are per block row, so a slice assembles
    the same rows as the whole) and whose other tables (permutation,
    aggregates, chain edges) are whole and replicated."""

    def __init__(self, bop: BandedOperator, mesh):
        self.group = _graph_group(mesh)
        g, r = self.group.size, self.group.rank
        nb, half = bop.nb, bop.half
        if nb < g:
            raise ValueError(f"the banded operator has {nb} block rows, "
                             f"fewer than the {g} ranks of 'graph'")
        self.nb_loc = -(-nb // g)
        self.b0 = min(r * self.nb_loc, nb)
        self.b1 = min(self.b0 + self.nb_loc, nb)
        self.h0 = max(self.b0 - half, 0)
        cols = slice(self.h0 * BS, self.b1 * BS)
        blocks = slice(self.h0, self.b1)
        tables = {name: getattr(bop, name).numpy() for name in BANDED_TABLES}
        for name in ("ueid_tbl", "dcol_tbl"):
            tables[name] = tables[name][:, cols]
        for name in ("oeid_tbl", "ocol_tbl", "olane_tbl"):
            tables[name] = tables[name][:, blocks]
        self.bop = BandedOperator(
            tables, n=bop.n, nb=nb, ndiag=bop.ndiag, coarse_s=bop.coarse_s,
            coarse_nc=bop.coarse_nc, du_dense=bop.du_dense,
            ov_rows=bop.ov_rows).to(self.group.device)
        self.agree = self.group.agree

    def assemble(self, w: torch.Tensor) -> BDRep:
        """BD(w) for this rank: ut of block rows [h0, b1) (K2/K2b on the
        sliced tables, as ops.banded.assemble_bd gathers them) and the
        whole degree vector (nb, BS), replicated by an all-gather of every
        rank's own rows. Lanes: w (R, m)."""
        bop = self.bop
        w_pad = torch.cat([-w, w.new_zeros((*w.shape[:-1], 1))], dim=-1)
        dd = bop.du_dense
        ut = assemble_ut(bop.dcol_tbl[:dd], w_pad[..., bop.ueid_tbl[:dd]],
                         bop.ocol_tbl, bop.olane_tbl,
                         w_pad[..., bop.oeid_tbl], bop.half,
                         self.b1 - self.h0)
        deg = _pad(_deg_from_ut(ut)[..., self.b0 - self.h0:, :], dim=-2,
                   size=self.nb_loc)
        deg = self.group.all_gather(deg, dim=-2)[..., :bop.nb, :]
        return BDRep(ut=ut, deg=deg)

    def _rows(self, BD: BDRep, V: torch.Tensor) -> torch.Tensor:
        """Output block rows [b0, b1) of ops.banded.banded_apply, from the
        rank's ut rows and the replicated V (n, q): (..., (b1 - b0) BS,
        q)."""
        bop = self.bop
        lead, (n, q) = V.shape[:-2], V.shape[-2:]
        nb, half, ndiag, n_pad = bop.nb, bop.half, bop.ndiag, bop.n_pad
        b0, h0, nr = self.b0, self.h0, self.b1 - self.b0
        ut, deg = BD.ut, BD.deg
        if n_pad != n:
            V = torch.cat([V, V.new_zeros((*lead, n_pad - n, q))], dim=-2)
        Vb = V.reshape(*lead, nb, BS, q)
        zpad = Vb.new_zeros((*lead, half, BS, q))
        Vp = torch.cat([zpad, Vb, zpad], dim=-3)

        def blocks(o):  # for block b of the rank, block b + o - half of V
            return Vp[..., b0 + o:b0 + o + nr, :, :]

        if V.numel() // n_pad * ndiag * n_pad > 64 * 1024 * 1024:
            S = Vp.sum(dim=-2)
            C = torch.cat([S.new_zeros((*lead, 1, q)),
                           torch.cumsum(S, dim=-2)], dim=-2)
            cb = ((C[..., ndiag:, :] - C[..., :-ndiag, :])
                  / (ndiag * BS))[..., b0:b0 + nr, :].unsqueeze(-2)
        else:
            win = torch.stack([blocks(o) for o in range(ndiag)], dim=0)
            cb = win.mean(dim=(0, -2)).unsqueeze(-2)
        Vc0 = blocks(half) - cb
        own = slice(b0 - h0, b0 - h0 + nr)
        ut0 = ut[..., 0, own, :, :]
        out = deg[..., b0:b0 + nr, :].unsqueeze(-1) * Vc0
        out = out + torch.matmul(ut0.transpose(-1, -2), Vc0)
        out = out + torch.matmul(ut0, Vc0)
        for t in range(1, half + 1):
            utt = ut[..., t, :, :, :]
            out = out + torch.matmul(utt[..., own, :, :].transpose(-1, -2),
                                     blocks(half + t) - cb)
            lo = b0 - t - h0  # local row of block b0 - t, < 0 above block 0
            utsh = utt[..., max(lo, 0):lo + nr, :, :]
            if lo < 0:
                utsh = torch.cat([ut.new_zeros((*lead, -lo, BS, BS)), utsh],
                                 dim=-3)
            out = out + torch.matmul(utsh, blocks(half - t) - cb)
        return out.reshape(*lead, nr * BS, q)

    def apply(self, BD: BDRep, V: torch.Tensor) -> torch.Tensor:
        """L(w) @ V (lanes: (R, n, q)), replicated: the rank's block rows,
        all-gathered."""
        n = V.shape[-2]
        out = _pad(self._rows(BD, V), dim=-2, size=self.nb_loc * BS)
        return self.group.all_gather(out, dim=-2)[..., :n, :]

    def coarse(self, BD: BDRep, Rmat: torch.Tensor) -> torch.Tensor:
        """The coarse operator R^T L R (..., nc, nc) for the restriction
        Rmat (n, nc) (RCM rows): each rank's R^T[:, rows] (L R)[rows, :]
        over its own rows, summed by one all-reduce."""
        lead = BD.ut.shape[:-4]
        n = Rmat.shape[0]
        lo, hi = min(self.b0 * BS, n), min(self.b1 * BS, n)
        LR = self._rows(BD, Rmat.expand(*lead, *Rmat.shape))
        return self.group.all_reduce(Rmat[lo:hi].mT @ LR[..., :hi - lo, :])

    def diag_blocks(self, BD: BDRep) -> torch.Tensor:
        """The diagonal blocks of L(w) (..., nb, BS, BS), replicated (ops.
        banded.diag_blocks of the whole operator): each rank's blocks of
        its own rows, all-gathered."""
        own = BD._replace(ut=BD.ut[..., self.b0 - self.h0:, :, :],
                          deg=BD.deg[..., self.b0:self.b1, :])
        D = _pad(diag_blocks(own), dim=-3, size=self.nb_loc)
        return self.group.all_gather(D, dim=-3)[..., :self.bop.nb, :, :]

    def dense(self, BD: BDRep) -> torch.Tensor:
        """L(w) dense (..., n, n) in RCM ids, replicated (ops.banded.
        banded_dense): each rank's upper blocks of its own rows, summed by
        one all-reduce (every entry comes from one rank)."""
        own = BD.ut[..., self.b0 - self.h0:, :, :]
        U = self.group.all_reduce(banded_upper(own, self.bop.nb, self.b0))
        return dense_from_upper(U, BD.deg, self.bop.n)


def sharded_candidate_gradient(mesh, cand_idx, w_cand, v):
    """Per-candidate supergradient grad_e = w_e (v_i - v_j)^2 from the
    replicated Fiedler vector v (n,) (lanes: (R, n)): each rank of 'graph'
    takes its slice of the candidates padded to a multiple of the group
    size (padding weight 0), and one all-gather replicates the (m,) result.
    mesh: a DeviceMesh or its mesh.MeshGroup."""
    grp = _graph_group(mesh)
    m = cand_idx.shape[0]
    blk = -(-m // grp.size)
    lo, hi = min(grp.rank * blk, m), min((grp.rank + 1) * blk, m)
    idx = torch.as_tensor(cand_idx[lo:hi], device=v.device)
    w = torch.as_tensor(w_cand, device=v.device)[..., lo:hi]
    d = v[..., idx[:, 0]] - v[..., idx[:, 1]]
    part = _pad(w * d * d, dim=-1, size=blk)
    return grp.all_gather(part, dim=-1)[..., :m]


def sharded_top_k_indicator(mesh, scores: torch.Tensor, k: int
                            ) -> torch.Tensor:
    """0/1 indicator (m,) of the k largest scores, replicated, by the
    two-stage distributed top-k: each rank of 'graph' takes the top
    min(k, m_pad / g) of its slice (padding -inf) with global ids, the
    survivors are all-gathered in rank order, and the global top k is
    taken among them. Both stages sort stably, so ties go to the lower
    global id (rank r's ids all lie below rank r + 1's), as
    optimization.constraints.solve_subset_box_lp breaks them; k <= 0
    selects nothing and k >= m everything. mesh: a DeviceMesh or its
    mesh.MeshGroup."""
    m = scores.shape[0]
    k = int(k)
    if k <= 0:
        return torch.zeros_like(scores)
    if k >= m:
        return torch.ones_like(scores)
    grp = _graph_group(mesh)
    blk = -(-m // grp.size)
    base = grp.rank * blk
    s = scores[min(base, m):min(base + blk, m)]
    s = torch.cat([s, s.new_full((blk - s.shape[0],), float("-inf"))])
    kk = min(k, blk)
    loc = torch.sort(s, descending=True, stable=True).indices[:kk]
    vals = grp.all_gather(s[loc], dim=0)
    ids = grp.all_gather(loc + base, dim=0)
    top = torch.sort(vals, descending=True, stable=True).indices[:k]
    out = torch.zeros((blk * grp.size,), dtype=scores.dtype,
                      device=scores.device)
    out[ids[top]] = 1.0
    return out[:m]

"""GreedyESP: greedy tree-connectivity (k-ESP+) edge selection (PyTorch
counterpart of mac_tpu.solvers.greedy_esp).

Each step adds the candidate with the largest weighted effective resistance
r_e = w_e a_e^T L_S^-1 a_e against the selected graph S. Everything comes
from the Gram matrix G[p, e] = a_p^T L_fixed^-1 a_e through the Woodbury
identity: with an incremental Cholesky row of M_S = W_S^-1 + G[S, S] per
selection, the unweighted resistances are q = diag(G) - colnorm^2(U), and
each step is dense vector algebra. The (m, m) Gram matrix is never held.

Gram sources, picked from the inputs:
  * a fixed graph that is an odometry chain covering every node (every
    bundled dataset): the closed form over cumulative chain resistances,
    no solve at all (_chain_rcum);
  * otherwise Z = L_fixed^-1 A by chunked batched solves on the device
    (the exact tridiagonal solve when the fixed graph is its own exact
    tridiagonal part, else PCG preconditioned by it), held on the host,
    float32 past Z_F32_THRESHOLD candidates;
  * past z_budget_bytes of Z, streaming: the Gram diagonal from chunked
    solves reduced on the device, and one solve per committed pivot.

Selection cores, with the same gates as the JAX package: the scan on the
device above SCAN_MIN_WORK candidate-times-budget entries (one
(t,) @ (t, m) product a step, a Python loop that never waits for the
device), the native lazy core of native/esp_lazy.cc, then a numpy loop.

The default dtype is float64 on any device: the selection consumes
resistances at 1e-10 relative accuracy. Its chain solves take the plain
scans (tridiag_solve_factored_fast's rule for float64), so GreedyESP
launches no hand-written kernel.
"""

import heapq
from timeit import default_timer as timer
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mac_tpu_torch import native
from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops.cg import pcg
from mac_tpu_torch.ops.laplacian import (build_operator, lap_apply_reduced,
                                         lap_dense, lap_tridiagonal_part)
from mac_tpu_torch.ops.tridiag import (TRIDIAG_SCAN_MAX_N, tridiag_ldl_auto,
                                       tridiag_solve_factored_fast)
from mac_tpu_torch.utils.graphs import Edge, edges_to_arrays

# Past this many candidates Z, and the device scan's Cholesky rows U, are
# stored float32; at or below it both are float64 and the selection is
# exact.
Z_F32_THRESHOLD = 4096

# Past this host footprint of the dense (n, m) Z a non-chain problem runs
# in streaming mode (see the module docstring).
Z_HOST_BUDGET_BYTES = 2 << 30


def compute_weighted_effective_resistances(
        xuv_arr: np.ndarray, xuv_edge_weights: np.ndarray) -> np.ndarray:
    """w_e ||x_e||^2 for solve vectors stored in rows."""
    return (np.linalg.norm(xuv_arr, axis=1) ** 2) * xuv_edge_weights


def find_idx_with_max_weighted_effective_resistance(
        xuv_arr: np.ndarray, xuv_edge_weights: np.ndarray) -> int:
    """Row index with the largest weighted effective resistance."""
    return int(np.argmax(
        compute_weighted_effective_resistances(xuv_arr, xuv_edge_weights)))


class GreedyESP:
    """Greedy k-ESP+ edge selection by batched solves and Gram-Woodbury.

    fixed_edges, candidate_edges: lists of Edge, or (idx, w) array pairs.
    lazy: subset() runs the lazy sweep. cg_tol, cg_maxiter: the batched
    PCG solves of the non-chain Gram sources, in columns of `chunk`.
    dtype: float64 by default on any device. z_budget_bytes: the host
    budget of the dense Z (Z_HOST_BUDGET_BYTES by default); a non-chain
    problem past it runs in streaming mode. device: where the solves and
    the scan run, "cuda" by default; "cpu" runs the plain PyTorch versions.
    """

    # Below this many candidate-times-budget entries the host cores win.
    SCAN_MIN_WORK = 2_000_000

    def __init__(self, fixed_edges, candidate_edges, num_nodes: int,
                 lazy: bool = False, cg_tol: float = 1e-10,
                 cg_maxiter: int = 2000, chunk: int = 512, dtype=None,
                 z_budget_bytes: Optional[int] = None, device="cuda"):
        fixed_idx, w_fixed = edges_to_arrays(fixed_edges)
        cand_idx, w_cand = edges_to_arrays(candidate_edges)
        if num_nodes == 0 and (len(fixed_idx) or len(cand_idx)):
            raise ValueError("edges given for a graph of 0 nodes")
        self.device = resolve_device(device)
        self.num_nodes = int(num_nodes)
        self.fixed_edges = fixed_edges
        self.all_candidate_edges = (
            candidate_edges if isinstance(candidate_edges, list)
            else [Edge(int(i), int(j), float(w))
                  for (i, j), w in zip(cand_idx, w_cand)])
        self.edge_weights = np.asarray(w_cand, dtype=np.float64)
        self.cand_idx = cand_idx
        self.lazy = lazy
        self.cg_tol = float(cg_tol)
        self.cg_maxiter = int(cg_maxiter)
        self.chunk = int(chunk)
        self.dtype = torch.float64 if dtype is None else dtype
        self._op_fixed = build_operator(fixed_idx, self.num_nodes).to(
            self.device)
        self._w_fixed = torch.as_tensor(w_fixed, dtype=self.dtype,
                                        device=self.device)
        # A pure odometry chain covering every position has closed-form
        # Gram entries (_chain_rcum): no solve at all.
        self._fixed_is_chain = False
        if len(fixed_idx) > 0 and self.num_nodes > 1:
            fi = fixed_idx.astype(np.int64)
            if np.all(np.abs(fi[:, 0] - fi[:, 1]) == 1):
                w_chain = np.zeros(self.num_nodes - 1)
                np.add.at(w_chain, fi.min(axis=1),
                          np.asarray(w_fixed, np.float64))
                if np.all(w_chain > 0):
                    self._fixed_is_chain = True
                    self._chain_w = w_chain
        self._Z: Optional[np.ndarray] = None
        self._rcum: Optional[np.ndarray] = None
        self.z_budget_bytes = (Z_HOST_BUDGET_BYTES if z_budget_bytes is None
                               else int(z_budget_bytes))
        # Streaming caches: the Gram diagonal, and one Gram column per
        # committed pivot (O(k m) in all).
        self._qdiag: Optional[np.ndarray] = None
        self._gcols: dict = {}

    def _z_streaming(self) -> bool:
        """True when the dense (n, m) Z would pass the host budget (never
        for a chain, which needs no Z)."""
        if self._fixed_is_chain:
            return False
        m = len(self.edge_weights)
        itemsize = 4 if m > Z_F32_THRESHOLD else 8
        return self.num_nodes * m * itemsize > self.z_budget_bytes

    # ------------------------------------------------------------ device part

    def _fixed_precond(self, op=None, w=None):
        """The pinned tridiagonal-part solve of L(op, w) (the fixed graph by
        default) as a preconditioner: the factor of the part shifted by
        100 eps max(d), built once."""
        if op is None:
            op, w = self._op_fixed, self._w_fixed
        d, e = lap_tridiagonal_part(op, w)
        eps = 100 * torch.finfo(w.dtype).eps
        fac = tridiag_ldl_auto(d[1:] + eps * d.max(), e[1:])
        return lambda V: torch.cat([V.new_zeros((1, V.shape[1])),
                                    tridiag_solve_factored_fast(fac, V[1:])])

    def _solve_columns(self, B: torch.Tensor, op=None, w=None,
                       Minv=None) -> torch.Tensor:
        """L_reduced^-1 B on full-length vectors (node 0 pinned), for the
        fixed Laplacian by default or for (op, w). A fixed chain of at most
        TRIDIAG_SCAN_MAX_N nodes is solved directly by its exact factor;
        past that size the factor is segment-decoupled, a preconditioner
        only, and everything else takes PCG preconditioned by the
        tridiagonal part (Minv, when given, is that preconditioner)."""
        direct = op is None and self._fixed_is_chain
        if op is None:
            op, w = self._op_fixed, self._w_fixed
        if direct and self.num_nodes <= TRIDIAG_SCAN_MAX_N:
            d, e = lap_tridiagonal_part(op, w)
            fac = tridiag_ldl_auto(d[1:], e[1:])
            return torch.cat([B.new_zeros((1, B.shape[1])),
                              tridiag_solve_factored_fast(fac, B[1:])])
        if Minv is None:
            Minv = self._fixed_precond(op, w)
        L_dense = lap_dense(op, w) if op.mode == "dense" else None
        return pcg(lambda V: lap_apply_reduced(op, w, V, L_dense), B, Minv,
                   tol=self.cg_tol, maxiter=self.cg_maxiter).X

    def _incidence(self, uc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
        """(n, len(uc)) one-hot differences e_u - e_v built on the device,
        row 0 zero (padding columns u = v = 0 are zero)."""
        iota = torch.arange(self.num_nodes, device=self.device)[:, None]
        B = ((iota == uc[None, :]).to(self.dtype)
             - (iota == vc[None, :]).to(self.dtype))
        B[0] = 0.0  # the pinned node
        return B

    def _chunks(self):
        """(start, count, u, v) of the candidates in chunks of `chunk`,
        each (u, v) padded to `chunk` with u = v = 0, on the device."""
        m = len(self.edge_weights)
        u = torch.as_tensor(self.cand_idx[:, 0].astype(np.int64))
        v = torch.as_tensor(self.cand_idx[:, 1].astype(np.int64))
        for s in range(0, m, self.chunk):
            c = min(self.chunk, m - s)
            pad = torch.zeros(self.chunk - c, dtype=torch.int64)
            yield (s, c, torch.cat([u[s:s + c], pad]).to(self.device),
                   torch.cat([v[s:s + c], pad]).to(self.device))

    def _compute_Z(self) -> np.ndarray:
        """Z = L_fixed_reduced^-1 A for all candidates, by chunked batched
        solves with right-hand sides built on the device; held on the host,
        float32 past Z_F32_THRESHOLD candidates."""
        if self._Z is not None:
            return self._Z
        m = len(self.edge_weights)
        store = torch.float32 if m > Z_F32_THRESHOLD else torch.float64
        Z = np.empty((self.num_nodes, m),
                     dtype=np.float32 if store == torch.float32
                     else np.float64)
        Minv = self._fixed_precond()
        for s, c, uc, vc in self._chunks():
            Y = self._solve_columns(self._incidence(uc, vc), Minv=Minv)
            Z[:, s:s + c] = Y[:, :c].to(store).cpu().numpy()
        self._Z = Z
        return Z

    def _gram_diag_streaming(self) -> np.ndarray:
        """diag(G), the effective resistances of all candidates, without Z:
        each chunk's (n, chunk) solution is reduced to its diagonal Gram
        entries on the device, so only (chunk,) vectors reach the host."""
        if self._qdiag is not None:
            return self._qdiag
        q = np.empty(len(self.edge_weights), dtype=np.float64)
        Minv = self._fixed_precond()
        for s, c, uc, vc in self._chunks():
            Y = self._solve_columns(self._incidence(uc, vc), Minv=Minv)
            cols = torch.arange(uc.shape[0], device=self.device)
            q[s:s + c] = (Y[uc, cols] - Y[vc, cols]).double()[:c].cpu().numpy()
        self._qdiag = q
        return q

    def _pivot_gram_col(self, p: int) -> np.ndarray:
        """G[p, :] by one solve y = L_fixed^-1 a_p, reduced to y[u] - y[v]
        on the device; cached per committed pivot (streaming mode)."""
        col = self._gcols.get(int(p))
        if col is not None:
            return col
        u = torch.as_tensor(self.cand_idx[:, 0].astype(np.int64),
                            device=self.device)
        v = torch.as_tensor(self.cand_idx[:, 1].astype(np.int64),
                            device=self.device)
        y = self._solve_columns(self._incidence(u[p:p + 1], v[p:p + 1]))[:, 0]
        col = (y[u] - y[v]).double().cpu().numpy()
        self._gcols[int(p)] = col
        return col

    def _chain_rcum(self) -> np.ndarray:
        """Cumulative chain resistances rcum[k] = sum_{i<k} 1 / w_chain[i];
        then a_p^T L_fixed^-1 a_e = max(0, rcum[min(hi_p, hi_e)] -
        rcum[max(lo_p, lo_e)]), the path-overlap identity."""
        if self._rcum is None:
            self._rcum = np.concatenate(
                [[0.0], np.cumsum(1.0 / self._chain_w)])
        return self._rcum

    def _gram_row(self, Z: Optional[np.ndarray], p: int) -> np.ndarray:
        """G[p, :] in float64: closed form, from Z, or (streaming, Z None)
        from one pivot solve."""
        if self._fixed_is_chain:
            lo = np.minimum(self.cand_idx[:, 0], self.cand_idx[:, 1])
            hi = np.maximum(self.cand_idx[:, 0], self.cand_idx[:, 1])
            lo, hi = lo.astype(np.int64), hi.astype(np.int64)
            rc = self._chain_rcum()
            return np.maximum(
                0.0, rc[np.minimum(hi[p], hi)] - rc[np.maximum(lo[p], lo)])
        if Z is None:
            return self._pivot_gram_col(p)
        u, v = int(self.cand_idx[p, 0]), int(self.cand_idx[p, 1])
        return Z[u].astype(np.float64) - Z[v].astype(np.float64)

    def _gram_diag(self, Z: Optional[np.ndarray]) -> np.ndarray:
        u = self.cand_idx[:, 0].astype(np.int64)
        v = self.cand_idx[:, 1].astype(np.int64)
        if self._fixed_is_chain:
            rc = self._chain_rcum()
            return rc[np.maximum(u, v)] - rc[np.minimum(u, v)]
        if Z is None:
            return self._gram_diag_streaming()
        cols = np.arange(len(self.edge_weights))
        return Z[u, cols].astype(np.float64) - Z[v, cols].astype(np.float64)

    # ---------------------------------------------------- parity helpers

    def _augmented_operator(self, selected=None):
        """(op, w) of L_S = L_fixed + the selected candidates. `selected`:
        a boolean or floating mask over all m candidates, or integer
        candidate indices."""
        if selected is None or len(np.atleast_1d(selected)) == 0:
            return self._op_fixed, self._w_fixed
        sel = np.asarray(selected)
        if sel.dtype == bool or np.issubdtype(sel.dtype, np.floating):
            if sel.shape[0] != len(self.edge_weights):
                raise ValueError("a mask-valued `selected` must cover all "
                                 "candidates")
            sel_idx = np.flatnonzero(sel)
        else:
            sel_idx = sel.astype(np.int64)
        fixed_idx, w_fixed = edges_to_arrays(self.fixed_edges)
        idx = np.concatenate([fixed_idx, self.cand_idx[sel_idx]], axis=0)
        w = np.concatenate([w_fixed, self.edge_weights[sel_idx]])
        op = build_operator(idx, self.num_nodes).to(self.device)
        return op, torch.as_tensor(w, dtype=self.dtype, device=self.device)

    def get_all_xuv(self, M_idxs, selected=None):
        """Solve vectors of the candidates in M_idxs against the reduced
        Laplacian of the fixed and `selected` edges: (rows
        (len(M_idxs), num_nodes), M_idxs as int32). Each row is the solve
        y = L_S^-1 a_uv rescaled so that ||x_uv||^2 = a_uv^T L_S^-1 a_uv,
        the effective resistance; entry 0 (the pinned node) is 0."""
        M_idxs = np.asarray(sorted(M_idxs) if isinstance(M_idxs, set)
                            else M_idxs, dtype=np.int64).ravel()
        op, w = self._augmented_operator(selected)
        n = self.num_nodes
        u = self.cand_idx[M_idxs, 0].astype(np.int64)
        v = self.cand_idx[M_idxs, 1].astype(np.int64)
        Minv = self._fixed_precond(op, w)
        rows = np.zeros((len(M_idxs), n), dtype=np.float64)
        for s in range(0, len(M_idxs), self.chunk):
            t = min(s + self.chunk, len(M_idxs))
            cols = np.arange(t - s)
            B = np.zeros((n, self.chunk), dtype=np.float64)
            B[u[s:t], cols] += 1.0
            B[v[s:t], cols] -= 1.0
            B[0, :] = 0.0
            Y = self._solve_columns(
                torch.as_tensor(B, dtype=self.dtype, device=self.device),
                op, w, Minv=Minv).double().cpu().numpy()[:, :t - s]
            r = Y[u[s:t], cols] - Y[v[s:t], cols]  # a^T L^-1 a per column
            norms = np.linalg.norm(Y, axis=0)
            scalef = np.sqrt(np.maximum(r, 0.0)) / np.where(norms > 0, norms,
                                                            1.0)
            rows[s:t] = (Y * scalef[None, :]).T
        return rows, M_idxs.astype(np.int32)

    def find_edge_idx_with_max_weighted_effective_resistance(
            self, xuv_arr: np.ndarray, xuv_edge_idxs) -> int:
        """Candidate index whose row of xuv_arr has the largest weighted
        effective resistance."""
        xuv_edge_idxs = np.asarray(xuv_edge_idxs)
        local = find_idx_with_max_weighted_effective_resistance(
            xuv_arr, self.edge_weights[xuv_edge_idxs])
        return int(xuv_edge_idxs[local])

    def get_best_edge(self, M_idxs, selected=None):
        """(Edge, index) of the candidate in M_idxs with the largest
        weighted effective resistance against L_S."""
        xuv_arr, xuv_edge_idxs = self.get_all_xuv(M_idxs, selected=selected)
        best = self.find_edge_idx_with_max_weighted_effective_resistance(
            xuv_arr, xuv_edge_idxs)
        return self.all_candidate_edges[best], best

    # ----------------------------------------------------------- device scan

    def _select_scan_device(self, kmax: int) -> Optional[np.ndarray]:
        """The eager greedy selection on the device: kmax steps of one
        (t,) @ (t, m) product and a float64 update, in a Python loop that
        never waits for the device (the pivot stays a device tensor, used
        through index_select; the order is copied to the host once).
        Returns the (kmax,) selection order, or None below SCAN_MIN_WORK.

        Ties go to the first maximal score (torch.argmax, as np.argmax).
        The product reads only the first t rows of U, the ones written so
        far; it runs in full float32 or float64, never TF32. q is updated
        from each row as stored, so it stays colnorm^2 of the U that later
        products read."""
        m = len(self.edge_weights)
        if m * kmax < self.SCAN_MIN_WORK:
            return None
        dev = self.device
        u = torch.as_tensor(self.cand_idx[:, 0].astype(np.int64), device=dev)
        v = torch.as_tensor(self.cand_idx[:, 1].astype(np.int64), device=dev)
        w = torch.as_tensor(self.edge_weights, device=dev)  # float64
        if self._fixed_is_chain:
            lo, hi = torch.minimum(u, v), torch.maximum(u, v)
            rc = torch.as_tensor(self._chain_rcum(), device=dev)

            def grow(p1):
                return torch.clamp(
                    rc[torch.minimum(hi.index_select(0, p1), hi)]
                    - rc[torch.maximum(lo.index_select(0, p1), lo)], min=0.0)
        elif self._z_streaming():
            # One in-loop PCG solve per step, the factor built once.
            Minv = self._fixed_precond()

            def grow(p1):
                y = self._solve_columns(
                    self._incidence(u.index_select(0, p1),
                                    v.index_select(0, p1)), Minv=Minv)[:, 0]
                return (y[u] - y[v]).double()
        else:
            Zd = torch.as_tensor(self._compute_Z(), device=dev)

            def grow(p1):
                return (Zd.index_select(0, u.index_select(0, p1))
                        - Zd.index_select(0, v.index_select(0, p1)))[0].double()

        q = torch.as_tensor(self._gram_diag(
            None if (self._fixed_is_chain or self._z_streaming())
            else self._compute_Z()), device=dev)
        u_dtype = torch.float64 if m <= Z_F32_THRESHOLD else torch.float32
        U = torch.zeros((kmax, m), dtype=u_dtype, device=dev)
        avail = torch.ones(m, dtype=torch.bool, device=dev)
        neg_inf = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
        order = torch.empty(kmax, dtype=torch.int64, device=dev)
        for t in range(kmax):
            p1 = torch.argmax(torch.where(avail, w * q, neg_inf)).view(1)
            g = grow(p1)
            if t:
                g = g - (U[:t].index_select(1, p1)[:, 0] @ U[:t]).double()
            denom = (1.0 / w.index_select(0, p1)
                     + torch.clamp(q.index_select(0, p1), min=0.0))
            u_row = (g / torch.sqrt(denom)).to(u_dtype)
            U[t] = u_row
            u2 = u_row.double()
            q = q - u2 * u2
            avail.index_fill_(0, p1, False)
            order[t:t + 1] = p1
        return order.cpu().numpy()

    # ------------------------------------------------------------ host cores

    def _pivot_denominator(self, q_p: float, w_p: float) -> float:
        return 1.0 / w_p + q_p

    def subset(self, k: int) -> Tuple[np.ndarray, List[Edge]]:
        """Eager greedy selection of k candidates (first-max tie-break):
        (0/1 mask over the candidates, the selected edges in order)."""
        if self.lazy:
            res, sel, _ = self.subset_lazy(k)
            return res, sel
        k = int(k)
        m = len(self.edge_weights)
        if not 0 < k <= m:
            raise ValueError(f"k = {k} outside 1..{m}")
        order = self._select_scan_device(k)
        if order is not None:
            result = np.zeros(m)
            result[order] = 1.0
            return result, [self.all_candidate_edges[int(p)] for p in order]
        Z = (None if (self._fixed_is_chain or self._z_streaming())
             else self._compute_Z())
        w = self.edge_weights
        q = self._gram_diag(Z)  # unweighted effective resistances vs L_S
        U = np.zeros((k, m))
        result = np.zeros(m)
        selected: List[Edge] = []
        available = np.ones(m, dtype=bool)
        for t in range(k):
            scores = np.where(available, w * q, -np.inf)
            p = int(np.argmax(scores))
            result[p] = 1.0
            selected.append(self.all_candidate_edges[p])
            available[p] = False
            denom = self._pivot_denominator(q[p], w[p])
            u_row = (self._gram_row(Z, p) - U[:t, p] @ U[:t, :]) / np.sqrt(
                denom)
            U[t, :] = u_row
            q = q - u_row * u_row
        return result, selected

    def subsets_lazy(self, ks: Sequence[int], verbose: bool = False
                     ) -> Tuple[List[np.ndarray], List[Edge], List[float]]:
        """Greedy selections for the nested budgets ks (each at least the
        one before): (one mask per budget, the selected edges
        in order, the seconds from the start to each budget).

        The device scan above SCAN_MIN_WORK; else the native lazy core;
        else (and in streaming mode) a lazy Python loop: a popped candidate
        whose refreshed score stays on top is the eager argmax, and a
        refresh extends its Cholesky column to the current pivots."""
        start = timer()
        ks = list(ks)
        if any(ks[i] > ks[i + 1] for i in range(len(ks) - 1)):
            raise ValueError("budgets must be monotonically increasing")
        m = len(self.edge_weights)
        if m < ks[-1]:
            raise ValueError("Not enough candidate edges to satisfy the "
                             "largest budget")
        if ks[0] <= 0:
            raise ValueError("budgets must be positive")
        w = self.edge_weights
        u_idx = self.cand_idx[:, 0].astype(np.int64)
        v_idx = self.cand_idx[:, 1].astype(np.int64)

        Z = None
        order = self._select_scan_device(int(ks[-1]))
        if order is None:
            if self._fixed_is_chain:
                order = native.esp_lazy_select_chain(
                    self._chain_rcum(), np.minimum(u_idx, v_idx),
                    np.maximum(u_idx, v_idx), w, ks)
            elif not self._z_streaming():
                Z = self._compute_Z()
                order = native.esp_lazy_select_z(Z, u_idx, v_idx, w, ks)
            # Streaming: the native Z core needs the dense matrix; the
            # Python loop below serves Gram entries from pivot columns.
        if order is not None:
            result = np.zeros(m)
            results, times, selected = [], [], []
            pos = 0
            for k in ks:
                while pos < k:
                    p = int(order[pos])
                    result[p] = 1.0
                    selected.append(self.all_candidate_edges[p])
                    pos += 1
                times.append(timer() - start)
                results.append(result.copy())
            return results, selected, times

        kmax = ks[-1]
        piv: List[int] = []
        inv_sqrt_d: List[float] = []
        # Lazily extended columns U[:, e] and how many rows of each hold.
        Ucols = np.zeros((kmax, m))
        filled = np.zeros(m, dtype=np.int64)
        qcache = self._gram_diag(Z)  # q_e with filled[e] rows incorporated

        if self._fixed_is_chain:
            rc = self._chain_rcum()
            clo = np.minimum(u_idx, v_idx)
            chi = np.maximum(u_idx, v_idx)

            def gram(p: int, e: int) -> float:
                ov = rc[min(chi[p], chi[e])] - rc[max(clo[p], clo[e])]
                return float(ov) if ov > 0.0 else 0.0
        elif Z is not None:
            def gram(p: int, e: int) -> float:
                return float(Z[u_idx[p], e]) - float(Z[v_idx[p], e])
        else:
            # Streaming: only committed pivots p are asked for, each with a
            # cached Gram column.
            def gram(p: int, e: int) -> float:
                return float(self._pivot_gram_col(p)[e])

        def refresh(e: int) -> float:
            """Extend candidate e's column to all current pivots; its
            up-to-date unweighted effective resistance."""
            t = len(piv)
            for s in range(int(filled[e]), t):
                p_s = piv[s]
                u_se = (gram(p_s, e) - Ucols[:s, p_s] @ Ucols[:s, e]) \
                    * inv_sqrt_d[s]
                Ucols[s, e] = u_se
                qcache[e] -= u_se * u_se
            filled[e] = t
            return float(qcache[e])

        pq = [(-w[e] * qcache[e], e) for e in range(m)]
        heapq.heapify(pq)
        result = np.zeros(m)
        results: List[np.ndarray] = []
        times: List[float] = []
        selected: List[Edge] = []
        in_solution = np.zeros(m, dtype=bool)
        for k in ks:
            if verbose:
                print(f"Running Lazy GreedyESP for budget={k}")
            while len(selected) < k:
                # Pop, refresh and push until the top survives its refresh.
                while True:
                    neg_score, e = heapq.heappop(pq)
                    if in_solution[e]:
                        continue
                    q_e = refresh(e)
                    fresh = w[e] * q_e
                    if fresh >= -neg_score - 1e-13 * max(1.0, abs(fresh)):
                        p = e
                        break
                    heapq.heappush(pq, (-fresh, e))
                denom = self._pivot_denominator(float(qcache[p]), float(w[p]))
                piv.append(p)
                inv_sqrt_d.append(1.0 / np.sqrt(denom))
                in_solution[p] = True
                result[p] = 1.0
                selected.append(self.all_candidate_edges[p])
            times.append(timer() - start)
            results.append(result.copy())
        return results, selected, times

    def subset_lazy(self, k: int, verbose: bool = False):
        """subsets_lazy for one budget: (mask, selected edges, seconds)."""
        results, selected, times = self.subsets_lazy([int(k)],
                                                     verbose=verbose)
        return results[0], selected, times[0]

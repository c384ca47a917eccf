"""Incremental Fiedler solver: cheap re-solves as edges are added and removed
(PyTorch counterpart of mac_tpu.utils.incremental).

It plays the role of the reference library's CholeskyFiedlerSolver, which
keeps a CHOLMOD factor under rank-one updates. Here the edge set is fixed up
front (every edge that may ever be active), a mutation toggles one edge's
weight in O(1), and each solve warm-starts from the previous eigenvector
block, so a single-edge change converges in a few outer iterations.

    solver = IncrementalFiedlerSolver(base_edges, num_nodes,
                                      candidate_edges=cands)
    lam, v = solver.find_fiedler_pair()
    solver.add_edge(cands[3])
    lam2, v2 = solver.find_fiedler_pair()
    solver.remove_edge(cands[3])
"""

from typing import Dict, List, Tuple

import numpy as np
import torch

from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops.laplacian import build_operator
from mac_tpu_torch.utils import fiedler as _fiedler
from mac_tpu_torch.utils.graphs import Edge, edges_to_arrays


class IncrementalFiedlerSolver:
    def __init__(
        self,
        base_edges,
        num_nodes: int,
        candidate_edges=None,
        tol: float = 1e-8,
        maxiter: int = 200,
        inner_iters: int = 16,
        dtype=None,
        device="cuda",
    ):
        """base_edges start active; candidate_edges (optional) are inactive
        until `add_edge`. An edge not declared here cannot be added later.
        device: where the solves run, "cuda" by default; dtype: None takes
        the device's default (float32 on a card, float64 on the CPU).
        `xprev0`, the block that seeds the eigensolver's previous-iterate
        memory, may be replaced before solving."""
        base_idx, base_w = edges_to_arrays(base_edges)
        cand_idx, cand_w = edges_to_arrays(candidate_edges or [])
        self.num_nodes = int(num_nodes)
        self.device = resolve_device(device)
        self.dtype = (_fiedler.default_dtype(self.device) if dtype is None
                      else dtype)
        self.tol = float(tol)
        self.maxiter = int(maxiter)
        self.inner_iters = int(inner_iters)

        all_idx = (np.concatenate([base_idx, cand_idx], axis=0)
                   if len(cand_idx) else base_idx)
        all_w = np.concatenate([base_w, cand_w]) if len(cand_w) else base_w
        self.op = build_operator(all_idx, self.num_nodes).to(self.device)
        self._full_w = np.asarray(all_w, dtype=np.float64)
        self._active = np.concatenate(
            [np.ones(len(base_idx)), np.zeros(len(cand_idx))])
        # (i, j, weight) -> slots, for add and remove.
        self._slots: Dict[Tuple[int, int, float], List[int]] = {}
        for t, ((i, j), wt) in enumerate(zip(all_idx, all_w)):
            key = (min(int(i), int(j)), max(int(i), int(j)), float(wt))
            self._slots.setdefault(key, []).append(t)

        self._X = torch.as_tensor(_fiedler.default_block(self.num_nodes),
                                  dtype=self.dtype, device=self.device)
        self.xprev0 = _fiedler.default_xprev(
            self.num_nodes, self._X.shape[1], self.dtype, self.device)

    def _slot_of(self, edge) -> int:
        i, j = int(edge[0]), int(edge[1])
        wt = float(edge[2]) if len(edge) > 2 else 1.0
        key = (min(i, j), max(i, j), wt)
        slots = self._slots.get(key, [])
        if not slots:
            raise KeyError(
                f"edge {key} was not declared at construction; the edge set "
                "is static (declare it via candidate_edges)")
        return slots[0]

    def add_edge(self, edge: Edge) -> None:
        """Activate an edge (once more, if it is active already)."""
        self._active[self._slot_of(edge)] += 1.0

    def remove_edge(self, edge: Edge) -> None:
        """Deactivate an edge (one multiplicity of it)."""
        s = self._slot_of(edge)
        if self._active[s] <= 0:
            raise ValueError(f"edge {tuple(edge)} is not active")
        self._active[s] -= 1.0

    def find_fiedler_pair(self, X=None):
        """(lambda_2, v_2) of the current graph as (float, numpy), warm
        started from the last solve's block (or from X)."""
        w_eff = torch.as_tensor(self._full_w * self._active,
                                dtype=self.dtype, device=self.device)
        Xw = (self._X if X is None else
              torch.as_tensor(np.asarray(X), dtype=self.dtype,
                              device=self.device))
        res = _fiedler.fiedler_pair_op(
            self.op, w_eff, Xw, xprev0=self.xprev0, tol=self.tol,
            maxiter=self.maxiter, inner_iters=self.inner_iters)
        self._X = res.X
        return float(res.lam[0]), res.X[:, 0].cpu().numpy()


# The reference library's name for this role.
CholeskyFiedlerSolver = IncrementalFiedlerSolver

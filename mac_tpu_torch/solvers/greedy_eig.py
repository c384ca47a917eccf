"""GreedyEig: the greedy lambda_2 baseline (PyTorch counterpart of
mac_tpu.solvers.greedy_eig).

Each of k steps adds the candidate edge whose inclusion gives the largest
algebraic connectivity. Candidates are tried best supergradient bound
first (lambda_2(L + e_j) <= lambda_2 + grad_j), in chunks; a chunk whose
best bound cannot reach the tie window of the best lambda_2 found ends the
step. The winner is the reference's index-order scan over the evaluated
(index, lambda_2) pairs: running best from 0, replaced iff
lambda_2 > best + 1e-8, so an exact tie goes to the lowest index.

A chunk's trial graphs each add one edge to the incumbent L(x), and the
chunk is one solve over its lanes (utils.fiedler.fiedler_pair_lanes): a
batched dense eigh up to 256 nodes, else TRACEMIN with the incumbent's
product and two-grid V-cycle on all lanes' columns at once, warm-started
from the incumbent's eigenvector block and run for at least one outer
iteration (TRIAL_MIN_ITERS).
"""

from typing import List, Tuple

import numpy as np
import torch

from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops.laplacian import build_operator
from mac_tpu_torch.utils.fiedler import (default_block, default_dtype,
                                         default_xprev, fiedler_pair_lanes,
                                         fiedler_pair_op)
from mac_tpu_torch.utils.graphs import Edge, edges_to_arrays

# Two lambda_2 values within this distance tie (the reference's window).
TIE_TOL = 1e-8
# Outer TRACEMIN iterations every trial lane runs. A lane starts from the
# incumbent's block, the eigenvectors of another operator; in float32 that
# block can pass TRACEMIN's stop test as it enters (||r||_1 / ||L||_inf
# under the 2048-eps clamp while ||r|| / lambda < 2), and the lane would
# return its entry Ritz value: 31% above the true lambda_2 on intel, which
# then wins the step. The JAX package's vmap has no such floor (its
# tracemin_fiedler forces one iteration only on its warm entry).
TRIAL_MIN_ITERS = 1


class GreedyEig:
    """Greedy lambda_2 maximisation over the candidate edges.

    odom_measurements: the fixed edges; lc_measurements: the candidates
    (lists of Edge, or (idx, w) pairs). fiedler_tol: TRACEMIN's tolerance
    (clamped to 2048 eps in float32). chunk: trial evaluations per solve.
    dtype: the device's default (float32 on a card, float64 on the CPU)
    when None. device: "cuda" by default; "cpu" runs the plain PyTorch
    versions. `xprev0`, the block that seeds TRACEMIN's previous-iterate
    memory, may be replaced before subset(). After subset(), `step_lam2`
    holds the lambda_2 each step reported for its winner."""

    def __init__(self, odom_measurements, lc_measurements, num_poses: int,
                 fiedler_tol: float = 1e-8, chunk: int = 64, dtype=None,
                 device="cuda"):
        fixed_idx, w_fixed = edges_to_arrays(odom_measurements)
        cand_idx, w_cand = edges_to_arrays(lc_measurements)
        self.device = resolve_device(device)
        self.num_poses = int(num_poses)
        self.weights = np.asarray(w_cand)
        self.edge_list = np.asarray(cand_idx)
        self._m_fixed = fixed_idx.shape[0]
        self.chunk = int(chunk)
        self.fiedler_tol = float(fiedler_tol)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.op = build_operator(np.concatenate([fixed_idx, cand_idx]),
                                 self.num_poses).to(self.device)
        self._w_fixed = torch.as_tensor(w_fixed, dtype=self.dtype,
                                        device=self.device)
        self._w_cand = torch.as_tensor(w_cand, dtype=self.dtype,
                                       device=self.device)
        self._X0 = torch.as_tensor(default_block(self.num_poses),
                                   dtype=self.dtype, device=self.device)
        self.xprev0 = default_xprev(self.num_poses, self._X0.shape[1],
                                    self.dtype, self.device)

    def _weights(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)
        return torch.cat([self._w_fixed, x * self._w_cand])

    def _eval(self, x, X):
        """(lambda_2, X block) of L(x), from the start block X."""
        res = fiedler_pair_op(self.op, self._weights(x), X,
                              xprev0=self.xprev0, tol=self.fiedler_tol)
        return res.lam[0], res.X

    def _eval_chunk(self, x, cand: np.ndarray, X):
        """The chunk's trials L(x + e_j), j in cand, as one solve from the
        incumbent's block X, each lane at least TRIAL_MIN_ITERS outer
        iterations: (lambda_2 per trial on the host, X blocks
        (len(cand), n, q))."""
        c = torch.as_tensor(cand, dtype=torch.int64, device=self.device)
        res = fiedler_pair_lanes(self.op, self._weights(x),
                                 c + self._m_fixed, self._w_cand[c], X,
                                 xprev0=self.xprev0, tol=self.fiedler_tol,
                                 min_iters=TRIAL_MIN_ITERS)
        return res.lam[:, 0].cpu().numpy(), res.X

    def find_fiedler_pair(self, x):
        """(lambda_2, v_2) of L(x)."""
        lam, X = self._eval(x, self._X0)
        return float(lam), X[:, 0].cpu().numpy()

    def grad_from_fiedler(self, fiedler_vec) -> np.ndarray:
        """Supergradient w_k (v_i - v_j)^2 (Eq. (8) of arXiv:2203.13897)."""
        v = np.asarray(fiedler_vec)
        d = v[self.edge_list[:, 0]] - v[self.edge_list[:, 1]]
        return self.weights * d * d

    def subset(self, k: int) -> Tuple[np.ndarray, List[Edge]]:
        """k greedy steps: (0/1 mask over the candidates, the selected edges
        in order)."""
        k = int(k)
        m = len(self.weights)
        solution = np.zeros(m)
        lam, X = self._eval(solution, self._X0)
        lam = float(lam)
        grad = self.grad_from_fiedler(X[:, 0].cpu().numpy())
        selected: List[Edge] = []
        self.step_lam2: List[float] = []
        for _ in range(k):
            unsel = np.nonzero(solution == 0)[0]
            order = unsel[np.argsort(-(lam + grad[unsel]))]
            best_l2 = 0.0
            evals = []   # (candidate index, lambda_2)
            blocks = {}  # X blocks of the current tie group only
            for s in range(0, len(order), self.chunk):
                cand = order[s:s + self.chunk]
                # Prune strictly below the tie window: a pruned candidate
                # must not be able to join the tie group.
                if lam + grad[cand].max() < best_l2 - TIE_TOL:
                    break
                lams, Xs = self._eval_chunk(solution, cand, X)
                best_l2 = max(best_l2, float(lams.max()))
                for t in range(len(cand)):
                    evals.append((int(cand[t]), float(lams[t])))
                    if float(lams[t]) >= best_l2 - TIE_TOL:
                        blocks[int(cand[t])] = Xs[t]
                lam_of = dict(evals)
                for idx in [i for i in blocks
                            if lam_of[i] < best_l2 - TIE_TOL]:
                    del blocks[idx]
            # The reference's sequential index-order scan over the pairs;
            # a pruned candidate lies below (final best - tol) and cannot
            # change its last updater.
            best_idx, run_best = -1, 0.0
            for idx, l2 in sorted(evals):
                if l2 > run_best + TIE_TOL:
                    best_idx, run_best = idx, l2
            if best_idx == -1:
                raise RuntimeError("no improving edge found")
            solution[best_idx] = 1.0
            selected.append(Edge(int(self.edge_list[best_idx, 0]),
                                 int(self.edge_list[best_idx, 1]),
                                 float(self.weights[best_idx])))
            self.step_lam2.append(run_best)
            lam, X = run_best, blocks[best_idx].contiguous()
            _, v = self.find_fiedler_pair(solution)
            grad = self.grad_from_fiedler(v)
        return solution, selected

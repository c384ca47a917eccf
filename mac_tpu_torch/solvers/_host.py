"""The host (numpy + scipy) side of MAC: counterpart of the host pieces of
mac_tpu.solvers.mac, kept in a module of their own so that solvers/mac.py
stays the device solver and its routing.

  * the router's helpers: exact connectivity of the full graph
    (_graph_is_connected) and the band-narrow splu probe
    (host_band_probe_ratio);
  * _IncrementalHostLap: L(x) as CSR on a fixed pattern;
  * _WoodburyState / _WoodburyView: low-rank corrected solves against one
    splu factor, for the round guard's swap trials;
  * HostSolveMixin, which MAC inherits: the float64 Frank-Wolfe loop of the
    host engine (_solve_host) and the two exact tails of the banded float32
    route, the guarded polish step (_host_polish) and the post-rounding
    repair (_round_guard_impl). They work in original node ids on numpy
    arrays: nothing here touches the device.
"""

from timeit import default_timer as timer

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from mac_tpu_torch.ops.banded import MAX_BANDWIDTH, rcm_order
from mac_tpu_torch.ops.host_tracemin import (block_pcg, host_tracemin_fiedler,
                                             splu_reduced)
from mac_tpu_torch.utils.fiedler import default_block
from mac_tpu_torch.utils.graphs import weight_graph_lap_from_edges
from mac_tpu_torch.utils.rounding import round_madow_base, round_nearest_np

# splu cadence of the host Frank-Wolfe loop: refactor every p-th warm step
# and reuse the stale factor otherwise. The reference's rule is 1 (refactor
# every step): the host loop's clients are the tiny-gap graphs, whose
# Fiedler subspace moves by ~1/gap per step, so a factor one step old is a
# useless inverse-iteration direction and the outer count explodes. (On the
# banded device route the stale object is only a preconditioner of CG, and
# skipping there is safe: see precond_refresh_period.)
HOST_LU_REFRESH = 1

# Block CG on the current grounded system, preconditioned by the last
# factor, for the host loop's warm steps (ops.host_tracemin.block_pcg);
# more CG iterations than this in one inner solve asks for a fresh factor
# before the next step. Exact, unlike stale inverse iteration, but slow in
# the reference's screens (a Frank-Wolfe step moves whole edges in and out
# of the graph, which a one-step-old factor preconditions poorly), so it is
# an opt-in experiment: MAC.host_pcg = True.
HOST_PCG_REFRESH_ITS = 25


def _graph_is_connected(idx: np.ndarray, n: int) -> bool:
    """Exact O(m) connectivity of the full graph (fixed edges and every
    candidate) by scipy's csgraph. A graph that is disconnected even with
    every candidate has lambda_2 = 0 everywhere, and the host engine's
    grounded splu system is singular there: such instances stay on the
    device engine, which supports lambda_2 = 0 (rank-one nullspace shift,
    no factorisation)."""
    idx = np.asarray(idx).reshape(-1, 2)
    A = sp.coo_matrix(
        (np.ones(len(idx)), (idx[:, 0], idx[:, 1])), shape=(n, n))
    ncomp, _ = connected_components(A, directed=False)
    return ncomp == 1


def host_band_probe_ratio(fixed_idx, w_fixed, cand_idx, w_cand, num_nodes):
    """lambda_2(mid-box) / ||L||_inf of a large band-narrow graph by a few
    exact inverse iterations: an RCM bandwidth of at most MAX_BANDWIDTH
    keeps splu nearly free of fill. None when the graph has no narrow band
    (expander-like: the fill would be dangerous, and such graphs have no
    tiny gap) or when the probe fails (a disconnected graph's grounded
    system is singular).

    A public helper: the port's routing does not call it. The JAX package
    uses it only in the routing branches it takes when its backend is the
    CPU (mac_tpu/solvers/mac.py:534-563), which send large band-narrow
    tiny-gap graphs to the host engine; the port's CPU runs rehearse the
    card's routing instead, so those branches have no counterpart here."""
    idx = np.concatenate([fixed_idx, cand_idx], axis=0)
    try:
        _, _, bw = rcm_order(idx, num_nodes)
        if bw == 0 or bw > MAX_BANDWIDTH:
            return None
        w_all = np.concatenate(
            [np.asarray(w_fixed, np.float64),
             0.5 * np.asarray(w_cand, np.float64)])
        L = weight_graph_lap_from_edges(idx, w_all, num_nodes)
        lnorm = float(np.abs(L).sum(axis=1).max())
        lu = splu_reduced(L)
        X0 = default_block(num_nodes, dtype=np.float64)
        lam, _, _ = host_tracemin_fiedler(
            L, X0, tol=1e-6, maxiter=15, rel_tol=1e-4, lu=lu)
        lam0 = float(lam[0])
        if not np.isfinite(lam0) or lam0 <= 0 or lnorm <= 0:
            return None
        return lam0 / lnorm
    except (RuntimeError, np.linalg.LinAlgError):
        # splu reports an exactly singular factor (a disconnected graph) as
        # a RuntimeError; the dense steps raise LinAlgError on what follows
        # from a numerically singular one.
        return None


class _IncrementalHostLap:
    """L(x) as scipy CSR on a fixed pattern, for the host loops: only the
    m_cand candidate weights change between steps.

    The full pattern (every candidate at x = 1) is built once, with the
    four CSR data slots each candidate touches ((i,i), (j,j), (i,j),
    (j,i)); L(x) is then one O(4 m_cand) scatter-add onto a cached base
    array. `indices` and `indptr` are shared by every matrix produced."""

    def __init__(self, idx, w_fixed, w_cand, cand_idx, num_nodes):
        self.n = int(num_nodes)
        self.wc = np.asarray(w_cand, np.float64)
        m_c = len(self.wc)
        P = weight_graph_lap_from_edges(
            idx, np.concatenate([np.asarray(w_fixed, np.float64), self.wc]),
            num_nodes)
        P.sort_indices()
        self.indptr, self.indices = P.indptr, P.indices
        ci = np.asarray(cand_idx[:, 0], np.int64)
        cj = np.asarray(cand_idx[:, 1], np.int64)

        def slot(r, c):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            return lo + int(np.searchsorted(self.indices[lo:hi], c))

        pos = np.empty(4 * m_c, np.int64)
        for e in range(m_c):
            i, j = int(ci[e]), int(cj[e])
            pos[e] = slot(i, i)
            pos[m_c + e] = slot(j, j)
            pos[2 * m_c + e] = slot(i, j)
            pos[3 * m_c + e] = slot(j, i)
        self.pos = pos
        self.sign = np.concatenate([np.ones(2 * m_c), -np.ones(2 * m_c)])
        base = P.data.copy()
        np.subtract.at(base, pos, self.sign * np.tile(self.wc, 4))
        self.base = base

    def build(self, xm):
        """L(x) for masked candidate multipliers xm (already thresholded):
        candidate e contributes xm[e] * w_cand[e]."""
        data = self.base.copy()
        v = np.asarray(xm, np.float64) * self.wc
        np.add.at(data, self.pos, self.sign * np.tile(v, 4))
        return sp.csr_matrix((data, self.indices, self.indptr),
                             shape=(self.n, self.n))


class _WoodburyState:
    """Woodbury-corrected solves against a base Laplacian factored once.

    Each swap trial of the round guard differs from the current best
    selection by a low-rank update (add an edge: +w_a a a^T, drop one:
    -w_d d d^T, with a, d grounded incidence columns). Instead of one splu
    per trial, the base is factored once and the trial systems
    (A + U diag(c) U^T) y = b are solved by the Woodbury identity. Accepted
    swaps commit their columns, so later trials stack corrections (rank
    <= 2 rounds; the capacitance solves are small and dense). A singular
    capacitance (the trial selection disconnects the graph) raises
    LinAlgError; callers score such trials 0."""

    def __init__(self, lu, nred):
        self.lu = lu
        self.U = np.zeros((nred, 0))
        self.Z = np.zeros((nred, 0))  # lu.solve(U), kept column by column
        self.c = np.zeros(0)

    def trial_view(self, cols, cvals):
        """Solver view of the base, the committed columns and (cols,
        cvals); and what `commit` needs to keep them."""
        znew = self.lu.solve(np.ascontiguousarray(cols))
        U = np.concatenate([self.U, cols], axis=1)
        Z = np.concatenate([self.Z, znew], axis=1)
        c = np.concatenate([self.c, np.asarray(cvals, np.float64)])
        cap = np.diag(1.0 / c) + U.T @ Z
        pend = (cols, znew, np.asarray(cvals, np.float64))
        return _WoodburyView(self.lu, U, Z, cap), pend

    def commit(self, pend):
        cols, znew, cvals = pend
        self.U = np.concatenate([self.U, cols], axis=1)
        self.Z = np.concatenate([self.Z, znew], axis=1)
        self.c = np.concatenate([self.c, cvals])


class _WoodburyView:
    """An `lu`-shaped adapter (only .solve) over a Woodbury correction."""

    def __init__(self, lu, U, Z, cap):
        self.lu = lu
        self.U = U
        self.Z = Z
        self.cap = cap

    def solve(self, b):
        y = self.lu.solve(b)
        if self.U.shape[1] == 0:
            return y
        w = np.linalg.solve(self.cap, self.U.T @ y)
        return y - self.Z @ w


class HostSolveMixin:
    """MAC's host engine and exact tails (see the module docstring). Reads
    the attributes MAC's constructor sets: the edges in original node ids,
    the host copies of the weights, the polish schedule and
    `_exact_evals`, the count of float64 host eigensolves."""

    _exact_evals = 0
    _host_lap_inc = None  # the _IncrementalHostLap, built at first use

    def _host_lap(self, xm):
        """Host CSR Laplacian L(x) through the cached fixed-pattern
        updater (_IncrementalHostLap)."""
        if self._host_lap_inc is None:
            idx = np.concatenate([self.fixed_idx, self.cand_idx], axis=0)
            self._host_lap_inc = _IncrementalHostLap(
                idx, self._w_fixed_np, self.weights, self.cand_idx,
                self.num_nodes)
        return self._host_lap_inc.build(xm)

    def _madow_u(self, seed: int, count: int) -> torch.Tensor:
        """The (count,) Madow offsets of a solve, U[0, 1) in the compute
        dtype from a torch.Generator seeded with `seed`. The one place
        where a solve draws random numbers."""
        gen = torch.Generator().manual_seed(int(seed))
        return torch.rand((int(count),), generator=gen, dtype=self.dtype)

    def _madow_samples(self, x, k: int, seed: int, count: int) -> np.ndarray:
        """(count, m) Madow roundings of the relaxed x (taken in the compute
        dtype, on the host), one per offset of _madow_u."""
        xt = torch.as_tensor(np.asarray(x), dtype=self.dtype)
        return np.stack([
            round_madow_base(xt, k, u=u).numpy().astype(np.float64)
            for u in self._madow_u(seed, count)])

    # ------------------------------------------------------- the host engine

    def _solve_host(self, k, x_init, rounding, max_iters,
                    relative_duality_gap_tol, grad_norm_tol,
                    random_rounding_max_iters, verbose, seed, use_cache):
        """Frank-Wolfe on the host (numpy, scipy splu TRACEMIN): the engine
        of the small and the float64-escalated instances. The semantics of
        the device loop (the reference's termination rules, warm-started
        eigensolves, nearest or Madow rounding); the dual upper bound is
        exact float64 here, so no certificate replaces it.
        Returns (rounded, x, upper, rounding seconds)."""
        m = len(self.weights)
        w_cand = np.asarray(self.weights, np.float64)
        ci = self.cand_idx[:, 0].astype(np.int64)
        cj = self.cand_idx[:, 1].astype(np.int64)
        x = np.asarray(x_init, np.float64).copy()
        X0 = self._X0.cpu().numpy().astype(np.float64)
        X = X0
        rel_tol = self.fiedler_rel_tol
        if rel_tol is None:
            rel_tol = 1e-7

        # The splu cadence (see HOST_LU_REFRESH): precond_refresh_period
        # when the caller set it, for experiments. Rayleigh-Ritz and the
        # residual test always run against the current L, so a stale factor
        # stays correct; a step that spends its outer budget forces a fresh
        # factor on the next one.
        period_h = (self.precond_refresh_period if self._precond_period_user
                    else HOST_LU_REFRESH)
        use_pcg = (use_cache and not self._precond_period_user
                   and self.host_pcg)
        lu = None
        pcg_refresh = False
        pcg_stats = []  # (Frank-Wolfe step, CG iterations of each inner solve)
        maxiter_h = min(self.fiedler_maxiter, 60)

        solve_start = timer()
        u = np.inf
        fiters = 0
        it = 0
        for it in range(int(max_iters)):
            xm = np.where(x > self.min_selection_weight_tol, x, 0.0)
            L = self._host_lap(xm)
            Xw = X if use_cache else X0
            if use_pcg and lu is not None and not pcg_refresh:
                Lred = sp.csr_matrix(L.tocsr()[1:, 1:])
                cg_its = []

                def solve_pcg(B):
                    Y, cgit, _ = block_pcg(Lred, B, lu.solve, tol=1e-10,
                                           maxiter=60)
                    cg_its.append(cgit)
                    return Y

                lam, Xb, its = host_tracemin_fiedler(
                    L, Xw, tol=self.fiedler_tol, maxiter=maxiter_h,
                    rel_tol=rel_tol, solve_fn=solve_pcg)
                pcg_stats.append((it, cg_its))
                # Drifted, or the outer budget spent: a fresh factor next.
                pcg_refresh = ((bool(cg_its)
                                and max(cg_its) > HOST_PCG_REFRESH_ITS)
                               or its >= maxiter_h)
            else:
                if (use_pcg or lu is None or not use_cache
                        or it % period_h == 0):
                    lu = splu_reduced(L)
                    pcg_refresh = False
                lam, Xb, its = host_tracemin_fiedler(
                    L, Xw, tol=self.fiedler_tol, maxiter=maxiter_h,
                    rel_tol=rel_tol, lu=lu)
                if its >= maxiter_h:
                    # Unconverged: refactor on the next step.
                    if use_pcg:
                        pcg_refresh = True
                    else:
                        lu = None
            if use_cache:
                X = Xb
            fiters += its
            v = Xb[:, 0]
            d = v[ci] - v[cj]
            grad = w_cand * d * d
            f = float(lam[0])
            s = np.zeros(m)
            s[np.argpartition(grad, m - k)[m - k:]] = 1.0
            u = min(u, f + grad @ (s - x))
            if verbose:
                print(f"FW iter {it}: f = {f}, gap = {u - f}")
            # The scale-aware gradient stop and the gap stop of
            # optimization.frankwolfe (a tolerance <= 0 turns the gap stop
            # off).
            if np.linalg.norm(grad) < grad_norm_tol * min(1.0, abs(f)):
                break
            if (relative_duality_gap_tol > 0
                    and (u - f) < relative_duality_gap_tol * abs(f)):
                break
            x = x + 2.0 / (it + 2.0) * (s - x)
        self.last_solve_stats = {
            "fw_iterations": int(min(it + 1, max_iters)),
            "fiedler_iterations": int(fiters),
            "fw_time_s": timer() - solve_start,
            "backend": "host",
        }
        if use_pcg:
            self.last_solve_stats["host_pcg_iters"] = pcg_stats

        start = timer()
        if rounding == "madow":
            R = max(int(random_rounding_max_iters), 1)
            xs = self._madow_samples(x, k, seed, R)
            vals = ([self.evaluate_objective(xx) for xx in xs] if R > 1
                    else [0.0])
            rounded = xs[int(np.argmax(vals))]
        else:
            rounded = round_nearest_np(x, k, weights=w_cand,
                                       break_ties_decimal_tol=10)
        return rounded, x, float(u), timer() - start

    # ------------------------------------------------------ the exact polish

    def _host_polish(self, x, k, X_warm=None):
        """The guarded exact Frank-Wolfe polish of the float32 route's
        final iterate: exact float64 host eigensolves (splu TRACEMIN,
        original node ids), top-k directions, an adaptive step ladder; a
        trial is kept only if the float64 objective improves.

        Returns (x_best, v_best, X_best, accepted): v_best is the exact
        Fiedler vector at x_best in original ids (also when every step is
        rejected: it still tightens the caller's dual certificate), X_best
        the whole Ritz block (the round guard's warm start), accepted
        whether a trial beat the incoming iterate. The base solve
        warm-starts from `X_warm`, the device basis in original ids, the
        trials from the last accepted block.

        Bounded by fw_polish_rounds, by fw_polish_eval_budget eigensolves
        beyond the base one (plus one finishing solve), by the certificate
        (stop once the dual gap at the exact current point is within
        fw_polish_target, since no further round can then move the value
        past the quality band), and by fw_polish_big_gap: an endpoint whose
        first certified gap is larger is limited by the step count, not by
        precision, and gets one exact round."""
        n = self.num_nodes
        m = len(self.weights)
        wc = np.asarray(self.weights, np.float64)
        ci = self.cand_idx[:, 0].astype(np.int64)
        cj = self.cand_idx[:, 1].astype(np.int64)
        X0 = X_warm if X_warm is not None else default_block(
            n, dtype=np.float64)

        def f_grad_v(xv, Xw, tight=True):
            xm = np.where(xv > self.min_selection_weight_tol, xv, 0.0)
            L = self._host_lap(xm)
            self._exact_evals += 1
            # Loose trials rank points whose values differ by >= ~1e-5
            # relative; a relative residual of 1e-5 biases the Rayleigh
            # quotient by its square.
            mi, rt = (40, 1e-8) if tight else (16, 1e-5)
            lam, X, _ = host_tracemin_fiedler(
                L, Xw, tol=1e-9, maxiter=mi, rel_tol=rt,
                lu=splu_reduced(L))
            v = X[:, 0]
            d = v[ci] - v[cj]
            return float(lam[0]), wc * d * d, v, X

        x = np.asarray(x, np.float64)
        f0, g, v0, Xb = f_grad_v(x, X0)
        best_x, best_f, best_v, best_X, accepted = x, f0, v0, Xb, False
        # The step ladder costs one eigensolve per round as a rule: retry
        # the step size that worked last, double it after a success
        # (capped), halve it after a failure, and stop when the smallest
        # fails (for concave f along the segment every larger one then
        # fails too).
        gamma = 1.0 / 16.0
        g_min, g_max = 1.0 / 64.0, 1.0 / 8.0
        evals0 = self._exact_evals
        self.last_polish_info = None
        for rnd in range(max(int(self.fw_polish_rounds), 0)):
            s = np.zeros(m)
            s[np.argpartition(g, m - k)[m - k:]] = 1.0
            u0 = best_f + float(g @ (s - best_x))
            gap = (u0 - best_f) / abs(best_f) if best_f else np.inf
            if rnd == 0:
                self.last_polish_info = {"gap0": gap}
            if gap <= self.fw_polish_target:
                break
            if rnd >= 1 and (self.last_polish_info["gap0"]
                             > self.fw_polish_big_gap):
                break
            improved = False
            while gamma >= g_min:
                if (self._exact_evals - evals0
                        >= max(int(self.fw_polish_eval_budget), 1)):
                    break
                xt = best_x + gamma * (s - best_x)
                ft, gt, vt, Xt = f_grad_v(xt, best_X, tight=False)
                if ft > best_f:
                    best_x, best_f, best_v, best_X, g = xt, ft, vt, Xt, gt
                    accepted = improved = True
                    gamma = min(2.0 * gamma, g_max)
                    break
                gamma *= 0.5
            if not improved:
                break
        if accepted:
            # One tight finishing solve at the winner: the certificate and
            # the guard want a converged pair. Loose trial Rayleigh
            # quotients are biased high, so the climb is checked against
            # the tight base value and reverted if it was an artefact.
            best_f, g, best_v, best_X = f_grad_v(best_x, best_X)
            if best_f <= f0:
                return x, v0, Xb, False
        return best_x, best_v, best_X, accepted

    # ------------------------------------------------------- the round guard

    def _round_guard_impl(self, rounded, x_relaxed, f_relaxed, k, seed,
                          X_warm=None):
        """Exact repair after rounding. When the rounded selection's exact
        lambda_2 collapses 10x or more below the relaxed objective (one
        edge dominates the rounded value and "nearest by weight" is
        arbitrary among near-tied weights), audit three Madow samples of
        the relaxed iterate with exact referees, keep the best and climb
        from it by greedy swaps (drop the selected candidates with the
        smallest supergradient entries, add unselected ones with the
        largest); otherwise spend two cheap 1-swap rounds on the exact
        rounded value. Every comparison is a float64 host eigensolve (splu
        TRACEMIN, warm-started; the swap trials through Woodbury
        corrections of one factor): the collapsed regime lies far below a
        float32 eigensolver's resolution relative to ||L||. Monotone: the
        result is never worse than the input.

        x_relaxed: the relaxed iterate the samples are drawn from. X_warm:
        the relaxed Ritz block in original ids; with it the collapse is
        certified for free, since the Rayleigh quotient on L(rounded) of
        any vector in 1^perp bounds lambda_2 from above.
        Returns (rounded', improved): improved only when the selection
        changed and its exact value beats the input's."""
        n = self.num_nodes
        idx = np.concatenate([self.fixed_idx, self.cand_idx], axis=0)
        wf = np.asarray(self._w_fixed_np, np.float64)
        wc = np.asarray(self.weights, np.float64)
        ci = self.cand_idx[:, 0].astype(np.int64)
        cj = self.cand_idx[:, 1].astype(np.int64)
        X0 = X_warm if X_warm is not None else default_block(
            n, dtype=np.float64)

        def exact_eval_full(r, Xw):
            # A full factorisation: base selections and Madow samples,
            # which lie anywhere relative to a factored base.
            L = self._host_lap(r)
            self._exact_evals += 1
            try:
                lu = splu_reduced(L)
                lam, Xx, _ = host_tracemin_fiedler(
                    L, Xw, tol=1e-9, maxiter=30, rel_tol=1e-7, lu=lu)
            except Exception:
                # A disconnected trial selection: lambda_2 = 0 and the
                # grounded factor is singular. Scored 0, never selected.
                return 0.0, Xw, None
            return float(lam[0]), Xx, lu

        r0 = np.asarray(rounded, np.float64)
        base_lazy = False
        if X_warm is not None:
            vr = np.asarray(X_warm[:, 0], np.float64)
            vr = vr - vr.mean()
            wall = np.concatenate([wf, wc * r0])
            dall = vr[idx[:, 0]] - vr[idx[:, 1]]
            u_base = float((wall * dall * dall).sum() / (vr @ vr))
            base_lazy = u_base < 0.1 * f_relaxed
        if base_lazy:
            # Collapsed for certain, and the base's true value is at most
            # u_base: a sample that beats u_base beats the base. The
            # samples start from the relaxed basis (they select with
            # probability ~x; the collapsed base's block is useless to
            # them).
            f0, Xr, lu0 = u_base, np.asarray(X_warm, np.float64), None
        else:
            f0, Xr, lu0 = exact_eval_full(r0, X0)
            # lu0 None: the input selection itself is disconnected, the
            # most collapsed input there is; scored 0 and left to the
            # samples, unless the relaxed anchor is degenerate too.
            if lu0 is None and not (f0 < 0.1 * f_relaxed):
                return rounded, False
        best_r, best_f, best_X = r0, f0, Xr
        wb = _WoodburyState(lu0, n - 1) if lu0 is not None else None

        def ground_col(e):
            col = np.zeros(n - 1)
            i, j = int(ci[e]), int(cj[e])
            if i > 0:
                col[i - 1] = 1.0
            if j > 0:
                col[j - 1] = -1.0
            return col

        def swap_eval(rt, cols, cvals, Xw, maxiter=30, rel_tol=1e-7):
            # A low-rank trial against the committed Woodbury base; the
            # exact CSR L(rt) still gives every Rayleigh quotient.
            L = self._host_lap(rt)
            self._exact_evals += 1
            try:
                view, pend = wb.trial_view(cols, cvals)
                lam, Xx, _ = host_tracemin_fiedler(
                    L, Xw, tol=1e-9, maxiter=maxiter, rel_tol=rel_tol,
                    lu=view)
            except np.linalg.LinAlgError:
                return 0.0, Xw, None  # singular capacitance: disconnected
            return float(lam[0]), Xx, pend

        def swap_climb(best_r, best_f, best_X, rounds,
                       maxiter=30, rel_tol=1e-7, stop_at=None, width=1):
            for _ in range(rounds):
                if stop_at is not None and best_f >= stop_at:
                    break  # within 2x of the relaxed anchor: repaired
                v = best_X[:, 0]
                g = wc * (v[ci] - v[cj]) ** 2
                sel = best_r > 0.5
                sel_idx = np.where(sel)[0]
                uns_idx = np.where(~sel)[0]
                if sel_idx.size == 0 or uns_idx.size == 0:
                    break
                # Widest trial first: swap the p lowest-gradient selected
                # edges for the p highest-gradient unselected ones in one
                # rank-2p evaluation (a collapsed selection as a rule
                # misses several bridges); on failure halve p; at p = 1
                # also try the second-best addition.
                trials = []
                p = int(width)
                while p > 1:
                    pp = min(p, sel_idx.size, uns_idx.size)
                    trials.append(
                        (sel_idx[np.argsort(g[sel_idx])[:pp]],
                         uns_idx[np.argsort(g[uns_idx])[::-1][:pp]]))
                    p //= 2
                drop1 = sel_idx[np.argmin(g[sel_idx])]
                for add in uns_idx[np.argsort(g[uns_idx])[::-1][:2]]:
                    trials.append((np.array([drop1]), np.array([add])))
                improved = False
                for drops, adds in trials:
                    rt = best_r.copy()
                    rt[drops] = 0.0
                    rt[adds] = 1.0
                    cols = np.stack(
                        [ground_col(e)
                         for e in np.concatenate([adds, drops])], axis=1)
                    cvals = np.concatenate([wc[adds], -wc[drops]])
                    ft, Xt, pend = swap_eval(
                        rt, cols, cvals, best_X,
                        maxiter=maxiter, rel_tol=rel_tol)
                    if ft > best_f:
                        wb.commit(pend)
                        best_r, best_f, best_X = rt, ft, Xt
                        improved = True
                        break
                if not improved:
                    break
            return best_r, best_f, best_X

        if not (f0 < 0.1 * f_relaxed):
            # No collapse: nearest rounding is in the right regime, but its
            # exact value can land a hair below a near-tied neighbour's.
            best_r, best_f, best_X = swap_climb(best_r, best_f, best_X, 2)
            if best_f > f0 and not np.array_equal(best_r, r0):
                return best_r, True
            return rounded, False

        # Collapsed: the rounded selection misses bridges. Loose referees
        # warm-started from the collapsed basis cannot rank swap trials (the
        # basis is a useless subspace for the repaired graph), while Madow
        # samples of the relaxed iterate select with probability ~x and
        # reconnect at once: audit a few with full referees, keep the best,
        # and climb only from that base, where warm starts track the truth.
        xs = self._madow_samples(x_relaxed, k, int(seed) ^ 0x5EED, 3)
        best_lu = None
        Xw = best_X
        for rt in xs:
            ft, Xt, lut = exact_eval_full(rt, Xw)
            if lut is not None:
                # The next sample starts from this one's block even when it
                # loses: the samples are near-identical selections.
                Xw = Xt
            if ft > best_f:
                best_r, best_f, best_X = rt, ft, Xt
                best_lu = lut
            if best_f >= 0.5 * f_relaxed:
                break  # the same bar as the swap climb's stop
        loose_winner = False
        if best_lu is not None:
            wb = _WoodburyState(best_lu, n - 1)
            bf_in = best_f
            best_r, best_f, best_X = swap_climb(
                best_r, best_f, best_X, 2, maxiter=12, rel_tol=1e-4,
                stop_at=0.5 * f_relaxed)
            loose_winner = best_f > bf_in
        elif base_lazy:
            # No sample beat the certified upper bound u_base, and the base
            # was never solved: anchor on its true value now (best_f is
            # still the bound, not a value any selection attains), so the
            # full-referee swaps below have a Woodbury factor to climb from.
            f0, Xr, lu0 = exact_eval_full(r0, X0)
            best_r, best_f, best_X = r0, f0, Xr
            if lu0 is not None:
                wb = _WoodburyState(lu0, n - 1)
                best_r, best_f, best_X = swap_climb(
                    best_r, best_f, best_X, 6, stop_at=0.5 * f_relaxed,
                    width=4)
        elif wb is not None:
            # No sample beat the collapsed base (k too small for Madow to
            # vary, or a fragile relaxed iterate): swaps with full
            # referees, which need a non-singular base factor; a
            # disconnected input with no winning sample stays as it is.
            best_r, best_f, best_X = swap_climb(
                best_r, best_f, best_X, 6, stop_at=0.5 * f_relaxed,
                width=4)
        if loose_winner:
            # The loose climb referee is biased: certify the winner with a
            # tight solve before claiming an improvement.
            best_f, _, _ = exact_eval_full(best_r, best_X)
        if best_f > f0 and not np.array_equal(best_r, r0):
            return best_r, True
        return rounded, False

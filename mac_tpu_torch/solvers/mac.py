"""MAC: maximize algebraic connectivity of an edge-budgeted graph.

PyTorch counterpart of mac_tpu.solvers.mac.MAC on its two float32 device
routes: fix a base edge set, relax the K-subset selection of candidate
edges to the box [0, 1]^m with |x| <= K, maximise F(x) = lambda_2(L(x)) by
Frank-Wolfe with a warm-started Fiedler oracle, round back to a binary
selection, and certify the result with a float64 dual bound on the host.

Routes, chosen as the reference chooses them:
  * banded: a graph with a narrow RCM band takes the block-banded operator
    (kernels K2/K2b and K1) and the reference's fast32 policy, knob for
    knob: eigensolver tol 6e-4, 50 outer iterations, 10 inner CG steps,
    relative tolerance 3e-2, float32 coefficient algebra; warm Frank-Wolfe
    steps capped at 4 / 2 / 1 outer iterations from steps 1 / 4 / 10 with 5
    inner CG steps; 32 Frank-Wolfe steps, duality-gap stop off, Cesaro tail
    averaging from step 16; the coarse inverse refreshed by Newton-Schulz
    from step 4.
  * matrix-free: any other graph (or use_banded=False) takes the ELL
    GraphOperator in original node ids (a dense matrix for n <= 256) with
    the two-grid V-cycle (kernel K1, or K1b past 32768 nodes) and the
    reference defaults: tol 1e-8, 200 outer iterations, 16 inner CG steps,
    the dtype's relative tolerance, float64 coefficient algebra, the full
    budget on warm steps, 5 Frank-Wolfe steps.
Both round to the nearest selection in the loop's output.

Routes this slice of the port does not have raise NotImplementedError with
the slice that adds them; none runs something else in their place.
"""

from dataclasses import dataclass
from timeit import default_timer as timer
from typing import Optional

import numpy as np
import torch

from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops.banded import PrecondState, build_banded_rcm
from mac_tpu_torch.ops.laplacian import build_operator
from mac_tpu_torch.ops.precond import extract_chain_weights
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.optimization.frankwolfe import frank_wolfe_with_state
from mac_tpu_torch.utils import fiedler as _fiedler
from mac_tpu_torch.utils.graphs import (edges_to_arrays,
                                        weight_graph_lap_from_edges)
from mac_tpu_torch.utils.rounding import round_nearest

# lambda_2 / ||L||_inf below this cannot be resolved by a float32 eigensolve.
F32_SPECTRAL_RATIO_MIN = 1.2e-5
# The reference routes instances this small to its host float64 engine.
SMALL_HOST_N = 2000
# Seed of the default random block that starts TRACEMIN's previous-iterate
# memory (the reference uses jax.random.PRNGKey(7)).
XPREV_SEED = 7


def _not_in_slice(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in this slice of the PyTorch port; {where}")


def choose_compute_dtype(fixed_idx, w_fixed, cand_idx, w_cand, num_nodes):
    """float32 vs float64 from a cheap host spectral probe (scipy):
    lambda_2 at the mid-box point x = 1/2 relative to the full graph's
    ||L||_inf. Returns (dtype, ratio or None). Carried over from
    mac_tpu.solvers.mac.choose_compute_dtype."""
    import scipy.sparse.linalg as spla

    try:
        n = int(num_nodes)
        if n <= 2:
            return torch.float32, None
        idx = np.concatenate([fixed_idx, cand_idx], axis=0)
        w_half = np.concatenate([w_fixed, 0.5 * np.asarray(w_cand)])
        L = weight_graph_lap_from_edges(idx, w_half, n)
        w_full = np.concatenate([w_fixed, np.asarray(w_cand)])
        lnorm_full = 2.0 * float(
            weight_graph_lap_from_edges(idx, w_full, n).diagonal().max())
        if n <= 256:
            import scipy.linalg as sla

            evals = np.sort(sla.eigh(L.toarray(), eigvals_only=True))
            ratio = float(evals[1]) / max(lnorm_full, 1e-300)
            dtype = (torch.float64 if ratio < F32_SPECTRAL_RATIO_MIN
                     else torch.float32)
            return dtype, ratio

        # Stage 1: Jacobi-preconditioned LOBPCG and a Weinstein lower bound;
        # accept float32 outright with a 3x margin over the threshold.
        import warnings

        import scipy.sparse as _sp

        rng = np.random.RandomState(7)
        X0 = rng.normal(size=(n, 3))
        X0 -= X0.mean(axis=0, keepdims=True)
        dinv = 1.0 / np.maximum(L.diagonal(), 1e-300)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vals, vecs = spla.lobpcg(
                L, X0, M=_sp.diags(dinv), Y=np.ones((n, 1)),
                tol=1e-6 * max(lnorm_full, 1.0), maxiter=100, largest=False)
        j = int(np.argmin(vals))
        theta = float(vals[j])
        v = vecs[:, j]
        v = v - v.mean()
        v /= max(np.linalg.norm(v), 1e-300)
        resid = float(np.linalg.norm(L @ v - theta * v))
        certified_ratio = (theta - resid) / max(lnorm_full, 1e-300)
        if certified_ratio >= 3.0 * F32_SPECTRAL_RATIO_MIN:
            return torch.float32, certified_ratio

        # Stage 2: shift-invert Lanczos for graphs small enough to factor;
        # larger ones decide from the Weinstein bound alone.
        if n > 20000:
            if certified_ratio >= F32_SPECTRAL_RATIO_MIN:
                return torch.float32, certified_ratio
            return torch.float64, certified_ratio
        try:
            lam2 = float(np.sort(spla.eigsh(
                L, k=2, sigma=-1e-8 * max(lnorm_full, 1.0), which="LM",
                return_eigenvectors=False, maxiter=300, tol=1e-3,
            ))[-1])
        except spla.ArpackNoConvergence as e:
            evals = np.sort(np.asarray(e.eigenvalues).ravel())
            if evals.size < 2:
                return torch.float64, certified_ratio
            lam2 = float(evals[-1])
        ratio = lam2 / max(lnorm_full, np.finfo(np.float64).tiny)
        dtype = (torch.float64 if ratio < F32_SPECTRAL_RATIO_MIN
                 else torch.float32)
        return dtype, ratio
    except Exception:
        # The probe is best-effort (scipy's solvers can fail on exotic
        # inputs); the reference defaults to the fast path.
        return torch.float32, None


class MAC:
    """Algebraic-connectivity-maximizing edge selection (float32, on the
    banded or the matrix-free route; see the module docstring).

    fixed_edges / candidate_edges: lists of `Edge` (or (idx, w) arrays).
    num_nodes: number of graph nodes.
    device: where the solve runs, "cuda" by default; "cpu" runs the
        kernels' plain PyTorch versions.
    The eigensolver and Frank-Wolfe knobs mirror mac_tpu.solvers.mac.MAC;
    None selects the route's automatic policy.
    fiedler_method: "tracemin" (its "_lu" / "_cholesky" aliases), or, on
        the matrix-free route, "lobpcg" or "dense" (exact eigh).
    fiedler_precond: the matrix-free route's preconditioner, "twogrid" or
        "tridiag"; None takes "tridiag" for a float64 solve whose fixed
        edges hold the odometry chain and whose candidates number at most
        n / 5, "twogrid" otherwise (so always "twogrid" here).
    fw_polish / round_guard: the reference's exact host polish step and
        post-rounding repair (round_guard is an attribute there). Both
        resolve True on the banded route for n <= 4096, which this slice
        does not run -- pass False for such graphs -- and False elsewhere.

    `xprev0` (n, q) is the random block that seeds the eigensolver's
    previous-iterate memory; it defaults to N(0, 1) from a torch.Generator
    seeded with 7 and may be replaced before solving.
    """

    @dataclass
    class Cache:
        """Warm-start data threaded between problem() calls."""
        Q: Optional[torch.Tensor] = None

    def __init__(
        self,
        fixed_edges,
        candidate_edges,
        num_nodes: int,
        fiedler_method: str = "tracemin",
        fiedler_tol=None,
        min_selection_weight_tol: float = 1e-10,
        dtype=None,
        fiedler_maxiter=None,
        fiedler_inner_iters=None,
        fiedler_rel_tol=None,
        fiedler_coeff_dtype=None,
        fiedler_warm_maxiter=None,
        fiedler_warm_inner_iters=None,
        fiedler_block_q=None,
        mesh=None,
        use_banded=None,
        fw_tail_average=None,
        fiedler_precond=None,
        precond_refresh_period=None,
        fw_polish=None,
        round_guard=None,
        device="cuda",
    ):
        fixed_idx, w_fixed = edges_to_arrays(fixed_edges)
        cand_idx, w_cand = edges_to_arrays(candidate_edges)
        n = int(num_nodes)
        num_edges = fixed_idx.shape[0] + cand_idx.shape[0]
        if not (n - 1 <= num_edges <= 0.5 * n * (n - 1)):
            raise ValueError(f"{num_edges} edges cannot form a connected "
                             f"simple graph on {n} nodes")
        if mesh is not None:
            raise _not_in_slice("A device mesh (row-sharded ELL or banded "
                                "products)", "multi-GPU solves come with "
                                "slice F (ROADMAP Queue 1, item 17)")
        if fiedler_method in ("tracemin_lu", "tracemin_cholesky"):
            fiedler_method = "tracemin"
        if fiedler_method not in ("tracemin", "lobpcg", "dense"):
            raise ValueError(f"unknown fiedler_method {fiedler_method!r}")
        if fiedler_precond not in (None, "twogrid", "tridiag"):
            raise ValueError(f"unknown fiedler_precond {fiedler_precond!r}")

        self.spectral_ratio = None
        if dtype is None:
            dtype, ratio = choose_compute_dtype(
                fixed_idx, w_fixed, cand_idx, w_cand, n)
            self.spectral_ratio = ratio
            if dtype == torch.float64:
                raise _not_in_slice(
                    f"lambda_2/||L||_inf ~ {ratio:.2e} is below float32 "
                    "resolution and needs the float64 host engine, which",
                    "comes with slice B (item 11)")
            if n <= SMALL_HOST_N and use_banded is None:
                raise _not_in_slice(
                    f"The host float64 engine for small instances (n <= "
                    f"{SMALL_HOST_N})", "it comes with slice B (item 11); "
                    "pass dtype=torch.float32 and use_banded=True (or "
                    "False) for a device route")
        if dtype != torch.float32:
            raise _not_in_slice(f"dtype={dtype}", "float64 solves come with "
                                "slice B (item 11)")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_nodes = n
        self.fixed_idx = fixed_idx
        self.cand_idx = cand_idx
        self.weights = np.asarray(w_cand)
        self.edge_list = np.asarray(cand_idx)

        # Route: the banded operator when the graph admits a narrow RCM
        # band (and use_banded is not False), else the matrix-free one.
        all_idx = np.concatenate([fixed_idx, cand_idx], axis=0)
        bop, ridx = (build_banded_rcm(all_idx, n) if use_banded is not False
                     else (None, None))
        self._banded = None
        self._perm = None
        self.op = None
        if bop is not None:
            if fiedler_method != "tracemin":
                raise _not_in_slice(
                    f"fiedler_method={fiedler_method!r} (LOBPCG or dense "
                    "eigh) on the banded operator", "both run on the ELL "
                    "operator here: pass use_banded=False")
            self._perm = bop.perm.numpy().astype(np.int64)
            self._banded = bop.to(self.device)  # nn.Module.to moves in place
            operator = self._banded
            # Internal (RCM-relabelled) endpoints: the node space of the
            # device eigenvectors.
            self._int_idx = np.asarray(ridx, dtype=np.int64)
        else:
            self.op = build_operator(all_idx, n).to(self.device)
            operator = self.op
            self._int_idx = all_idx.astype(np.int64)
        fast32 = self._banded is not None
        m_fixed = fixed_idx.shape[0]
        self._w_fixed = torch.as_tensor(w_fixed, dtype=dtype,
                                        device=self.device)
        self._w_cand = torch.as_tensor(w_cand, dtype=dtype, device=self.device)
        cand_int = torch.as_tensor(self._int_idx[m_fixed:], device=self.device)
        self._params = (self._w_fixed, self._w_cand, cand_int, operator)

        if fiedler_precond is None:
            # The reference's rule: the chain solve alone for float64
            # solves of a chain with few candidates (never so here).
            chain_only = (dtype == torch.float64
                          and cand_idx.shape[0] <= 0.2 * n
                          and extract_chain_weights(fixed_idx, w_fixed, n)
                          is not None)
            fiedler_precond = "tridiag" if chain_only else "twogrid"
        self.fiedler_method = fiedler_method
        self.fiedler_precond = fiedler_precond
        # The route's automatic policy (mac.py's fast32 policy on the banded
        # route, the reference defaults on the matrix-free one): explicit
        # knobs win.
        if fiedler_tol is None:
            fiedler_tol = 6e-4 if fast32 else 1e-8
        if fiedler_maxiter is None:
            fiedler_maxiter = 50 if fast32 else 200
        if fiedler_inner_iters is None:
            fiedler_inner_iters = 10 if fast32 else 16
        if fiedler_rel_tol is None and fast32:
            fiedler_rel_tol = 3e-2
        if fiedler_coeff_dtype is None and fast32:
            fiedler_coeff_dtype = torch.float32
        self.fiedler_tol = float(fiedler_tol)
        self.fiedler_maxiter = int(fiedler_maxiter)
        self.fiedler_inner_iters = int(fiedler_inner_iters)
        # None: the dtype's default relative residual tolerance.
        self.fiedler_rel_tol = fiedler_rel_tol
        # None: float64 coefficient algebra.
        self.fiedler_coeff_dtype = fiedler_coeff_dtype
        self._warm_maxiter_user_set = fiedler_warm_maxiter is not None
        if fiedler_warm_maxiter is None and fast32 and n >= 4096:
            fiedler_warm_maxiter = 5
        if fiedler_warm_maxiter is None:
            self._warm_schedule = ((1, self.fiedler_maxiter),)
        elif isinstance(fiedler_warm_maxiter, int):
            self._warm_schedule = ((1, int(fiedler_warm_maxiter)),)
        else:
            self._warm_schedule = self._check_schedule(fiedler_warm_maxiter)
        self.fiedler_warm_maxiter = fiedler_warm_maxiter
        if fiedler_warm_inner_iters is None:
            self._warm_inner_schedule = ((1, 5),) if fast32 else None
        elif isinstance(fiedler_warm_inner_iters, int):
            self._warm_inner_schedule = ((1, int(fiedler_warm_inner_iters)),)
        else:
            self._warm_inner_schedule = self._check_schedule(
                fiedler_warm_inner_iters)
        self._tail_average_user_set = fw_tail_average is not None
        self.fw_tail_average = bool(fast32 if fw_tail_average is None
                                    else fw_tail_average)
        self.precond_refresh_period = (1 if precond_refresh_period is None
                                       else int(precond_refresh_period))
        self.min_selection_weight_tol = float(min_selection_weight_tol)
        # The reference turns on its exact host polish step and round guard
        # on the banded route for n <= 4096; both are host float64
        # eigensolves (slice B).
        small_banded = fast32 and n <= 4096
        self.fw_polish = bool(small_banded if fw_polish is None
                              else fw_polish)
        self.round_guard = bool(small_banded if round_guard is None
                                else round_guard)
        if self.fw_polish or self.round_guard:
            raise _not_in_slice(
                "The exact float64 polish step and round guard (on by "
                "default on the banded route for n <= 4096)",
                "they come with slice B (item 10); pass fw_polish=False "
                "and round_guard=False")

        self._q = min(int(fiedler_block_q or 4), n - 1)
        self._X0 = torch.as_tensor(_fiedler.default_block(n, self._q),
                                   dtype=dtype, device=self.device)
        gen = torch.Generator().manual_seed(XPREV_SEED)
        self.xprev0 = torch.randn((n, self._q), generator=gen,
                                  dtype=dtype).to(self.device)

    @staticmethod
    def _check_schedule(sched):
        sched = tuple((int(a), int(b)) for a, b in sched)
        if any(sched[i][0] >= sched[i + 1][0] for i in range(len(sched) - 1)):
            raise ValueError(f"schedule steps must ascend: {sched}")
        return sched

    # ------------------------------------------------------------------ core

    def _mask(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x > self.min_selection_weight_tol, x,
                           torch.zeros_like(x))

    def _warm_cap(self, schedule, step: int) -> int:
        """Eigensolver outer-iteration cap at FW step `step` under a
        ((from_step, cap), ...) schedule; step 0 gets the full budget."""
        if step == 0:
            return self.fiedler_maxiter
        mi = self.fiedler_maxiter
        for from_step, cap in schedule:
            if step >= from_step:
                mi = cap
        return mi

    def _warm_inner(self, schedule, step: int) -> int:
        """Inner-CG step count at FW step `step`; step 0 gets the full
        fiedler_inner_iters."""
        if step == 0:
            return self.fiedler_inner_iters
        ii = self.fiedler_inner_iters
        for from_step, inner in schedule:
            if step >= from_step:
                ii = inner
        return ii

    def _w_all(self, params, x: torch.Tensor) -> torch.Tensor:
        w_fixed, w_cand, _, _ = params
        return torch.cat([w_fixed, self._mask(x) * w_cand])

    def _fiedler(self, params, w_all, X, maxiter=None, pstate=None,
                 use_prev=None, rebuild=None, want_pstate: bool = False,
                 rel_tol=None, inner_iters=None):
        return _fiedler.fiedler_pair_op(
            params[3], w_all, X,
            xprev0=self.xprev0,
            tol=self.fiedler_tol,
            maxiter=self.fiedler_maxiter if maxiter is None else maxiter,
            inner_iters=(self.fiedler_inner_iters
                         if inner_iters is None else inner_iters),
            rel_tol=self.fiedler_rel_tol if rel_tol is None else rel_tol,
            method=self.fiedler_method,
            precond=self.fiedler_precond,
            coeff_dtype=self.fiedler_coeff_dtype,
            pstate=pstate, use_prev=use_prev, rebuild=rebuild,
            return_pstate=want_pstate,
        )

    def _problem_impl(self, params, x, X, maxiter=None, pstate=None,
                      use_prev=None, rebuild=None, inner_iters=None):
        """(f, supergradient, Ritz block, outer iterations[, PrecondState])
        at x: grad_e = w_e (v_i - v_j)^2 over the candidates."""
        _, w_cand, cand_int, _ = params
        want_pstate = pstate is not None
        out = self._fiedler(params, self._w_all(params, x), X,
                            maxiter=maxiter, pstate=pstate,
                            use_prev=use_prev, rebuild=rebuild,
                            want_pstate=want_pstate, inner_iters=inner_iters)
        res, pstate_new = out if want_pstate else (out, None)
        v = res.X[:, 0]
        d = v[cand_int[:, 0]] - v[cand_int[:, 1]]
        grad = w_cand * d * d
        if want_pstate:
            return res.lam[0], grad, res.X, res.iters, pstate_new
        return res.lam[0], grad, res.X, res.iters

    def _fw_impl(self, params, x0, X0, *, k: int, maxiter: int,
                 relative_duality_gap_tol: float, grad_norm_tol: float,
                 use_cache: bool, schedule=None, inner_schedule=None,
                 tail_average: bool = False):
        """The Frank-Wolfe loop with the Ritz block, the cumulative Fiedler
        iteration count, the step index and the preconditioner state
        threaded through its state; nearest rounding of the result (ties
        to the larger candidate weight)."""
        if schedule is None or not use_cache:
            schedule = ((1, self.fiedler_maxiter),)
        if not use_cache:
            inner_schedule = None
        # The banded route carries its preconditioner state across steps;
        # the matrix-free route rebuilds its V-cycle every step.
        pstate0 = None
        bop, dev = self._banded, self.device
        if bop is not None:
            nc, n = bop.coarse_nc, bop.n
            pstate0 = PrecondState(
                Lc_inv=torch.zeros((nc, nc), dtype=self.dtype, device=dev),
                chain_dp=torch.zeros(n, dtype=self.dtype, device=dev),
                chain_l=torch.zeros(n, dtype=self.dtype, device=dev))
        period = int(self.precond_refresh_period)

        def problem(x, state):
            X, fiters, step, pstate = state
            mi = self._warm_cap(schedule, step)
            ii = (None if inner_schedule is None
                  else self._warm_inner(inner_schedule, step))
            if pstate is None:
                f, grad, Xres, iters = self._problem_impl(
                    params, x, X, maxiter=mi, inner_iters=ii)
            else:
                # Newton-Schulz coarse refresh once the FW step size
                # 2/(step+2) bounds the operator change (step >= 4); with a
                # refresh period p > 1, steps >= 8 rebuild only every p-th
                # step.
                rebuild = (None if period <= 1
                           else (step < 8 or step % period == 0))
                f, grad, Xres, iters, pstate = self._problem_impl(
                    params, x, X, maxiter=mi, pstate=pstate,
                    use_prev=step >= 4, rebuild=rebuild, inner_iters=ii)
            Xnew = Xres if use_cache else X0
            return f, grad, (Xnew, fiters + iters, step + 1, pstate)

        x, u, (X, fiters, _, _), it = frank_wolfe_with_state(
            x0, (X0, 0, 0, pstate0), problem,
            lambda g: solve_subset_box_lp(g, k),
            maxiter=maxiter,
            relative_duality_gap_tol=relative_duality_gap_tol,
            grad_norm_tol=grad_norm_tol,
            tail_average_from=(maxiter // 2 if tail_average else None))
        rounded = round_nearest(x, k, weights=params[1],
                                break_ties_decimal_tol=10)
        return x, u, X, it, fiters, rounded

    def _refine_lambda(self, x, v) -> float:
        """Float64 Rayleigh quotient of the Fiedler vector on the host, an
        exact sum over edges: v^T L(x) v = sum_e w_e (v_i - v_j)^2."""
        v = np.asarray(v, dtype=np.float64)
        v = v - v.mean()
        x = np.asarray(x, dtype=np.float64)
        keep = x > self.min_selection_weight_tol
        idx = self._int_idx
        w = np.concatenate(
            [self._w_fixed.cpu().numpy().astype(np.float64),
             np.where(keep, x, 0.0) * np.asarray(self.weights, np.float64)])
        d = v[idx[:, 0]] - v[idx[:, 1]]
        return float((w * d * d).sum() / (v * v).sum())

    def _eval_rel_tol(self) -> float:
        """Residual tolerance of standalone objective evaluations: at most
        1e-3, since the Rayleigh quotient over-reports lambda_2 by up to
        ||r||_rel^2 / gap and the banded route's in-loop 3e-2 would bias
        it by ~1e-3 relative."""
        rt = self.fiedler_rel_tol
        return 1e-3 if rt is None else min(float(rt), 1e-3)

    # ------------------------------------------------------------ public API

    def laplacian(self, x):
        """Host-side L(x) as scipy CSR, pruning selection weights below
        `min_selection_weight_tol`."""
        x = np.asarray(x)
        keep = x > self.min_selection_weight_tol
        idx = np.concatenate([self.fixed_idx, self.cand_idx[keep]], axis=0)
        w = np.concatenate([self._w_fixed.cpu().numpy(),
                            x[keep] * self.weights[keep]])
        return weight_graph_lap_from_edges(idx, w, self.num_nodes)

    def evaluate_objective(self, x) -> float:
        """F(x) = lambda_2(L(x)): a Fiedler solve from the cold start block
        with at least 100 outer iterations and the evaluation tolerance,
        refined to float64 on the host by the exact edge-sum Rayleigh
        quotient of its Fiedler vector."""
        x = torch.as_tensor(np.array(x), dtype=self.dtype,
                            device=self.device)
        res = self._fiedler(self._params, self._w_all(self._params, x),
                            self._X0, maxiter=max(self.fiedler_maxiter, 100),
                            rel_tol=self._eval_rel_tol())
        return self._refine_lambda(x.cpu().numpy(), res.X[:, 0].cpu().numpy())

    def problem(self, x, cache: Optional["MAC.Cache"] = None):
        """(F(x), grad F(x)) with a cold preconditioner, warm-starting from
        and updating `cache.Q`."""
        x = torch.as_tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)
        X = (self._X0 if cache is None or cache.Q is None
             else torch.as_tensor(cache.Q, dtype=self.dtype,
                                  device=self.device))
        f, grad, Xnew, _ = self._problem_impl(self._params, x, X)
        if cache is not None:
            cache.Q = Xnew
        return float(f), grad.cpu().numpy()

    def solve(
        self,
        k: int,
        x_init=None,
        rounding: str = "nearest",
        max_iters: Optional[int] = None,
        relative_duality_gap_tol: Optional[float] = None,
        grad_norm_tol: float = 1e-8,
        use_cache: bool = True,
    ):
        """Solve the budgeted edge-selection problem.

        Returns (rounded, unrounded, upper_bound) as in
        mac_tpu.solvers.mac.MAC.solve. max_iters=None selects the route's
        policy: on the banded route the fast32 one (32 steps, warm-cap
        schedule (1, 4), (4, 2), (10, 1), tail averaging, gap stop off), on
        the matrix-free route the reference's 5 steps. An explicit
        max_iters keeps the reference semantics (gap stop 1e-4, no tail
        averaging unless asked for). With use_cache, upper_bound is a
        rigorous float64 certificate: the final-iterate Rayleigh quotient
        plus its supergradient linearisation maximised over the feasible
        set.
        """
        m = len(self.weights)
        k = int(k)
        if k >= m or k <= 0:
            raise _not_in_slice(f"The k={k} shortcut (k <= 0 or k >= m)",
                                "it comes with slice B (item 12)")
        if rounding != "nearest":
            raise _not_in_slice(f"rounding={rounding!r}",
                                "Madow rounding comes with slice B (item 12)")
        if x_init is None:
            x_init = np.full(m, k / m)
        x_init = torch.as_tensor(np.asarray(x_init), dtype=self.dtype,
                                 device=self.device)
        if x_init.shape != (m,):
            raise ValueError(f"x_init has shape {tuple(x_init.shape)}, "
                             f"want ({m},)")

        schedule = self._warm_schedule
        tail_avg = False
        if max_iters is None and self._banded is None:
            max_iters = 5  # the reference's default
            tail_avg = self._tail_average_user_set and self.fw_tail_average
        elif max_iters is None:
            max_iters = 32
            if not self._warm_maxiter_user_set:
                schedule = ((1, 4), (4, 2), (10, 1))
            if relative_duality_gap_tol is None:
                relative_duality_gap_tol = 0.0
            tail_avg = self.fw_tail_average
        elif self._tail_average_user_set and self.fw_tail_average:
            tail_avg = True
        if relative_duality_gap_tol is None:
            relative_duality_gap_tol = 1e-4

        solve_start = timer()
        x_dev, u_dev, X_dev, it, fiters, rounded_dev = self._fw_impl(
            self._params, x_init, self._X0, k=k, maxiter=int(max_iters),
            relative_duality_gap_tol=float(relative_duality_gap_tol),
            grad_norm_tol=float(grad_norm_tol), use_cache=bool(use_cache),
            schedule=schedule,
            inner_schedule=self._warm_inner_schedule, tail_average=tail_avg)
        x = x_dev.cpu().numpy()
        u = float(u_dev)
        X = X_dev.cpu().numpy()
        rounded = rounded_dev.cpu().numpy()
        if not np.isfinite(u):
            # Degenerate operators (a graph disconnected even with every
            # candidate) can NaN the accumulated bound; substitute
            # lambda_2 <= 2 max weighted degree of the full graph.
            deg = np.zeros(self.num_nodes)
            all_w = np.concatenate([self._w_fixed.cpu().numpy(),
                                    np.asarray(self.weights)]
                                   ).astype(np.float64)
            np.add.at(deg, self._int_idx[:, 0], all_w)
            np.add.at(deg, self._int_idx[:, 1], all_w)
            u = float(2.0 * deg.max(initial=0.0))
        self.last_solve_stats = {
            "fw_iterations": int(it),
            "fiedler_iterations": int(fiters),
            "fw_time_s": timer() - solve_start,
            "tail_averaged": bool(tail_avg),
        }
        # Nearest rounding ran with the loop; no guard or exact evaluations.
        self.last_solve_stats["round_guard"] = False
        self.last_solve_stats["exact_evals"] = 0

        unrounded = x
        upper = u
        if use_cache:
            # Rigorous float64 certificate at the final iterate.
            v = np.asarray(X[:, 0], dtype=np.float64)
            f64 = self._refine_lambda(unrounded, v)
            ci = self._int_idx[len(self.fixed_idx):]
            d = v[ci[:, 0]] - v[ci[:, 1]]
            vn = v - v.mean()
            grad64 = np.asarray(self.weights, np.float64) * d * d / (vn @ vn)
            s = np.zeros(m)
            top = np.argpartition(grad64, -k)[-k:]
            s[top[grad64[top] > 0]] = 1.0
            upper = float(f64 + grad64 @ (s - unrounded))
        self.last_solve_stats["solve_total_s"] = timer() - solve_start
        return rounded, unrounded, upper

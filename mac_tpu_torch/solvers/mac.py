"""MAC: maximize algebraic connectivity of an edge-budgeted graph.

PyTorch counterpart of mac_tpu.solvers.mac.MAC: fix a base edge set, relax
the K-subset selection of candidate edges to the box [0, 1]^m with
|x| <= K, maximise F(x) = lambda_2(L(x)) by Frank-Wolfe with a warm-started
Fiedler oracle, round back to a binary selection (nearest or Madow), and
certify the result with a float64 dual bound.

`MAC(fixed, cands, n)` routes by itself, as the reference does on an
accelerator session (the rule holds on every device of the port, whose CPU
runs rehearse the card):

  * dtype. A host spectral probe (choose_compute_dtype) escalates to
    float64 when lambda_2 / ||L||_inf at the mid-box point is below float32
    resolution (a tiny gap: kitti_02, kitti_05, ais2klinik); instances of
    at most SMALL_HOST_N nodes take float64 too (intel). An explicit dtype,
    use_banded or fiedler_backend bypasses the second rule, an explicit
    dtype both.
  * fiedler_backend. Those two kinds of instance run the host engine
    (solvers._host: numpy Frank-Wolfe, scipy splu TRACEMIN, 20 steps under
    a 1e-4 duality-gap stop) unless the graph is disconnected even with
    every candidate (lambda_2 = 0: the grounded system is singular), which
    stays on the device engine. Everything else runs the device engine.
  * the device operator. In float32 a graph with a narrow RCM band takes
    the block-banded operator (kernels K2/K2b and K1) and the reference's
    fast32 policy, knob for knob: eigensolver tol 6e-4, 50 outer
    iterations, 10 inner CG steps, relative tolerance 3e-2, float32
    coefficient algebra; warm Frank-Wolfe steps capped at 4 / 2 / 1 outer
    iterations from steps 1 / 4 / 10 with 5 inner CG steps; 32 Frank-Wolfe
    steps, duality-gap stop off, Cesaro tail averaging from step 16; the
    coarse inverse refreshed by Newton-Schulz from step 4. For n <= 4096
    two exact float64 host tails follow (solvers._host): the guarded polish
    step and the post-rounding round guard. With use_banded=True a float64
    solve takes the banded operator too (the float64 instantiations of the
    same kernels) under the reference defaults below, without the host
    tails. Any other graph, and every other float64 solve, takes the ELL
    GraphOperator in original node ids (a dense matrix for n <= 256) with
    the two-grid V-cycle (kernel K1, or K1b past 32768 nodes, in the
    solve's dtype) or the chain solve alone, and the reference defaults:
    tol 1e-8, 200 outer iterations, 16 inner CG steps, the dtype's relative
    tolerance, float64 coefficient algebra, the full budget on warm steps,
    5 Frank-Wolfe steps. On either operator fiedler_method picks TRACEMIN,
    LOBPCG or the exact dense eigh.

MAC.solve_sweep runs R budgets as R lanes of one Frank-Wolfe solve on the
device engine (every instance, the host-routed ones included, as the
reference's sweep does): each lane with its own operator, preconditioner,
Ritz block, stop tests and rounding, the kernels launched once for all
lanes.

On a device mesh (mesh=, mac_tpu_torch.parallel.mesh.make_mesh: one
process per GPU under torch.distributed) every rank builds the same host
tables and keeps its share of the operator on its GPU: the banded
operator's block rows, or the ELL operator's node rows (mesh_apply="rows")
or edges ("edges"), through mac_tpu_torch.parallel.sharded. The
supergradient and the top-k oracle run sharded too; the eigensolver's
block algebra, the chain solves and the coarse level run replicated. Under
a mesh the size gate and the host engine are off, fw_polish and the round
guard default to False, the matrix-free operator is never dense, the ranks
agree on every loop decision, and every rank returns the first rank's
arrays. solve_sweep splits its lanes over the mesh's 'sweep' dimension.
"""

import os
from dataclasses import dataclass
from timeit import default_timer as timer
from typing import Optional

import numpy as np
import torch

from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops import graphs as _graphs
from mac_tpu_torch.ops.banded import PrecondState, build_banded_rcm
from mac_tpu_torch.ops.laplacian import build_operator
from mac_tpu_torch.ops.precond import extract_chain_weights
from mac_tpu_torch.optimization.constraints import (
    solve_subset_box_lp, solve_subset_box_lp_dynamic)
from mac_tpu_torch.optimization.frankwolfe import (_frank_wolfe_on_device,
                                                   frank_wolfe_lanes,
                                                   frank_wolfe_with_state)
from mac_tpu_torch.parallel import sharded as _sharded
from mac_tpu_torch.parallel.mesh import (MeshGroup, check_mesh, mesh_device,
                                         same_on_every_rank)
from mac_tpu_torch.solvers._host import HostSolveMixin, _graph_is_connected
from mac_tpu_torch.utils import fiedler as _fiedler
from mac_tpu_torch.utils.graphs import (edges_to_arrays,
                                        weight_graph_lap_from_edges)
from mac_tpu_torch.utils.rounding import (round_madow_base_dynamic,
                                          round_nearest,
                                          round_nearest_dynamic,
                                          round_nearest_np)

# lambda_2 / ||L||_inf below this cannot be resolved by a float32 eigensolve.
F32_SPECTRAL_RATIO_MIN = 1.2e-5
# The routing's size gate: without a mesh, instances of at most this many
# nodes run the host float64 engine even where float32 resolves their gap.
# The reference's rule, kept for parity: on graphs this small the device
# route's fixed cost per step outweighs its arithmetic, and the exact host
# solve needs no polish. intel (n = 1728) lies below the gate; sphere2500
# (n = 2500) above it, because its collapsed nearest rounding needs the
# device route's round guard.
SMALL_HOST_N = 2000


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


class MAC(HostSolveMixin):
    """Algebraic-connectivity-maximizing edge selection; the module
    docstring says how an instance routes itself.

    fixed_edges / candidate_edges: lists of `Edge` (or (idx, w) arrays).
    num_nodes: number of graph nodes.
    device: where the device engine runs, "cuda" by default; "cpu" runs the
        kernels' plain PyTorch versions. With a mesh, the mesh's device of
        this rank; a device that contradicts it raises.
    mesh: a ("sweep", "graph") torch.distributed DeviceMesh (make_mesh)
        spanning the process group, or None (see the module docstring).
    fiedler_block_q: the eigensolver's block width q (4 by default; any q,
        capped at n - 1). TRACEMIN's q x q and 3q x 3q Rayleigh-Ritz
        eigensolves run in the sym_eig kernel on a CUDA device: its warp
        body up to order 32, its thread-block body (K4w) past it.
    mesh_apply: the sharding of the matrix-free product on a mesh, "rows"
        (node rows, all-gathered; the default) or "edges" (round-robin
        edges, all-reduced).
    dtype: torch.float32 or torch.float64; None is float32, escalated to
        float64 by the spectral probe or the size gate (`auto_dtype_reason`
        says which, `spectral_ratio` holds the probe's ratio).
    fiedler_backend: "device" (the eigensolver of mac_tpu_torch.ops.lobpcg
        on `device`), "host" (numpy and scipy splu, solvers._host), or None
        for the automatic rule. The attribute holds the resolved value.
    The eigensolver and Frank-Wolfe knobs mirror mac_tpu.solvers.mac.MAC;
    None selects the route's automatic policy.
    fiedler_method: "tracemin" (its "_lu" / "_cholesky" aliases),
        "lobpcg" or "dense" (exact eigh), on either operator.
    fiedler_precond: the matrix-free operator's preconditioner, "twogrid"
        or "tridiag"; None takes "tridiag" for a float64 solve whose fixed
        edges hold the odometry chain and whose candidates number at most
        n / 5, "twogrid" otherwise.
    precond_refresh_period: on the banded route, rebuild the preconditioner
        only every p-th Frank-Wolfe step from step 8 on; on the host engine
        the splu cadence (the automatic rule there refactors every step).
    fw_polish / round_guard: the exact float64 host polish step and
        post-rounding repair (round_guard is an attribute in the
        reference). None resolves True on the banded float32 route for
        n <= 4096 and False elsewhere. The polish schedule is held in the
        attributes fw_polish_rounds, fw_polish_target,
        fw_polish_eval_budget and fw_polish_big_gap. An automatic polish
        is skipped when the loop's own duality gap estimate exceeds
        fw_polish_big_gap; an explicit fw_polish=True always runs.
    host_pcg (attribute, False): on the host engine, solve warm steps by
        block CG preconditioned with the last factor instead of
        refactoring.

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
        fiedler_backend=None,
        mesh_apply=None,
        precond_refresh_period=None,
        fw_polish=None,
        round_guard=None,
        device=None,
    ):
        fixed_idx, w_fixed = edges_to_arrays(fixed_edges)
        cand_idx, w_cand = edges_to_arrays(candidate_edges)
        n = int(num_nodes)
        num_edges = fixed_idx.shape[0] + cand_idx.shape[0]
        if not (n - 1 <= num_edges <= 0.5 * n * (n - 1)):
            raise ValueError(f"{num_edges} edges cannot form a connected "
                             f"simple graph on {n} nodes")
        if mesh is not None:
            check_mesh(mesh)
            mdev = mesh_device(mesh)
            want = None if device is None else torch.device(device)
            if want is not None and (want.type != mdev.type or want.index
                                     not in (None, mdev.index)):
                raise ValueError(f"device {device!r} contradicts the mesh's "
                                 f"device {mdev} on this rank")
            device = mdev
        elif device is None:
            device = "cuda"
        if mesh_apply not in (None, "rows", "edges"):
            raise ValueError(f"unknown mesh_apply {mesh_apply!r}")
        if fiedler_method in ("tracemin_lu", "tracemin_cholesky"):
            fiedler_method = "tracemin"
        if fiedler_method not in ("tracemin", "lobpcg", "dense"):
            raise ValueError(f"unknown fiedler_method {fiedler_method!r}")
        if fiedler_precond not in (None, "twogrid", "tridiag"):
            raise ValueError(f"unknown fiedler_precond {fiedler_precond!r}")
        if fiedler_backend not in (None, "device", "host"):
            raise ValueError(f"unknown fiedler_backend {fiedler_backend!r}")

        self.auto_dtype_reason = None
        self.spectral_ratio = None
        self._tiny_gap = False
        self._small_host = False
        if dtype is None:
            dtype, ratio = choose_compute_dtype(
                fixed_idx, w_fixed, cand_idx, w_cand, n)
            self.spectral_ratio = ratio
            if dtype == torch.float64:
                self.auto_dtype_reason = (
                    f"lambda_2/||L||_inf ~ {ratio:.2e} is below float32 "
                    "resolution; escalated to float64")
                self._tiny_gap = True
            elif (n <= SMALL_HOST_N and mesh is None
                  and fiedler_backend is None and use_banded is None):
                # See SMALL_HOST_N. An explicit dtype, use_banded or
                # fiedler_backend bypasses this: the knobs win.
                dtype = torch.float64
                self.auto_dtype_reason = (
                    f"small instance (n <= {SMALL_HOST_N}): the host float64 "
                    "engine outweighs the device route's fixed cost")
                self._small_host = True
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype {dtype} is neither torch.float32 nor "
                             "torch.float64")
        if fiedler_backend is None:
            # The probe's ratio cannot tell "disconnected" from "tiny gap"
            # (its estimate is noise at that level), so an exact O(m)
            # connectivity check decides; see _graph_is_connected.
            host_want = (self._tiny_gap or self._small_host) and mesh is None
            fiedler_backend = (
                "host" if host_want and _graph_is_connected(
                    np.concatenate([fixed_idx, cand_idx], axis=0), n)
                else "device")
        if mesh is not None and fiedler_backend == "host":
            raise ValueError("the host engine does not run on a mesh")
        self.fiedler_backend = fiedler_backend
        self.dtype = dtype
        self.device = resolve_device(device)
        self.num_nodes = n
        self._q = min(int(fiedler_block_q or 4), n - 1)
        self.fixed_idx = fixed_idx
        self.cand_idx = cand_idx
        self.weights = np.asarray(w_cand)
        self.edge_list = np.asarray(cand_idx)
        self._w_fixed_np = torch.as_tensor(w_fixed, dtype=dtype).numpy()

        # The device operator: the banded one when the graph admits a narrow
        # RCM band and use_banded is True, or unset in float32; else the
        # matrix-free one.
        all_idx = np.concatenate([fixed_idx, cand_idx], axis=0)
        want_banded = (use_banded if use_banded is not None
                       else dtype == torch.float32)
        bop, ridx = (build_banded_rcm(all_idx, n) if want_banded
                     else (None, None))
        self._banded = None
        self._perm = None
        self.op = None
        self.mesh = mesh
        self._group = None if mesh is None else MeshGroup(mesh)
        self._sharded = None
        if bop is not None:
            self._perm = bop.perm.numpy().astype(np.int64)
            if mesh is not None:
                # The rank's slice of the slot tables (parallel.sharded).
                self._sharded = _sharded.ShardedBanded(bop, self._group)
                bop = self._sharded.bop
            self._banded = bop.to(self.device)  # nn.Module.to moves in place
            operator = self._banded if mesh is None else self._sharded
            # Internal (RCM-relabelled) endpoints: the node space of the
            # device eigenvectors.
            self._int_idx = np.asarray(ridx, dtype=np.int64)
        elif mesh is not None:
            host_op = build_operator(all_idx, n, mode="ell")
            self._sharded = (_sharded.EdgeShardedLaplacian
                             if mesh_apply == "edges"
                             else _sharded.ShardedLaplacian)(host_op,
                                                             self._group)
            self.op = self._sharded.base
            operator = self._sharded
            self._int_idx = all_idx.astype(np.int64)
        else:
            self.op = build_operator(all_idx, n).to(self.device)
            operator = self.op
            self._int_idx = all_idx.astype(np.int64)
        # The reference's tuned operating point: the banded operator in
        # float32. A banded float64 solve keeps the conservative defaults.
        fast32 = self._banded is not None and dtype == torch.float32
        self._fast32 = fast32
        m_fixed = fixed_idx.shape[0]
        self._w_fixed = torch.as_tensor(w_fixed, dtype=dtype,
                                        device=self.device)
        self._w_cand = torch.as_tensor(w_cand, dtype=dtype, device=self.device)
        cand_int = torch.as_tensor(self._int_idx[m_fixed:], device=self.device)
        self._params = (self._w_fixed, self._w_cand, cand_int, operator)

        if fiedler_precond is None:
            # The reference's rule: the chain solve alone for float64
            # solves of a chain with few candidates.
            chain_only = (dtype == torch.float64
                          and cand_idx.shape[0] <= 0.2 * n
                          and extract_chain_weights(fixed_idx, w_fixed, n)
                          is not None)
            fiedler_precond = "tridiag" if chain_only else "twogrid"
        self.fiedler_method = fiedler_method
        self.fiedler_precond = fiedler_precond
        # The route's automatic policy (mac.py's fast32 policy on the banded
        # float32 route, the reference defaults elsewhere): explicit knobs
        # win.
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
        self._precond_period_user = precond_refresh_period is not None
        self.precond_refresh_period = (1 if precond_refresh_period is None
                                       else int(precond_refresh_period))
        self.min_selection_weight_tol = float(min_selection_weight_tol)
        # The exact host tails: automatic on the banded float32 route for
        # small graphs, where the float32 termination band is widest
        # relative to the objective and the narrow band keeps the host splu
        # eigensolves nearly free of fill. The guard is independent of
        # fw_polish=False: it pins the rounded value, the polish the
        # relaxed one.
        small_banded = fast32 and n <= 4096 and mesh is None
        self._fw_polish_user_set = fw_polish is not None
        self.fw_polish = bool(small_banded if fw_polish is None
                              else fw_polish)
        self.round_guard = bool(small_banded if round_guard is None
                                else round_guard)
        # The polish schedule (see _host_polish): at most this many exact
        # rounds, stop below this certified relative duality gap, at most
        # this many eigensolves beyond the base one, and one round only
        # when the first certified gap exceeds big_gap (an endpoint limited
        # by the step count, which no budget can certify away).
        self.fw_polish_rounds = 6
        self.fw_polish_target = 5e-6
        self.fw_polish_eval_budget = 12
        self.fw_polish_big_gap = 5e-3
        self.host_pcg = False

        self._X0 = torch.as_tensor(_fiedler.default_block(n, self._q),
                                   dtype=dtype, device=self.device)
        self.xprev0 = _fiedler.default_xprev(n, self._q, dtype, self.device)

    @staticmethod
    def _check_schedule(sched):
        sched = tuple((int(a), int(b)) for a, b in sched)
        if any(sched[i][0] >= sched[i + 1][0] for i in range(len(sched) - 1)):
            raise ValueError(f"schedule steps must ascend: {sched}")
        return sched

    # ------------------------------------------------------------------ core

    @property
    def _agree(self):
        """How the loops read their stop tests: a counted host read
        (ops.graphs.read_flag), or on a mesh the 'graph' group's
        agreement."""
        return (_graphs.read_flag if self._group is None
                else self._group.agree)

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
        """Every edge's weight at x (m,), or at each lane of x (R, m)."""
        w_fixed, w_cand, _, _ = params
        return torch.cat([w_fixed.expand(*x.shape[:-1], -1),
                          self._mask(x) * w_cand], dim=-1)

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
            banded_pstate=pstate, banded_use_prev=use_prev,
            banded_rebuild=rebuild, return_banded_pstate=want_pstate,
        )

    def _problem_impl(self, params, x, X, maxiter=None, pstate=None,
                      use_prev=None, rebuild=None, inner_iters=None):
        """(f, supergradient, Ritz block, outer iterations[, PrecondState])
        at x: grad_e = w_e (v_i - v_j)^2 over the candidates. With lanes
        (x (R, m), X (R, n, q)) each of them per lane."""
        _, w_cand, cand_int, _ = params
        want_pstate = pstate is not None
        out = self._fiedler(params, self._w_all(params, x), X,
                            maxiter=maxiter, pstate=pstate,
                            use_prev=use_prev, rebuild=rebuild,
                            want_pstate=want_pstate, inner_iters=inner_iters)
        res, pstate_new = out if want_pstate else (out, None)
        v = res.X[..., 0]
        if self.mesh is not None:
            grad = _sharded.sharded_candidate_gradient(self._group, cand_int,
                                                       w_cand, v)
        else:
            d = v[..., cand_int[:, 0]] - v[..., cand_int[:, 1]]
            grad = w_cand * d * d
        if want_pstate:
            return res.lam[..., 0], grad, res.X, res.iters, pstate_new
        return res.lam[..., 0], grad, res.X, res.iters

    def _fw_impl(self, params, x0, X0, *, k: int, maxiter: int,
                 relative_duality_gap_tol: float, grad_norm_tol: float,
                 use_cache: bool, schedule=None, inner_schedule=None,
                 tail_average: bool = False, verbose: bool = False):
        """The Frank-Wolfe loop with the Ritz block, the cumulative Fiedler
        iteration count, the step index and the preconditioner state
        threaded through its state; nearest rounding of the result (ties
        to the larger candidate weight). A single card's solve without
        verbose runs the loop's bookkeeping on the device (_fw_device);
        on a mesh, or with verbose, the host loop (_fw_host) runs it."""
        if schedule is None or not use_cache:
            schedule = ((1, self.fiedler_maxiter),)
        if not use_cache:
            inner_schedule = None
        loop = (self._fw_host if self.mesh is not None or verbose
                else self._fw_device)
        x, u, X, it, fiters = loop(
            params, x0, X0, k=k, maxiter=maxiter,
            relative_duality_gap_tol=relative_duality_gap_tol,
            grad_norm_tol=grad_norm_tol, use_cache=use_cache,
            schedule=schedule, inner_schedule=inner_schedule,
            tail_average_from=(maxiter // 2 if tail_average else None),
            verbose=verbose)
        rounded = round_nearest(x, k, weights=params[1],
                                break_ties_decimal_tol=10)
        return x, u, X, it, fiters, rounded

    def _pstate0(self):
        """The banded route's carried preconditioner state before the
        first step (the matrix-free route rebuilds its V-cycle every step:
        None)."""
        bop, dev = self._banded, self.device
        if bop is None:
            return None
        nc, n = bop.coarse_nc, bop.n
        return PrecondState(
            Lc_inv=torch.zeros((nc, nc), dtype=self.dtype, device=dev),
            chain_dp=torch.zeros(n, dtype=self.dtype, device=dev),
            chain_l=torch.zeros(n, dtype=self.dtype, device=dev))

    def _step_knobs(self, schedule, inner_schedule, step: int, pstate):
        """(outer-iteration cap, inner CG steps or None, use_prev, rebuild)
        of FW step `step`: the schedules, and with a carried state the
        Newton-Schulz coarse refresh once the FW step size 2/(step+2)
        bounds the operator change (step >= 4) and, with a refresh period
        p > 1, a rebuild only every p-th step from step 8 on. A function of
        the step alone."""
        mi = self._warm_cap(schedule, step)
        ii = (None if inner_schedule is None
              else self._warm_inner(inner_schedule, step))
        period = int(self.precond_refresh_period)
        rebuild = None if period <= 1 else (step < 8 or step % period == 0)
        use_prev = step >= 4 if pstate is not None else None
        return mi, ii, use_prev, rebuild

    def _fw_host(self, params, x0, X0, *, k, maxiter,
                 relative_duality_gap_tol, grad_norm_tol, use_cache,
                 schedule, inner_schedule, tail_average_from, verbose):
        """frank_wolfe_with_state on the host: its loop and MAC's step as
        PyTorch ops, the stop test read every step. Returns (x, u, X,
        iterations, Fiedler iterations)."""
        def problem(x, state):
            X, fiters, step, pstate = state
            mi, ii, use_prev, rebuild = self._step_knobs(
                schedule, inner_schedule, step, pstate)
            if pstate is None:
                f, grad, Xres, iters = self._problem_impl(
                    params, x, X, maxiter=mi, inner_iters=ii)
            else:
                f, grad, Xres, iters, pstate = self._problem_impl(
                    params, x, X, maxiter=mi, pstate=pstate,
                    use_prev=use_prev, rebuild=rebuild, inner_iters=ii)
            Xnew = Xres if use_cache else X0
            return f, grad, (Xnew, fiters + iters, step + 1, pstate)

        if self.mesh is None:
            def solve_lp(g):
                return solve_subset_box_lp(g, k)
        else:
            def solve_lp(g):
                return _sharded.sharded_top_k_indicator(self._group, g, k)

        x, u, (X, fiters, _, _), it = frank_wolfe_with_state(
            x0, (X0, 0, 0, self._pstate0()), problem, solve_lp,
            maxiter=maxiter,
            relative_duality_gap_tol=relative_duality_gap_tol,
            grad_norm_tol=grad_norm_tol, verbose=verbose,
            tail_average_from=tail_average_from, agree=self._agree)
        return x, u, X, it, fiters

    def _cand_ends(self, cand_int: torch.Tensor) -> torch.Tensor:
        """The candidates' endpoints cand_int (m, 2) as K9's int32 table,
        made once."""
        cached = getattr(self, "_ends", None)
        if cached is None or cached[0] is not cand_int:
            cached = self._ends = (cand_int,
                                   cand_int.to(torch.int32).contiguous())
        return cached[1]

    def _fw_device(self, params, x0, X0, *, k, maxiter,
                   relative_duality_gap_tol, grad_norm_tol, use_cache,
                   schedule, inner_schedule, tail_average_from, verbose):
        """_fw_host's loop with its bookkeeping on the device
        (optimization.frankwolfe._frank_wolfe_on_device: kernels K9 and
        K10, the stop test read with the next step's solve). A route with
        replayed graphs (fiedler.graph_route) solves each step over its
        static state (ops.graphs.StepSolves: K10 writes the weights the
        set-up reads, the stop flag travels in the set-up's flag read, the
        Ritz block and the carried state stay in place); any other route
        solves as _problem_impl does, from a weight vector K10 writes, and
        reads the stop flag before each step after the first. The same
        steps and results as _fw_host. Returns (x, u, X, iterations,
        Fiedler iterations)."""
        _, w_cand, _, op = params
        pstate0 = self._pstate0()
        w0 = self._w_all(params, x0)
        route = _fiedler.graph_route(op, w0, method=self.fiedler_method,
                                     precond=self.fiedler_precond)
        if route is not None:
            solves = _graphs.StepSolves(
                route, w0, X0, xprev0=self.xprev0, tol=self.fiedler_tol,
                rel_tol=self.fiedler_rel_tol,
                coeff_dtype=self.fiedler_coeff_dtype,
                inner_iters=self.fiedler_inner_iters, chain=use_cache)
            w_out, done = solves.w, solves.done

            def problem(x, state):
                _, fiters, step, pstate = state
                mi, ii, use_prev, rebuild = self._step_knobs(
                    schedule, inner_schedule, step, pstate)
                branch = _graphs.branch_of(pstate, use_prev, rebuild)
                iters = solves.step(
                    branch, mi, self.fiedler_inner_iters if ii is None
                    else ii)
                if iters is None:
                    X, carried = solves.stopped()
                    return None, None, (X, fiters, step, None if pstate
                                        is None else _graphs.banded_pstate(
                                            carried))
                if pstate is not None:
                    pstate = _graphs.banded_pstate(solves.state())
                return solves.f, solves.X, (solves.X if use_cache else X0,
                                            fiters + iters, step + 1, pstate)
        else:
            w_out = w0.clone()
            done = torch.zeros((), dtype=torch.bool, device=w0.device)

            def problem(x, state):
                X, fiters, step, pstate = state
                if step and _graphs.read_flag(done):
                    return None, None, state
                mi, ii, use_prev, rebuild = self._step_knobs(
                    schedule, inner_schedule, step, pstate)
                out = self._fiedler(
                    params, w_out, X, maxiter=mi, pstate=pstate,
                    use_prev=use_prev, rebuild=rebuild,
                    want_pstate=pstate is not None, inner_iters=ii)
                res, pstate = out if pstate is not None else (out, None)
                return res.lam[0], res.X.contiguous(), (
                    res.X if use_cache else X0, fiters + res.iters,
                    step + 1, pstate)

        x, u, (X, fiters, _, _), it = _frank_wolfe_on_device(
            x0, (X0, 0, 0, pstate0), problem, self._cand_ends(params[2]),
            w_cand, k, w_out, done, maxiter=maxiter,
            relative_duality_gap_tol=relative_duality_gap_tol,
            grad_norm_tol=grad_norm_tol,
            mask_tol=self.min_selection_weight_tol,
            tail_average_from=tail_average_from)
        return x, u, X.clone(), it, int(fiters)

    def _fw_dynamic_impl(self, params, x0, X0, ks, *, maxiter: int,
                         relative_duality_gap_tol: float,
                         grad_norm_tol: float, rounding: str, u=None,
                         schedule=None, tail_average_from=None):
        """The budget sweep's Frank-Wolfe loop over R lanes (x0 (R, m), ks
        (R,)): each lane's masked top-k oracle, the warm schedules of its
        step, and per-lane stops, a stopped lane frozen; the preconditioner
        is rebuilt every step (no PrecondState, as in the reference's
        sweep). Then nearest rounding (ties to the larger candidate weight)
        or Madow with the offsets u (R,), and every lane with k >= m takes
        every candidate. Returns (rounded, x, upper, iterations), per
        lane."""
        if schedule is None:
            schedule = self._warm_schedule
        inner_schedule = self._warm_inner_schedule

        def problem(x, X, step):
            mi = self._warm_cap(schedule, step)
            ii = (None if inner_schedule is None
                  else self._warm_inner(inner_schedule, step))
            f, grad, Xnew, _ = self._problem_impl(params, x, X, maxiter=mi,
                                                  inner_iters=ii)
            return f, grad, Xnew

        x, upper, _, it = frank_wolfe_lanes(
            x0, X0.expand(x0.shape[0], *X0.shape), problem,
            lambda g: solve_subset_box_lp_dynamic(g, ks), maxiter=maxiter,
            relative_duality_gap_tol=relative_duality_gap_tol,
            grad_norm_tol=grad_norm_tol, tail_average_from=tail_average_from,
            agree=self._agree)
        if rounding == "madow":
            rounded = round_madow_base_dynamic(x, ks, u)
        else:
            rounded = round_nearest_dynamic(x, ks, weights=params[1])
        take_all = (ks >= x.shape[-1])[:, None]
        rounded = torch.where(take_all, torch.ones_like(rounded), rounded)
        x = torch.where(take_all, torch.ones_like(x), x)
        return rounded, x, upper, it

    def _refine_lambda(self, x, v) -> float:
        """Float64 Rayleigh quotient of the Fiedler vector on the host, an
        exact sum over edges: v^T L(x) v = sum_e w_e (v_i - v_j)^2. `v`
        lives in the device operator's node ids (_int_idx)."""
        v = np.asarray(v, dtype=np.float64)
        v = v - v.mean()
        x = np.asarray(x, dtype=np.float64)
        keep = x > self.min_selection_weight_tol
        idx = self._int_idx
        w = np.concatenate(
            [self._w_fixed_np.astype(np.float64),
             np.where(keep, x, 0.0) * np.asarray(self.weights, np.float64)])
        d = v[idx[:, 0]] - v[idx[:, 1]]
        return float((w * d * d).sum() / (v * v).sum())

    def _eval_rel_tol(self):
        """Residual tolerance of standalone objective evaluations. In
        float32 at most 1e-3, since the Rayleigh quotient over-reports
        lambda_2 by up to ||r||_rel^2 / gap and the banded route's in-loop
        3e-2 would bias it by ~1e-3 relative; in float64 the solver's own
        fiedler_rel_tol."""
        if self.dtype == torch.float32:
            rt = self.fiedler_rel_tol
            return 1e-3 if rt is None else min(float(rt), 1e-3)
        return self.fiedler_rel_tol

    def _eval_impl(self, params, x: torch.Tensor, X0: torch.Tensor):
        """The eigensolve of an objective evaluation: from the cold start
        block, at least 100 outer iterations, the evaluation tolerance."""
        return self._fiedler(params, self._w_all(params, x), X0,
                             maxiter=max(self.fiedler_maxiter, 100),
                             rel_tol=self._eval_rel_tol())

    def _eval_many_impl(self, params, xs, X0: torch.Tensor):
        """lambda_2 estimates (the eigensolver's, not refined) of a batch
        of selections, one solve each."""
        return [float(self._eval_impl(
            params, torch.as_tensor(np.asarray(x), dtype=self.dtype,
                                    device=self.device), X0).lam[0])
                for x in xs]

    def _to_original_ids(self, X) -> np.ndarray:
        """A device Ritz block as float64 numpy in original node ids: the
        banded operator works in RCM ids, row i of its block being node
        perm[i]."""
        X_np = np.asarray(X, np.float64)
        if self._perm is None:
            return X_np
        out = np.empty_like(X_np)
        out[self._perm] = X_np
        return out

    # ------------------------------------------------------------ public API

    def laplacian(self, x):
        """Host-side L(x) as scipy CSR, pruning selection weights below
        `min_selection_weight_tol`."""
        x = np.asarray(x)
        keep = x > self.min_selection_weight_tol
        idx = np.concatenate([self.fixed_idx, self.cand_idx[keep]], axis=0)
        w = np.concatenate([self._w_fixed_np, x[keep] * self.weights[keep]])
        return weight_graph_lap_from_edges(idx, w, self.num_nodes)

    def evaluate_objective(self, x) -> float:
        """F(x) = lambda_2(L(x)) by the device engine (on every route; the
        host engine's instances evaluate in float64 there). In float32 the
        value is refined to float64 on the host by the exact edge-sum
        Rayleigh quotient of the Fiedler vector."""
        x = torch.as_tensor(np.array(x), dtype=self.dtype,
                            device=self.device)
        res = self._eval_impl(self._params, x, self._X0)
        if self.dtype == torch.float64:
            lam = float(res.lam[0])
        else:
            lam = self._refine_lambda(x.cpu().numpy(),
                                      res.X[:, 0].cpu().numpy())
        if self.mesh is not None:
            (lam,) = same_on_every_rank(self.mesh, lam)
        return lam

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

    def solve_sweep(
        self,
        ks,
        x_init=None,
        rounding: str = "nearest",
        max_iters: Optional[int] = None,
        relative_duality_gap_tol: Optional[float] = None,
        grad_norm_tol: float = 1e-8,
        seed: int = 0,
    ):
        """Solve a whole budget sweep as R lanes of one Frank-Wolfe solve on
        the device engine (mac_tpu.solvers.mac.MAC.solve_sweep).

        ks: (R,) budgets. x_init: optional (R, m) initial iterates, by
        default min(k, m) / m per lane. Returns numpy (rounded (R, m),
        unrounded (R, m), upper (R,)); upper is each lane's Frank-Wolfe dual
        bound, not solve's float64 certificate.

        The iteration policy is solve's: on the banded float32 route 32
        steps, the warm-cap schedule (1, 4), (4, 2), (10, 1) unless
        fiedler_warm_maxiter was set, the duality-gap stop off and the tail
        average from step 16 (with fw_tail_average); elsewhere 5 steps. Any
        unset gap tolerance is 1e-4. The warm inner-CG schedule applies.
        Every lane's eigensolve starts from the instance's start block, and
        lanes that stop early are frozen. Host-routed instances run the
        device engine here too; the exact host tails (polish, round guard)
        do not run. Madow rounding draws its R offsets from `seed`
        (MAC._madow_u).

        On a mesh whose 'sweep' dimension has s > 1 ranks, R must be a
        multiple of s: each 'sweep' coordinate solves its R / s lanes (the
        products sharded over its 'graph' group) and an all-gather over
        'sweep' assembles the results.
        """
        if rounding not in ("nearest", "madow"):
            raise ValueError(f"unknown rounding {rounding!r}")
        schedule = None
        tail_from = None
        if max_iters is None:
            if self._fast32:
                max_iters = 32
                if not self._warm_maxiter_user_set:
                    schedule = ((1, 4), (4, 2), (10, 1))
                if relative_duality_gap_tol is None:
                    relative_duality_gap_tol = 0.0
                if self.fw_tail_average:
                    tail_from = max_iters // 2
            else:
                max_iters = 5
        if relative_duality_gap_tol is None:
            relative_duality_gap_tol = 1e-4

        ks_np = np.asarray(ks, dtype=np.int64).reshape(-1)
        m = len(self.weights)
        R = len(ks_np)
        if x_init is None:
            x_init = np.repeat((np.minimum(ks_np, m) / m)[:, None], m, axis=1)
        x0 = torch.as_tensor(np.asarray(x_init, np.float64), dtype=self.dtype,
                             device=self.device)
        if tuple(x0.shape) != (R, m):
            raise ValueError(f"x_init has shape {tuple(x0.shape)}, want "
                             f"({R}, {m})")
        # Drawn for every lane, whatever share of them this rank solves.
        u = self._madow_u(seed, R) if rounding == "madow" else None
        sweep = None if self.mesh is None else MeshGroup(self.mesh, "sweep")
        if sweep is not None and sweep.size > 1:
            if R % sweep.size:
                raise ValueError(f"{R} budgets do not split over the "
                                 f"{sweep.size} ranks of 'sweep'")
            lanes = slice(sweep.rank * (R // sweep.size),
                          (sweep.rank + 1) * (R // sweep.size))
            x0, ks_np = x0[lanes], ks_np[lanes]
            u = None if u is None else u[lanes]
        out = self._fw_dynamic_impl(
            self._params, x0, self._X0,
            torch.as_tensor(ks_np, device=self.device),
            maxiter=int(max_iters),
            relative_duality_gap_tol=float(relative_duality_gap_tol),
            grad_norm_tol=float(grad_norm_tol), rounding=rounding, u=u,
            schedule=schedule, tail_average_from=tail_from)[:3]
        if sweep is not None and sweep.size > 1:
            out = [sweep.all_gather(t, dim=0) for t in out]
        out = [t.cpu().numpy() for t in out]
        if self.mesh is not None:
            out = same_on_every_rank(self.mesh, *out)
        return tuple(out)

    def solve(
        self,
        k: int,
        x_init=None,
        rounding: str = "nearest",
        fallback: bool = False,
        max_iters: Optional[int] = None,
        relative_duality_gap_tol: Optional[float] = None,
        grad_norm_tol: float = 1e-8,
        random_rounding_max_iters: int = 1,
        verbose: bool = False,
        return_rounding_time: bool = False,
        use_cache: bool = True,
        seed: int = 0,
        profile_dir: Optional[str] = None,
    ):
        """Solve the budgeted edge-selection problem.

        Returns (rounded, unrounded, upper_bound[, rounding seconds]) as
        mac_tpu.solvers.mac.MAC.solve does; k >= m selects everything and
        k <= 0 nothing, each with F of that selection as the bound.

        rounding: "nearest" (ties to the larger candidate weight) or
        "madow" (systematic sampling, the best of
        random_rounding_max_iters samples drawn from `seed`). fallback:
        return x_init when the rounded selection scores below it.

        max_iters=None selects the route's policy: on the banded float32
        route the fast32 one (32 steps, warm-cap schedule (1, 4), (4, 2),
        (10, 1), tail averaging, gap stop off; for n <= 4096 the exact
        polish and the round guard follow), on the host engine 20 exact
        steps under the 1e-4 gap stop, elsewhere (the banded float64
        route too) the reference's 5 steps. An explicit max_iters keeps the
        reference semantics (gap stop 1e-4, no tail averaging unless asked
        for).

        In float32 with use_cache, upper_bound is a rigorous float64
        certificate: the final iterate's Rayleigh quotient (of the polish's
        exact eigenvector when it ran) plus its supergradient linearisation
        maximised over the feasible set. In float64 it is the loop's own
        dual bound.

        profile_dir: run the solve under torch.profiler and write its
        Chrome trace to profile_dir/solve_trace.json.
        """
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                out = self.solve(
                    k, x_init=x_init, rounding=rounding, fallback=fallback,
                    max_iters=max_iters,
                    relative_duality_gap_tol=relative_duality_gap_tol,
                    grad_norm_tol=grad_norm_tol,
                    random_rounding_max_iters=random_rounding_max_iters,
                    verbose=verbose,
                    return_rounding_time=return_rounding_time,
                    use_cache=use_cache, seed=seed)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(profile_dir, "solve_trace.json"))
            return out
        if rounding not in ("nearest", "madow"):
            raise ValueError(f"unknown rounding {rounding!r}")
        m = len(self.weights)
        k = int(k)
        if k >= m or k <= 0:
            result = np.ones(m) if k >= m else np.zeros(m)
            obj = self.evaluate_objective(result)
            if return_rounding_time:
                return result, result, obj, 0.0
            return result, result, obj
        if x_init is None:
            x_init = np.full(m, k / m)
        x_init_np = np.asarray(x_init, np.float64)
        if x_init_np.shape != (m,):
            raise ValueError(f"x_init has shape {x_init_np.shape}, "
                             f"want ({m},)")

        if self.fiedler_backend == "host":
            rounded, x, upper, rounding_time = self._solve_host(
                k, x_init_np, rounding,
                20 if max_iters is None else int(max_iters),
                (1e-4 if relative_duality_gap_tol is None
                 else float(relative_duality_gap_tol)),
                grad_norm_tol, random_rounding_max_iters, verbose, seed,
                use_cache)
            if fallback and (self.evaluate_objective(rounded)
                             < self.evaluate_objective(x_init_np)):
                rounded = x_init_np
            if return_rounding_time:
                return rounded, x, upper, rounding_time
            return rounded, x, upper

        x_init = torch.as_tensor(x_init_np, dtype=self.dtype,
                                 device=self.device)
        schedule = self._warm_schedule
        tail_avg = False
        if max_iters is None and not self._fast32:
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
            schedule=schedule, inner_schedule=self._warm_inner_schedule,
            tail_average=tail_avg, verbose=bool(verbose))
        # The one fetch: everything below is host math.
        x = x_dev.cpu().numpy()
        u = float(u_dev)
        X = X_dev.cpu().numpy()
        rounded = rounded_dev.cpu().numpy()
        if not np.isfinite(u):
            # Degenerate operators (a graph disconnected even with every
            # candidate) can NaN the accumulated bound; substitute
            # lambda_2 <= 2 max weighted degree of the full graph.
            deg = np.zeros(self.num_nodes)
            all_w = np.concatenate([self._w_fixed_np,
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

        polished_v = None
        polished_X = None
        self._exact_evals = 0  # host float64 eigensolves of polish + guard
        run_polish = self.fw_polish
        if run_polish and use_cache and not self._fw_polish_user_set:
            # The pre-gate of the automatic polish (see fw_polish_big_gap):
            # the certified relative duality gap at the float32 endpoint,
            # estimated from the in-loop dual bound and the float64-refined
            # Rayleigh quotient, both in hand. An endpoint limited by the
            # step count cannot close its certificate within any sane
            # budget, so the host tail is skipped. An explicit
            # fw_polish=True is not gated; nor is a use_cache=False run,
            # whose X is the untouched start block and gives no estimate.
            f_est = self._refine_lambda(x, X[:, 0])
            gap_est = (u - f_est) / abs(f_est) if f_est else np.inf
            if gap_est > self.fw_polish_big_gap:
                run_polish = False
                self.last_solve_stats["polished"] = False
                self.last_solve_stats["polish_skipped_gap"] = float(gap_est)
        if run_polish:
            polish_start = timer()
            # The exact solves run in original node ids: the device basis
            # goes in through the permutation and the exact eigenvector
            # comes back through it, into the _int_idx space the
            # certificate below indexes. It is used even when the step is
            # rejected: it still tightens the certificate.
            x_pol, v_pol, polished_X, accepted = self._host_polish(
                x.astype(np.float64), k, X_warm=self._to_original_ids(X))
            polished_v = v_pol if self._perm is None else v_pol[self._perm]
            if accepted:
                x = x_pol
                # The in-loop nearest rounding saw the iterate before the
                # polish.
                rounded = round_nearest_np(
                    x_pol, k, weights=np.asarray(self.weights, np.float64),
                    break_ties_decimal_tol=10)
            self.last_solve_stats["polished"] = bool(accepted)
            self.last_solve_stats["polish_time_s"] = timer() - polish_start

        start = timer()
        if rounding == "madow":
            R = max(int(random_rounding_max_iters), 1)
            xs = self._madow_samples(x, k, seed, R)
            vals = (self._eval_many_impl(self._params, xs, self._X0)
                    if R > 1 else [0.0])
            rounded = xs[int(np.argmax(vals))]
        self.last_solve_stats["round_guard"] = False
        if rounding == "nearest" and self.round_guard and self.mesh is None:
            # The relaxed float64 anchor: the exact edge-sum Rayleigh
            # quotient of the best Fiedler vector in hand.
            v_int = (polished_v if polished_v is not None
                     else np.asarray(X[:, 0], np.float64))
            f_rel64 = self._refine_lambda(x, v_int)
            X_guard = (polished_X if polished_X is not None
                       else self._to_original_ids(X))
            guard_start = timer()
            rounded, guard_hit = self._round_guard_impl(
                np.asarray(rounded), x, f_rel64, k, seed, X_warm=X_guard)
            self.last_solve_stats["round_guard"] = bool(guard_hit)
            self.last_solve_stats["guard_time_s"] = timer() - guard_start
        self.last_solve_stats["exact_evals"] = self._exact_evals
        rounding_time = timer() - start

        if fallback and (self.evaluate_objective(rounded)
                         < self.evaluate_objective(x_init_np)):
            rounded = x_init_np

        rounded = np.asarray(rounded)
        unrounded = x
        upper = u
        if self.dtype == torch.float32 and use_cache:
            # The in-loop bound carries the float32 eigenvalue noise of its
            # f_i and can land below the refined objective; replace it by a
            # rigorous float64 certificate at the final iterate. (With the
            # cache off, X is the untouched start block, whose Rayleigh
            # quotient is uselessly loose: the in-loop bound stays.)
            v = (polished_v if polished_v is not None
                 else np.asarray(X[:, 0], dtype=np.float64))
            f64 = self._refine_lambda(unrounded, v)
            ci = self._int_idx[len(self.fixed_idx):]
            d = v[ci[:, 0]] - v[ci[:, 1]]
            vn = v - v.mean()
            grad64 = np.asarray(self.weights, np.float64) * d * d / (vn @ vn)
            s = np.zeros(m)
            top = np.argpartition(grad64, -k)[-k:]
            s[top[grad64[top] > 0]] = 1.0
            upper = float(f64 + grad64 @ (s - unrounded))
        if self.mesh is not None:
            rounded, unrounded, upper = same_on_every_rank(
                self.mesh, rounded, unrounded, upper)
        self.last_solve_stats["solve_total_s"] = timer() - solve_start
        if return_rounding_time:
            return rounded, unrounded, upper, rounding_time
        return rounded, unrounded, upper

"""Fiedler-pair front end (PyTorch counterpart of mac_tpu.utils.fiedler).

fiedler_pair_op solves on the banded operator or on a matrix-free
GraphOperator, for one weight vector or for R lanes of them (the budget
sweep); fiedler_pair_lanes solves R graphs that each add one edge to a
shared one (GreedyEig's trial chunk); find_fiedler_pair (and its
reference-name wrappers) takes a host Laplacian matrix, scipy sparse or
dense, and returns (lambda_2, v_2, X block) so that callers can warm-start
the next solve, on the plain or on the normalised Laplacian. Also here: the
deterministic start block, the device's default dtype, and the float64
scipy referee. Disconnected graphs are supported (lambda_2 = 0).
"""

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from mac_tpu_torch.device import resolve_device

from mac_tpu_torch.ops import banded as _banded
from mac_tpu_torch.ops import graphs as _graphs
from mac_tpu_torch.ops.cg import pcg_fixed
from mac_tpu_torch.ops.laplacian import (DENSE_MAX_N, GraphOperator,
                                         build_operator, lap_applier,
                                         lap_degrees, lap_dense,
                                         lap_inf_norm, lap_tridiagonal_part)
from mac_tpu_torch.ops.lobpcg import (TRACEMIN_INNER_ITERS, TRACEMIN_MAXITER,
                                      FiedlerResult, _shift_term,
                                      default_xprev, dense_fiedler,
                                      lobpcg_fiedler, on_flat_block,
                                      tracemin_fiedler,
                                      tracemin_fiedler_lanes)
from mac_tpu_torch.ops.precond import extract_chain_weights
from mac_tpu_torch.ops.tridiag import (tridiag_ldl_auto,
                                       tridiag_solve_factored_fast)
from mac_tpu_torch.ops.twogrid import make_twogrid_precond
from mac_tpu_torch.parallel import sharded as _sharded

_DEFAULT_SEED = 7  # the reference's np.random.RandomState(7) start block


def scipy_lam2(L) -> float:
    """Float64 lambda_2 of a host Laplacian by shift-invert Lanczos: the
    quality referee, independent of the port's own eigensolver."""
    import scipy.sparse.linalg as spla

    vals = spla.eigsh(L.astype(np.float64), k=2, sigma=-1e-9, which="LM",
                      return_eigenvectors=False)
    return float(np.sort(vals)[-1])


def default_dtype(device="cuda") -> torch.dtype:
    """The compute dtype a device defaults to: float64 on the CPU (the
    numerical-parity mode), float32 on a card."""
    return (torch.float64 if torch.device(device).type == "cpu"
            else torch.float32)


def default_block(n: int, q: Optional[int] = None, seed: Optional[int] = None,
                  dtype=None) -> np.ndarray:
    """Deterministic start block: q = min(4, n-1) columns of N(0, 1) from
    numpy's RandomState(7)."""
    if q is None:
        q = min(4, n - 1)
    rs = np.random.RandomState(_DEFAULT_SEED if seed is None else seed)
    X = np.asarray(rs.normal(size=(q, n))).T
    if dtype is not None:
        X = X.astype(dtype)
    return X


def _stack(results) -> FiedlerResult:
    """One FiedlerResult of per-lane results, the lane dimension first."""
    return FiedlerResult(
        lam=torch.stack([o.lam for o in results]),
        X=torch.stack([o.X for o in results]),
        iters=torch.tensor([int(o.iters) for o in results]),
        res=torch.stack([torch.as_tensor(o.res) for o in results]))


def _tracemin(apply_L, X, lnorm, Minv, *, lam0=None, warm_init=None, **kw):
    """tracemin_fiedler, or tracemin_fiedler_lanes for lanes (lnorm (R,));
    the lanes take the cold entry only. kw may hold `agree` and, for one
    solve, `inner_solve` (ops.graphs)."""
    if lnorm.dim() == 0:
        return tracemin_fiedler(apply_L, X, lnorm, Minv, lam0=lam0,
                                warm_init=warm_init, **kw)
    if lam0 is not None:
        raise ValueError("fiedler_pair_op: lanes take no warm entry (lam0)")
    return tracemin_fiedler_lanes(apply_L, X, lnorm, Minv, **kw)


def _lobpcg(apply_L, X, lnorm, Minv, *, xprev0, tol, maxiter, inner_iters,
            agree):
    """LOBPCG preconditioned by `inner_iters` PCG steps on the shifted
    operator, each step preconditioned by Minv."""
    def apply_shifted(V):
        return apply_L(V) + _shift_term(V, lnorm)

    def pc(R):
        return pcg_fixed(apply_shifted, R, Minv, iters=inner_iters)

    return lobpcg_fiedler(apply_L, X, lnorm, xprev0=xprev0, precond=pc,
                          tol=tol, maxiter=maxiter, agree=agree)


def _banded_pair(bop, w, X, *, xprev0, tol, maxiter, inner_iters, rel_tol,
                 coeff_dtype, pstate, use_prev, rebuild, return_pstate,
                 method="tracemin", sharded=None, **warm):
    """The banded branch: assemble BD(w), then by `method`
    * "tracemin": build the two-level preconditioner (warm-rebuilt from
      `pstate` when given) and run TRACEMIN; one solve (one weight vector,
      no mesh) goes through ops.graphs.solve, replayed CUDA graphs of each
      step's set-up and of the outer iteration on the card;
    * "lobpcg": the same preconditioner inside `inner_iters` PCG steps on
      the shifted operator, and LOBPCG (one weight vector);
    * "dense": the exact dense eigh of L(w) in the operator's RCM ids (a
      batched eigh for lanes), the incoming `pstate` returned unchanged so
      that a carried state keeps its structure.
    sharded: the parallel.sharded.ShardedBanded of `bop` on a mesh, whose
    row-sharded assembly and products take the place of the whole ones."""
    if method == "tracemin" and sharded is None and w.dim() == 1:
        # One solve: its set-up and outer iterations replay CUDA graphs on
        # the card (ops.graphs); the same build and loop on the CPU.
        branch = _graphs.branch_of(pstate, use_prev, rebuild)
        if branch == "carried" and pstate.chain_dp is None:
            branch = None  # a block-Jacobi state: not this route's
        if branch is not None:
            res, state = _graphs.solve(
                _graphs.banded_route(bop, _banded.PRECOND_KIND), w, X,
                carried=(_graphs.banded_carried(pstate)
                         if branch != "cold" else None),
                branch=branch, xprev0=xprev0, tol=tol, maxiter=maxiter,
                inner_iters=inner_iters, rel_tol=rel_tol,
                coeff_dtype=coeff_dtype, **warm)
            if return_pstate:
                return res, _graphs.banded_pstate(state)
            return res
    if sharded is None:
        BD = _banded.assemble_bd(bop, w)
        apply_L = _banded.BandedProduct(bop, BD)
    else:
        BD = sharded.assemble(w)

        def apply_L(V):
            return sharded.apply(BD, V)

        warm["agree"] = sharded.agree

    if method == "dense":
        L = (_banded.banded_dense(bop, BD) if sharded is None
             else sharded.dense(BD))
        res = dense_fiedler(L, X.shape[-1])
        return (res, pstate) if return_pstate else res
    want_state = pstate is not None or return_pstate
    # ||L||_inf = 2 max weighted degree, read off BD's diagonal.
    lnorm = 2.0 * BD.deg.amax(dim=(-2, -1))
    carry = (dict(prev_state=pstate, use_prev=use_prev, rebuild=rebuild)
             if want_state else {})
    Minv, built = _banded.make_banded_precond(
        bop, BD, w=w, return_state=True, sharded=sharded, **carry)
    pstate_out = built if want_state else None
    if method == "lobpcg":
        res = _lobpcg(apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol,
                      maxiter=maxiter, inner_iters=inner_iters,
                      agree=warm.get("agree", bool))
    else:
        res = _tracemin(
            apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol,
            maxiter=maxiter, inner_iters=inner_iters, rel_tol=rel_tol,
            coeff_dtype=coeff_dtype, **warm)
    return (res, pstate_out) if return_pstate else res


def fiedler_pair_op(
    op,
    w: torch.Tensor,
    X: torch.Tensor,
    *,
    tol: float = 1e-8,
    maxiter: int = TRACEMIN_MAXITER,
    inner_iters: int = TRACEMIN_INNER_ITERS,
    rel_tol: Optional[float] = None,
    chain_w: Optional[torch.Tensor] = None,
    method: str = "tracemin",
    precond: str = "twogrid",
    apply_override=None,
    banded: Optional["_banded.BandedOperator"] = None,
    coeff_dtype=None,
    banded_pstate: Optional["_banded.PrecondState"] = None,
    banded_use_prev: Optional[bool] = None,
    banded_rebuild: Optional[bool] = None,
    return_banded_pstate: bool = False,
    lam0: Optional[torch.Tensor] = None,
    warm_init: Optional[bool] = None,
    xprev0: Optional[torch.Tensor] = None,
    min_iters: Optional[int] = None,
):
    """Fiedler pair of L(w), X the (n, q) start block and xprev0 the block
    that seeds the eigensolver's previous-iterate memory (None: the
    default, ops.lobpcg.default_xprev).

    Lanes (the budget sweep): w (R, m) solves R weight vectors at once, X
    (R, n, q) holding each lane's start block; each lane gets its own
    operator and preconditioner, and the result holds lam (R, q), X
    (R, n, q) and iters (R,). The banded operator's lanes assemble through
    K2/K2b, build one chain factor and one coarse level each and run
    TRACEMIN over the lanes (its preconditioner state stays a single
    solve's); the ELL operator's lanes likewise (each lane's V-cycle, K1 or
    K1b, one launch for all lanes); the dense branch takes one batched
    eigh; LOBPCG runs lane after lane, on either operator. The lanes take
    TRACEMIN's cold entry (no lam0).

    lam0 / warm_init: TRACEMIN's warm entry (ops.lobpcg.tracemin_fiedler).
    min_iters: TRACEMIN's least number of outer iterations; by default 1
    with lam0 given, else 0.

    The banded operator, as the reference takes it: `banded` a
    BandedOperator and `op` the GraphOperator of the same (RCM) node ids,
    or `op` itself a BandedOperator. Then TRACEMIN (LOBPCG for
    method="lobpcg") runs with the banded two-level preconditioner, whose
    coarse inverse and chain factor banded_pstate / banded_use_prev /
    banded_rebuild carry across calls (ops.banded.make_banded_precond);
    method="dense" takes the exact dense eigh, of op's L(w) when `banded`
    is given (as the reference), of L(w) read off the banded operator in
    RCM ids when `op` is one. On a mesh `op` may be the sharded form
    (mac_tpu_torch.parallel.sharded: ShardedBanded, ShardedLaplacian,
    EdgeShardedLaplacian), which solves as the meshless one with its
    products, degrees and assembly sharded and every loop test agreed over
    the group. A GraphOperator takes:
      * the exact dense eigh for method="dense" or a dense-mode operator of
        at most DENSE_MAX_N nodes (unless apply_override is given);
      * otherwise the ELL (or dense-mode) product, or apply_override(w, V)
        in its place, the preconditioner `precond` -- "twogrid" (the
        V-cycle) or "tridiag" (the tridiagonal part's LDL^T solve alone, on
        1^perp) -- and TRACEMIN, or LOBPCG for method="lobpcg" (its
        preconditioner is `inner_iters` PCG steps on the shifted operator).
    chain_w: accepted for the reference's call form and unused: the
    tridiagonal part comes from (op, w) itself.

    Returns FiedlerResult, or (FiedlerResult, PrecondState or None) with
    return_banded_pstate=True; a route that builds no banded preconditioner
    returns the incoming banded_pstate unchanged.
    """
    if min_iters is None:
        min_iters = 1 if lam0 is not None else 0
    warm = dict(lam0=lam0, warm_init=warm_init, min_iters=min_iters)

    def _ret(res):
        return (res, banded_pstate) if return_banded_pstate else res

    if method == "lobpcg" and w.dim() == 2:
        # LOBPCG runs lane after lane, on either operator.
        return _ret(_stack([fiedler_pair_op(
            op, w[r], X[r], tol=tol, maxiter=maxiter,
            inner_iters=inner_iters, method=method, precond=precond,
            apply_override=apply_override, banded=banded, xprev0=xprev0)
            for r in range(w.shape[0])]))
    banded_sharded = isinstance(op, _sharded.ShardedBanded)
    op_banded = banded_sharded or isinstance(op, _banded.BandedOperator)
    if apply_override is not None and (op_banded or banded is not None):
        raise ValueError("fiedler_pair_op: apply_override replaces the "
                         "GraphOperator's product; it takes no banded "
                         "operator")
    if banded is not None and not (
            method == "dense" or (op.mode == "dense" and op.n <= DENSE_MAX_N)):
        op, op_banded = banded, True
    if op_banded:
        return _banded_pair(
            op.bop if banded_sharded else op, w, X, xprev0=xprev0, tol=tol,
            maxiter=maxiter, inner_iters=inner_iters, rel_tol=rel_tol,
            coeff_dtype=coeff_dtype, pstate=banded_pstate,
            use_prev=banded_use_prev, rebuild=banded_rebuild,
            return_pstate=return_banded_pstate, method=method,
            sharded=op if banded_sharded else None, **warm)
    sharded = None
    if isinstance(op, (_sharded.ShardedLaplacian,
                       _sharded.EdgeShardedLaplacian)):
        sharded, op = op, op.base
        warm["agree"] = sharded.agree
    if not isinstance(op, GraphOperator):
        raise TypeError(f"fiedler_pair_op: unknown operator {type(op)}")

    if apply_override is None and (
            method == "dense" or (op.mode == "dense" and op.n <= DENSE_MAX_N)):
        return _ret(dense_fiedler(lap_dense(op, w), X.shape[-1]))
    if (apply_override is None and sharded is None and op.mode == "ell"
            and precond == "twogrid" and method == "tracemin"
            and w.dim() == 1):
        # One TRACEMIN solve on the ELL product with the V-cycle: replayed
        # CUDA graphs of its set-up and outer iteration on the card
        # (ops.graphs); the same build and loop on the CPU.
        return _ret(_graphs.solve(
            _graphs.twogrid_route(op), w, X, xprev0=xprev0, tol=tol,
            maxiter=maxiter, inner_iters=inner_iters, rel_tol=rel_tol,
            coeff_dtype=coeff_dtype, **warm)[0])
    if apply_override is not None:
        def apply_L(V):
            return apply_override(w, V)
    elif sharded is None:
        apply_L = lap_applier(op, w)
    else:
        apply_L = sharded.applier(w)
    lnorm = (lap_inf_norm(op, w) if sharded is None
             else 2.0 * sharded.degrees(w).amax(dim=-1))
    if precond == "twogrid":
        Minv = make_twogrid_precond(op, w, apply_L, sharded)
    else:
        d, e = (lap_tridiagonal_part(op, w) if sharded is None
                else sharded.tridiagonal_part(w))
        eps = 100 * torch.finfo(w.dtype).eps
        fac = tridiag_ldl_auto(d + eps * d.amax(dim=-1, keepdim=True), e)

        def center(B):
            return B - B.mean(dim=-2, keepdim=True)

        def Minv(B):
            # On 1^perp, so the shifted constant mode is never amplified.
            return center(tridiag_solve_factored_fast(fac, center(B)))

    if method == "lobpcg":
        return _ret(_lobpcg(apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol,
                            maxiter=maxiter, inner_iters=inner_iters,
                            agree=warm.get("agree", bool)))
    return _ret(_tracemin(
        apply_L, X, lnorm, Minv, xprev0=xprev0, tol=tol, maxiter=maxiter,
        inner_iters=inner_iters, rel_tol=rel_tol, coeff_dtype=coeff_dtype,
        **warm))


def fiedler_pair_lanes(
    op: GraphOperator,
    w_base: torch.Tensor,
    lane_edges: torch.Tensor,
    lane_w: torch.Tensor,
    X: torch.Tensor,
    *,
    xprev0: torch.Tensor,
    tol: float = 1e-8,
    min_iters: int = 0,
) -> FiedlerResult:
    """Fiedler pairs of R graphs that each add one edge to L(w_base): lane
    r is L(w_base) + lane_w[r] a a^T, a the incidence vector of op's edge
    lane_edges[r]. What fiedler_pair_op computes for each lane's own weight
    vector (w_base with lane_w[r] added at lane_edges[r]) with its other
    knobs at their defaults (the plain version is fiedler_pair_lanes_plain),
    as one solve:

      * a dense-mode operator of at most DENSE_MAX_N nodes: one batched
        eigh of the R dense Laplacians;
      * otherwise TRACEMIN over the lanes (tracemin_fiedler_lanes), its
        product L(w_base) V on every lane's columns at once (the (n, R k)
        block) plus one gather and one index_add_ for the R rank-one terms,
        and every lane preconditioned by L(w_base)'s two-grid V-cycle,
        whose chain solves run on the (n, R q) block.

    X: the (n, q) start block of every lane. Returns FiedlerResult with lam
    (R, q) and X (R, n, q)."""
    n, q = X.shape
    R = lane_edges.shape[0]
    ends = op.idx.index_select(0, lane_edges)
    lanes = torch.arange(R, device=ends.device)
    lane_w = lane_w.to(w_base.dtype)
    if op.mode == "dense" and n <= DENSE_MAX_N:
        u, v = ends[:, 0], ends[:, 1]
        base = lanes * (n * n)
        flat = torch.cat([base + u * n + u, base + v * n + v,
                          base + u * n + v, base + v * n + u])
        L = lap_dense(op, w_base).expand(R, n, n).clone()
        L.view(-1).index_add_(0, flat, torch.cat([lane_w, lane_w,
                                                  -lane_w, -lane_w]))
        return dense_fiedler(L, q)
    apply_base = lap_applier(op, w_base)
    # Rows of lane r's endpoints in the (n R, k) view of an (n, R k) block.
    rows = torch.cat([ends[:, 0] * R + lanes, ends[:, 1] * R + lanes])

    def apply_L(V):
        k = V.shape[1] // R
        d = V.reshape(n * R, k).index_select(0, rows)
        t = lane_w[:, None] * (d[:R] - d[R:])
        out = apply_base(V).reshape(n * R, k)
        return out.index_add_(0, rows, torch.cat([t, -t])).reshape(n, R * k)

    deg = lap_degrees(op, w_base)
    lnorm = 2.0 * torch.maximum(
        deg.max(), torch.maximum(deg[ends[:, 0]], deg[ends[:, 1]]) + lane_w)
    return tracemin_fiedler_lanes(
        on_flat_block(apply_L), X, lnorm,
        on_flat_block(make_twogrid_precond(op, w_base, apply_base)),
        xprev0=xprev0, tol=tol, min_iters=min_iters)


def fiedler_pair_lanes_plain(op: GraphOperator, w_base: torch.Tensor,
                             lane_edges: torch.Tensor, lane_w: torch.Tensor,
                             X: torch.Tensor, *, xprev0: torch.Tensor,
                             tol: float = 1e-8,
                             min_iters: int = 0) -> FiedlerResult:
    """Plain version of fiedler_pair_lanes: one fiedler_pair_op per lane on
    its own weight vector, each with its own preconditioner (what the JAX
    package's vmap computes). Used by the tests and chip_smoke.py."""
    return _stack([fiedler_pair_op(
        op, w_base.index_add(0, lane_edges[r:r + 1],
                             lane_w[r:r + 1].to(w_base.dtype)),
        X, xprev0=xprev0, tol=tol, min_iters=min_iters)
        for r in range(lane_edges.shape[0])])


def _op_from_matrix(L) -> Tuple[GraphOperator, np.ndarray,
                                Optional[np.ndarray]]:
    """(operator on the CPU, edge weights, chain weights or None) of a host
    Laplacian matrix. The chain weights come back when the graph holds the
    whole path 0-1-...-(n-1)."""
    if sp.issparse(L):
        coo = sp.triu(L, k=1).tocoo()
        idx = np.stack([coo.row, coo.col], axis=1).astype(np.int32)
        w = -np.asarray(coo.data)
    else:
        L = np.asarray(L)
        iu, ju = np.triu_indices(L.shape[0], k=1)
        vals = L[iu, ju]
        nz = vals != 0
        idx = np.stack([iu[nz], ju[nz]], axis=1).astype(np.int32)
        w = -vals[nz]
    n = L.shape[0]
    return build_operator(idx, n), w, extract_chain_weights(idx, w, n)


def _normalized_fiedler(L, X: torch.Tensor, tol: float, maxiter: int,
                        xprev0: Optional[torch.Tensor] = None):
    """Fiedler pair of the normalised Laplacian N = D^(-1/2) L D^(-1/2).

    N is applied matrix-free through the similarity transform; TRACEMIN
    runs with the nullspace generalised to u = D^(1/2) 1 / ||D^(1/2) 1||
    and the two-grid V-cycle of L conjugated back through D^(1/2)
    (M_N^-1 = D^(1/2) M_L^-1 D^(1/2), exact if M_L were L). The
    eigenvalues of N lie in [0, 2], so the nullspace shift is 2. Up to
    DENSE_MAX_N nodes: an exact float64 eigh on the host.
    """
    n = L.shape[0]
    dtype, dev = X.dtype, X.device
    d = np.asarray(L.diagonal() if sp.issparse(L) else np.diag(np.asarray(L)),
                   dtype=np.float64)
    if np.any(d <= 0):
        raise ValueError(
            "normalized Laplacian needs strictly positive degrees; "
            f"min diagonal = {d.min()} (isolated node?)")
    s_host = 1.0 / np.sqrt(d)
    if n <= DENSE_MAX_N:
        Ld = np.asarray(L.todense() if sp.issparse(L) else L,
                        dtype=np.float64)
        N = s_host[:, None] * Ld * s_host[None, :]
        evals, vecs = np.linalg.eigh((N + N.T) / 2)
        q = X.shape[1]
        Xb = torch.as_tensor(vecs[:, 1:q + 1], dtype=dtype, device=dev)
        return (torch.as_tensor(evals[1], dtype=dtype, device=dev),
                Xb[:, 0], Xb)

    op, w, _ = _op_from_matrix(L)
    op = op.to(dev)
    w = torch.as_tensor(w, dtype=dtype, device=dev)
    s = torch.as_tensor(s_host, dtype=dtype, device=dev)[:, None]
    sqd = torch.as_tensor(np.sqrt(d), dtype=dtype, device=dev)[:, None]
    u = torch.as_tensor(np.sqrt(d) / np.linalg.norm(np.sqrt(d)), dtype=dtype,
                        device=dev)
    apply_L = lap_applier(op, w)
    Minv_L = make_twogrid_precond(op, w, apply_L)
    if xprev0 is None:
        xprev0 = default_xprev(n, X.shape[1], dtype, dev)
    res = tracemin_fiedler(
        lambda V: s * apply_L(s * V), X,
        torch.tensor(2.0, dtype=dtype, device=dev),
        lambda B: sqd * Minv_L(sqd * B), xprev0=xprev0, tol=tol,
        maxiter=maxiter, nullvec=u)
    return res.lam[0], res.X[:, 0], res.X


def find_fiedler_pair(
    L,
    X=None,
    method: str = "tracemin",
    tol: float = 1e-8,
    seed=None,
    maxiter: int = 1000,
    normalized: bool = False,
    device="cuda",
    xprev0: Optional[torch.Tensor] = None,
):
    """(lambda_2(L), v_2(L), X block) of a host Laplacian, as tensors on
    `device`.

    L: scipy sparse or dense (n, n) Laplacian.
    X: optional (n, q) warm-start block of any width 1 <= q < n; None seeds
       q = min(4, n-1) columns like the reference (RandomState(7), or
       `seed`, an int or a numpy RandomState).
    method: "tracemin" (default; "tracemin_lu" and "tracemin_cholesky" are
       the same engine), "lobpcg" or "dense".
    normalized: solve on D^(-1/2) L D^(-1/2) (see _normalized_fiedler).
    device: where the solve runs, "cuda" by default, in its default dtype
       (float32 on a card, float64 on the CPU).
    xprev0: the (n, q) block that seeds the eigensolver's previous-iterate
       memory; N(0, 1) from seed 7 when None.
    """
    n = L.shape[0]
    dev = resolve_device(device)
    dtype = default_dtype(dev)
    if X is None:
        q = min(4, n - 1)
        if isinstance(seed, np.random.RandomState):
            X = np.asarray(seed.normal(size=(q, n))).T
        else:
            X = default_block(n, q, seed=seed)
    if isinstance(X, torch.Tensor):
        X = X.to(device=dev, dtype=dtype)
    else:
        X = torch.as_tensor(np.asarray(X), dtype=dtype, device=dev)
    if X.shape[0] != n or not 1 <= X.shape[1] < max(n, 2):
        raise ValueError(f"X has shape {tuple(X.shape)}, want ({n}, q) with "
                         f"1 <= q < {max(n, 2)}")
    if method in ("tracemin_lu", "tracemin_cholesky"):
        method = "tracemin"
    if method not in ("tracemin", "lobpcg", "dense"):
        raise ValueError(f"unknown method {method!r}")
    if normalized:
        return _normalized_fiedler(L, X, tol, maxiter, xprev0=xprev0)
    op, w, _ = _op_from_matrix(L)
    if xprev0 is None:
        xprev0 = default_xprev(n, X.shape[1], dtype, dev)
    res = fiedler_pair_op(
        op.to(dev), torch.as_tensor(w, dtype=dtype, device=dev), X,
        xprev0=xprev0, tol=tol, maxiter=maxiter, method=method)
    return res.lam[0], res.X[:, 0], res.X


def tracemin_fiedler_cholesky(L, X=None, normalized=False, tol=1e-8,
                              device="cuda"):
    """The reference library's name for its TRACEMIN solver with CHOLMOD
    inner solves; here every tracemin method runs the preconditioned
    engine. Returns (numpy [lambda_2], numpy X^T); normalized=True works
    (see _normalized_fiedler)."""
    lam, _, Xb = find_fiedler_pair(L, X=X, method="tracemin_cholesky",
                                   tol=tol, normalized=normalized,
                                   device=device)
    return np.array([float(lam)]), Xb.cpu().numpy().T


def find_fiedler_pair_cholesky(L, x=None, normalized=False, tol=1e-8,
                               seed=None, device="cuda"):
    """The reference library's name: (lambda_2, Fiedler vector), numpy."""
    sigma, X = tracemin_fiedler_cholesky(L, X=x, normalized=normalized,
                                         tol=tol, device=device)
    return sigma[0], X[0]

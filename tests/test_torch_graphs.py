"""The eigensolver's graphed solve (mac_tpu_torch.ops.graphs) on the CPU,
where its functions run as calls over the same static buffers a graph
reads: the closures built over copies of a step's state against the
freshly built ones (bitwise), the inner solve against the JAX package's
pcg_fixed with its own preconditioners (float64, 1e-10), the set-up and
outer-iteration functions over static buffers against the eager code
(bitwise, every branch, exact and blocked factors), a set guard flag
leading to an eager redo, the routes that take the graphed solve and those
that stay eager, and the bookkeeping that keeps the kernels' launch counts
true across replays. The replays themselves need the card
(tests/test_torch_cuda.py). Inputs are made from seeds with numpy and
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu.ops import laplacian as jl
from mac_tpu.ops.cg import pcg_fixed as jax_pcg_fixed
from mac_tpu.ops.lobpcg import _shift_term as jax_shift_term
from mac_tpu.ops.twogrid import make_twogrid_precond as jax_twogrid
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.ops import graphs
from mac_tpu_torch.ops import laplacian as tl
from mac_tpu_torch.ops.lobpcg import _shift_term
from mac_tpu_torch.ops.twogrid import make_twogrid_precond, twogrid_level
from mac_tpu_torch.utils.fiedler import fiedler_pair_op
from tests.test_torch_laplacian import graph_and_weights

torch.set_num_threads(1)

ITERS = 6
RTOL = 1e-10


def _pose_graph(n, n_loops, span=40, seed=3):
    """Chain + short-range loop closures: banded after RCM."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


def _shifts(lnorm):
    """TRACEMIN's c and sigma of an operator with ||L||_inf = lnorm."""
    c = lnorm.to(torch.float64)
    return {"c": c, "sigma": 32 * torch.finfo(torch.float64).eps * c}


def _blocks(n, seed=5):
    rng = np.random.RandomState(seed)
    return rng.normal(size=(n, 4)), rng.normal(size=(n, 4))


def _fresh_inner(apply_L, c, sigma):
    """TRACEMIN's apply_inner, written as ops.lobpcg.tracemin_fiedler
    writes it."""
    def apply_shifted(V):
        return apply_L(V) + _shift_term(V, c)

    return lambda V: apply_shifted(V) + sigma * V


def _banded_step(n, kind):
    """(bop, state with c and sigma, fresh apply_L, fresh Minv) at one
    weight vector: the build a Frank-Wolfe step makes."""
    idx, w_np, n = _pose_graph(n, n // 4)
    bop = tb.build_banded_rcm(idx, n)[0]
    w = torch.as_tensor(w_np)
    BD = tb.assemble_bd(bop, w)
    M, st = tb.make_banded_precond(bop, BD, w=w, kind=kind,
                                   return_state=True)
    state = dict(graphs.banded_state(BD, st),
                 **_shifts(2.0 * BD.deg.amax()))
    return bop, state, (lambda V: tb.banded_apply(bop, BD, V)), M


def _twogrid_step(n):
    idx, w_np, n = graph_and_weights(n)
    op = tl.build_operator(idx, n)
    w = torch.as_tensor(w_np.astype(np.float64))
    apply_L = tl.lap_applier(op, w)
    M = make_twogrid_precond(op, w, apply_L)
    fac, Lc_inv = twogrid_level(op, w)
    state = dict(graphs.twogrid_state(tl.lap_weight_table(op, w), fac,
                                      Lc_inv), **_shifts(tl.lap_inf_norm(op,
                                                                         w)))
    return op, fac.seg, state, apply_L, M


@pytest.mark.parametrize("route", ["banded-mult-700", "banded-additive-700",
                                   "banded-mult-4500", "twogrid-3000",
                                   "twogrid-34000"])
def test_closures_over_static_copies_are_bitwise_the_fresh_ones(route):
    """The closures an InnerSolve builds over copies of a step's state (what
    a captured graph reads) give bitwise the Minv(R) and apply_inner(V) of
    the preconditioner and product built fresh at that step: the banded
    chain cycle of both kinds (exact factor at n = 700, blocked at 4500)
    and the two-grid V-cycle (exact at 3000, blocked past 32768 rows)."""
    kind_or_n = route.split("-")
    if kind_or_n[0] == "banded":
        kind, n = kind_or_n[1], int(kind_or_n[2])
        bop, state, apply_L, M = _banded_step(n, kind)
        solve = graphs.banded_route(bop, kind)
    else:
        n = int(kind_or_n[1])
        op, seg, state, apply_L, M = _twogrid_step(n)
        assert seg == (None if n <= 32768 else 1024)
        solve = graphs.twogrid_route(op)
    static = {name: t.clone() for name, t in state.items()}
    apply_static, Minv = solve.build(static)
    R, V = (torch.as_tensor(a) for a in _blocks(n))
    assert torch.equal(Minv(R), M(R))
    fresh = _fresh_inner(apply_L, state["c"], state["sigma"])
    assert torch.equal(_fresh_inner(apply_static, static["c"],
                                    static["sigma"])(V), fresh(V))
    # The inner solve over static copies is the eager loop over the fresh
    # closures.
    X0 = torch.as_tensor(_blocks(n, seed=6)[0])
    from mac_tpu_torch.ops.cg import pcg_fixed

    assert torch.equal(graphs.inner_replay(solve, state, R, X0, 3),
                       pcg_fixed(fresh, R, M, iters=3, X0=X0))
    assert solve.captures == solve.replays == 0


def test_operators_with_inner_solves_free_without_the_cycle_collector():
    """An operator and its InnerSolves form no reference cycle, so the
    operator (and on the card its graphs) goes when its last reference
    does, not at some later collection, which could fall inside another
    graph's capture and spoil it."""
    import gc
    import weakref

    bop, state, *_ = _banded_step(700, "mult")
    op, seg, *_ = _twogrid_step(3000)
    graphs.banded_route(bop, "mult")
    graphs.twogrid_route(op)
    refs = [weakref.ref(bop), weakref.ref(op)]
    del bop, op, state, _
    gc.disable()
    try:
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_banded_inner_solve_matches_jax():
    """The plain version of the banded route's inner solve (n = 700, the
    multiplicative chain cycle) against mac_tpu.ops.cg.pcg_fixed on the JAX
    package's banded_apply, shift term and make_banded_precond, from the
    same B and X0: within 1e-10 of max |X| in float64."""
    idx, w_np, n = _pose_graph(700, 175)
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jnp.float64)
    B, X0 = _blocks(n)

    @jax.jit
    def run_jax(w, B, X0):
        BD = jb.assemble_bd(jbop, w, fused=False)
        M = jb.make_banded_precond(jbop, BD, w=w, kind="mult")
        c = 2.0 * jnp.max(BD.deg)
        sigma = 32 * jnp.finfo(jnp.float64).eps * c

        def apply_inner(V):
            return (jb.banded_apply(jbop, BD, V) + jax_shift_term(V, c)
                    + sigma * V)

        return jax_pcg_fixed(apply_inner, B, M, iters=ITERS, X0=X0)

    ref = np.asarray(run_jax(jnp.asarray(w_np), jnp.asarray(B),
                             jnp.asarray(X0)))
    bop = convert.banded_operator(jbop)
    w = torch.as_tensor(w_np)
    BD = tb.assemble_bd(bop, w)
    _, st = tb.make_banded_precond(bop, BD, w=w, kind="mult",
                                   return_state=True)
    state = dict(graphs.banded_state(BD, st),
                 **_shifts(2.0 * BD.deg.amax()))
    got = graphs.inner_replay(graphs.banded_route(bop, "mult"), state,
                              torch.as_tensor(B), torch.as_tensor(X0), ITERS)
    _close(got.numpy(), ref)


def test_twogrid_inner_solve_matches_jax():
    """The plain version of the matrix-free route's inner solve (the ELL
    product and the two-grid V-cycle, n = 3000) against mac_tpu.ops.cg.
    pcg_fixed on the JAX package's lap_apply, shift term and
    make_twogrid_precond: within 1e-10 of max |X| in float64. The weights
    are multiples of 1/8 up to 2, so that the JAX package's float32
    accumulation of the coarse operator is exact, as the port's float64 one
    is; the inner solve is what is compared."""
    idx, _, n = graph_and_weights(3000)
    rng = np.random.RandomState(9)
    w_np = rng.randint(1, 17, size=len(idx)) / 8.0
    jop = jl.build_operator(idx, n)
    B, X0 = _blocks(n)

    @jax.jit
    def run_jax(w, B, X0):
        def apply_L(V):
            return jl.lap_apply(jop, w, V)

        M = jax_twogrid(jop, w, apply_L)
        c = jl.lap_inf_norm(jop, w)
        sigma = 32 * jnp.finfo(jnp.float64).eps * c

        def apply_inner(V):
            return apply_L(V) + jax_shift_term(V, c) + sigma * V

        return jax_pcg_fixed(apply_inner, B, M, iters=ITERS, X0=X0)

    ref = np.asarray(run_jax(jnp.asarray(w_np), jnp.asarray(B),
                             jnp.asarray(X0)))
    op = tl.build_operator(idx, n)
    w = torch.as_tensor(w_np)
    fac, Lc_inv = twogrid_level(op, w)
    state = dict(graphs.twogrid_state(tl.lap_weight_table(op, w), fac,
                                      Lc_inv), **_shifts(tl.lap_inf_norm(op,
                                                                         w)))
    got = graphs.inner_replay(graphs.twogrid_route(op), state,
                              torch.as_tensor(B), torch.as_tensor(X0), ITERS)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("case", ["banded", "ell", "banded-lanes",
                                  "ell-lobpcg", "ell-tridiag"])
def test_single_solves_take_the_inner_solve_and_others_stay_eager(
        case, monkeypatch):
    """fiedler_pair_op sends one solve on the banded operator and on the
    ELL operator with the V-cycle through its route's solve (ops.graphs;
    plain_solve on the CPU), and its result is bitwise that of the eager
    build and tracemin_fiedler loop; lanes, LOBPCG and the tridiagonal
    preconditioner stay eager."""
    from mac_tpu_torch.ops.lobpcg import tracemin_fiedler
    from mac_tpu_torch.ops.twogrid import make_twogrid_precond

    if case.startswith("banded"):
        idx, w_np, n = _pose_graph(700, 175)
        op = tb.build_banded_rcm(idx, n)[0]
    else:
        idx, w_np, n = graph_and_weights(600)
        op = tl.build_operator(idx, n)
    w = torch.as_tensor(np.asarray(w_np, dtype=np.float64))
    X = torch.as_tensor(_blocks(n)[0])
    kw = dict(maxiter=3, inner_iters=4,
              xprev0=torch.as_tensor(_blocks(n, seed=7)[0]))
    if case.endswith("lanes"):
        w, X = torch.stack([w, 0.5 * w]), torch.stack([X, X])
    elif case.endswith("lobpcg"):
        kw["method"] = "lobpcg"
    elif case.endswith("tridiag"):
        kw["precond"] = "tridiag"
    calls = []
    real = graphs.plain_solve

    def counted(*args, **kwargs):
        calls.append(kwargs["inner_iters"])
        return real(*args, **kwargs)

    monkeypatch.setattr(graphs, "plain_solve", counted)
    res = fiedler_pair_op(op, w, X, **kw)
    single = case in ("banded", "ell")
    assert calls == ([4] if single else [])
    if single:
        if case == "banded":
            BD = tb.assemble_bd(op, w)
            M = tb.make_banded_precond(op, BD, w=w)
            lnorm = 2.0 * BD.deg.amax(dim=(-2, -1))

            def apply_L(V):
                return tb.banded_apply(op, BD, V)
        else:
            apply_L = tl.ell_applier(op, tl.lap_weight_table(op, w))
            M = make_twogrid_precond(op, w, apply_L)
            lnorm = tl.lap_inf_norm(op, w)
        eager = tracemin_fiedler(apply_L, X, lnorm, M, **kw)
        assert res.iters == eager.iters
        assert torch.equal(res.lam, eager.lam) and torch.equal(res.X,
                                                               eager.X)


def _same(a, b):
    """Bitwise equal FiedlerResults, or dicts of tensors."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name
        return
    assert a.iters == b.iters
    for name in ("lam", "X", "res"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


SOLVE_KW = dict(tol=1e-8, maxiter=3, inner_iters=3, rel_tol=None,
                coeff_dtype=None)


@pytest.mark.parametrize("route", ["banded-700", "banded-4500",
                                   "twogrid-3000", "twogrid-34000"])
def test_setup_and_outer_over_static_buffers_are_bitwise_the_eager_code(
        route):
    """graphed_solve, whose set-up and outer-iteration functions run here
    as calls over the static buffers a graph reads and writes (the carry
    updated in place, Xprev <- X aliased), against the eager code: the
    preconditioner built by make_banded_precond / twogrid_level and
    tracemin_fiedler's loop. Bitwise: the Ritz pairs, the residual, the
    iteration count and the route's state, over Frank-Wolfe-like steps at
    three weight vectors: on the banded operator (the multiplicative chain
    cycle; exact factor at n = 700, blocked past 4096) a cold build, a
    Newton-Schulz refresh and a carried state, each from the state the
    step before left; on the ELL operator (exact factor at 3000, blocked
    past 32768) a cold build each step."""
    from mac_tpu_torch.ops.lobpcg import tracemin_fiedler
    from mac_tpu_torch.ops.twogrid import twogrid_cycle

    kind, n = route.split("-")[0], int(route.split("-")[1])
    if kind == "banded":
        idx, w_np, n = _pose_graph(n, n // 4)
        op = tb.build_banded_rcm(idx, n)[0]
        rt = graphs.banded_route(op, "mult")
        branches = ("cold", "ns", "carried")
    else:
        idx, w_np, n = graph_and_weights(n)
        op = tl.build_operator(idx, n)
        rt = graphs.twogrid_route(op)
        branches = ("cold", "cold", "cold")
    X = torch.as_tensor(_blocks(n)[0])
    xprev0 = torch.as_tensor(_blocks(n, seed=7)[0])
    kw = dict(SOLVE_KW, xprev0=xprev0)
    carried = None
    for step, branch in enumerate(branches):
        scale = 0.5 + np.random.RandomState(step).rand(len(w_np))
        w = torch.as_tensor(np.asarray(w_np, np.float64) * scale)
        got, state = graphs.graphed_solve(rt, w, X, carried=carried,
                                          branch=branch, **kw)
        if kind == "banded":
            BD = tb.assemble_bd(op, w)
            prev = (dict(prev_state=graphs.banded_pstate(carried),
                         use_prev=branch == "ns",
                         rebuild=None if branch == "ns" else False)
                    if carried is not None else {})
            M, pst = tb.make_banded_precond(op, BD, w=w, return_state=True,
                                            kind="mult", **prev)
            lnorm = 2.0 * BD.deg.amax(dim=(-2, -1))
            eager_state = graphs.banded_state(BD, pst)

            def apply_L(V, BD=BD):
                return tb.banded_apply(op, BD, V)
        else:
            apply_L = tl.ell_applier(op, tl.lap_weight_table(op, w))
            fac, Lc_inv = twogrid_level(op, w)
            M = twogrid_cycle(op, fac, Lc_inv, apply_L)
            lnorm = tl.lap_inf_norm(op, w)
            eager_state = graphs.twogrid_state(tl.lap_weight_table(op, w),
                                               fac, Lc_inv)
        eager = tracemin_fiedler(apply_L, X, lnorm, M, **kw)
        _same(got, eager)
        _same(state, eager_state)
        assert got.iters > 0
        X, carried = got.X, state
    assert rt.captures == rt.replays == rt.redos == 0


def _two_components(n=600, seed=4):
    """Two chains of n / 2 nodes with closures inside each: a disconnected
    ELL graph whose components are made of whole coarse aggregates, so its
    coarse operator is singular past the constant shift."""
    rng = np.random.RandomState(seed)
    half = n // 2
    edges = []
    for base in (0, half):
        edges += [(base + i, base + i + 1) for i in range(half - 1)]
        for _ in range(half // 2):
            i = rng.randint(0, half - 3)
            edges.append((base + i, base + i + 2 + rng.randint(
                min(20, half - i - 2))))
    idx = np.array(edges, dtype=np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


@pytest.mark.parametrize("case", ["nonfinite-carry", "singular-coarse"])
def test_set_guard_redoes_the_setup_eagerly(case):
    """A guard the eager code reads on the host becomes a device flag in
    the graphed set-up: a Newton-Schulz refresh from a non-finite carried
    inverse (the eager code rebuilds by Cholesky), and a singular coarse
    level of a disconnected ELL graph (the eager code regularises it). The
    set-up function raises the flag, graphed_solve runs the set-up again
    eagerly (one redo) and its result is bitwise the plain solve's."""
    kw = dict(SOLVE_KW)
    if case == "nonfinite-carry":
        idx, w_np, n = _pose_graph(700, 175)
        op = tb.build_banded_rcm(idx, n)[0]
        rt = graphs.banded_route(op, "mult")
        w = torch.as_tensor(w_np)
        X = torch.as_tensor(_blocks(n)[0])
        kw["xprev0"] = torch.as_tensor(_blocks(n, seed=7)[0])
        _, state = graphs.plain_solve(rt, w, X, **kw)
        carried = dict(state, Lc_inv=torch.full_like(state["Lc_inv"],
                                                     float("nan")))
        branch = "ns"
        w = 1.1 * w
    else:
        idx, w_np, n = _two_components()
        op = tl.build_operator(idx, n)
        assert op.mode == "ell" and op.coarse_s == 2
        rt = graphs.twogrid_route(op)
        w = torch.as_tensor(w_np)
        X = torch.as_tensor(_blocks(n)[0])
        kw["xprev0"] = torch.as_tensor(_blocks(n, seed=7)[0])
        carried, branch = None, "cold"
    static = dict(carried or {}, w=w, X0=X, xprev0=kw["xprev0"],
                  tol=torch.tensor(kw["tol"], dtype=w.dtype),
                  rel_tol=torch.tensor(1e-7, dtype=w.dtype))
    flagged = graphs.setup_outputs(rt, static, branch, False,
                                   graphs.Knobs(torch.float64, 3), {})
    assert bool(flagged["guard"])
    got, state = graphs.graphed_solve(rt, w, X, carried=carried,
                                      branch=branch, **kw)
    ref, ref_state = graphs.plain_solve(rt, w, X, carried=carried,
                                        branch=branch, **kw)
    assert rt.redos == 1
    _same(got, ref)
    _same(state, ref_state)
    assert bool(torch.isfinite(got.X).all())


def test_replay_bookkeeping_adds_the_captured_launches():
    """What a capture counted is taken back and added at each replay, by
    launches, lanes, dtype and (K4's) body, for every kernel wrapper."""
    saved = graphs._counts()
    try:
        k1, k4 = graphs.WRAPPERS[0], graphs.WRAPPERS[-1]
        assert k4.__name__ == "sym_eig"
        before = graphs._counts()
        for _ in range(3):
            k1.launches += 1
            k1.launches_by_lanes[1] = k1.launches_by_lanes.get(1, 0) + 1
            k1.launches_by_dtype["float32"] = (
                k1.launches_by_dtype.get("float32", 0) + 1)
        k4.launches += 1
        k4.launches_by_body["wide_shared"] = (
            k4.launches_by_body.get("wide_shared", 0) + 1)
        delta = graphs._delta(graphs._counts(), before)
        graphs._set_counts(before)
        assert delta[0] == (3, {1: 3}, {"float32": 3}, {})
        assert delta[-1] == (1, {}, {}, {"wide_shared": 1})
        assert all(d == (0, {}, {}, {}) for d in delta[1:-1])
        for _ in range(4):
            graphs._add(delta)
        after = graphs._counts()
        assert after[0][0] == before[0][0] + 12
        assert after[0][1].get(1, 0) == before[0][1].get(1, 0) + 12
        assert after[0][2]["float32"] == before[0][2].get("float32", 0) + 12
        assert after[-1][3]["wide_shared"] == (
            before[-1][3].get("wide_shared", 0) + 4)
        assert after[1:-1] == before[1:-1]
    finally:
        graphs._set_counts(saved)


def test_scatter_add_in_fixed_order_equals_index_add():
    """ops.laplacian.add_at, which sums duplicates in a fixed order on the
    card too, is bitwise index_add_ on the CPU in float64, for one row and
    for lanes."""
    rng = np.random.RandomState(0)
    idx = torch.as_tensor(rng.randint(0, 40, 5000))
    for lead in ((), (3,)):
        vals = torch.as_tensor(rng.normal(size=(*lead, 5000)))
        ref = torch.zeros((*lead, 40), dtype=torch.float64).index_add_(
            -1, idx, vals)
        got = tl.add_at(torch.zeros((*lead, 40), dtype=torch.float64), idx,
                        vals)
        assert torch.equal(got, ref)

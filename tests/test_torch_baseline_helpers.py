"""Parity of the small functions the PyTorch port's baselines and examples
need, against the JAX package, on the CPU: PCG to a tolerance, the pinned
Laplacian product, the tridiagonal solve, the chain, Jacobi and identity
preconditioners, the box LP and the stateless Frank-Wolfe, the graph and
NetworkX helpers, the pose-graph conversions and plot, and the bindings of
the native lazy-greedy ESP cores. Inputs come from numpy seeds."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mac_tpu import native as jnative  # noqa: E402
from mac_tpu.ops import cg as jcg  # noqa: E402
from mac_tpu.ops import laplacian as jl  # noqa: E402
from mac_tpu.ops import precond as jp  # noqa: E402
from mac_tpu.ops import tridiag as jt  # noqa: E402
from mac_tpu.optimization import constraints as jc  # noqa: E402
from mac_tpu.optimization import frankwolfe as jfw  # noqa: E402
from mac_tpu.slam import pose_graph as jpg  # noqa: E402
from mac_tpu.utils import conversions as jconv  # noqa: E402
from mac_tpu.utils import graphs as jg  # noqa: E402
from mac_tpu_torch import native as tnative  # noqa: E402
from mac_tpu_torch.ops import cg as tcg  # noqa: E402
from mac_tpu_torch.ops import laplacian as tl  # noqa: E402
from mac_tpu_torch.ops import precond as tp  # noqa: E402
from mac_tpu_torch.ops import tridiag as tt  # noqa: E402
from mac_tpu_torch.optimization import constraints as tc  # noqa: E402
from mac_tpu_torch.optimization import frankwolfe as tfw  # noqa: E402
from mac_tpu_torch.slam import pose_graph as tpg  # noqa: E402
from mac_tpu_torch.utils import conversions as tconv  # noqa: E402
from mac_tpu_torch.utils import graphs as tg  # noqa: E402

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def chain_graph(n, n_loops, seed):
    """Odometry chain (weights 0.5 + U[0, 1)) plus random loop closures:
    (idx (m, 2), w (m,)), the chain first."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - 3, n_loops)
    hi = np.minimum(n - 1, lo + 2 + rng.randint(0, n // 3, n_loops))
    idx = np.concatenate([chain, np.stack([lo, hi], 1)])
    return idx, 0.5 + rng.rand(len(idx))


@pytest.mark.parametrize("n,n_loops,precond", [
    (300, 8, "chain"), (300, 600, "none"), (120, 6, "chain")])
def test_pcg_matches_jax(n, n_loops, precond):
    """PCG on the pinned Laplacian of a chain with loop closures (ELL at
    n = 300, dense at n = 120), preconditioned by the pinned chain solve
    (a few closures: few steps) or not at all (an expander-like graph), in
    float64: X to rtol 1e-10 and the same step count; columns 0 and 5 are
    zero right-hand sides (frozen from the start) and every column's final
    residual norm meets its tolerance in both packages."""
    idx, w = chain_graph(n, n_loops, 1)
    rng = np.random.RandomState(2)
    B = rng.normal(size=(n, 6))
    B[0] = 0.0
    B[:, [0, 5]] = 0.0
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    chain_w = w[:n - 1]
    jM = jp.make_chain_precond_pinned(jnp.asarray(chain_w)) \
        if precond == "chain" else None
    tM = tp.make_chain_precond_pinned(torch.as_tensor(chain_w)) \
        if precond == "chain" else None
    ref = jcg.pcg(lambda V: jl.lap_apply_reduced(jop, jw, V),
                  jnp.asarray(B), jM, tol=1e-10, maxiter=500)
    got = tcg.pcg(lambda V: tl.lap_apply_reduced(top, tw, V),
                  torch.as_tensor(B), tM, tol=1e-10, maxiter=500)
    assert got.iters == int(ref.iters) and 0 < got.iters < 500
    np.testing.assert_allclose(got.X.numpy(), np.asarray(ref.X), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref.X)).max())
    # The final residuals are rounding-level: each is within tol * ||b||
    # per column, as the JAX package's are.
    bn = np.linalg.norm(B, axis=0)
    for rn in (got.resnorm.numpy(), np.asarray(ref.resnorm)):
        assert np.all(rn <= 1e-10 * np.maximum(bn, 1e-300)), rn
    assert not got.resnorm[[0, 5]].any()


@pytest.mark.parametrize("n", [300, 120])
def test_lap_apply_reduced_matches_jax(n):
    """The pinned product (ELL at n = 300, dense at n = 120, with and
    without a materialised dense matrix) to 1e-12; row 0 is zero."""
    idx, w = chain_graph(n, n // 3, 3)
    V = np.random.RandomState(4).normal(size=(n, 5))
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    ref = np.asarray(jl.lap_apply_reduced(jop, jnp.asarray(w),
                                          jnp.asarray(V)))
    tw = torch.as_tensor(w)
    got = tl.lap_apply_reduced(top, tw, torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    assert not got[0].any()
    if top.mode == "dense":
        got_d = tl.lap_apply_reduced(top, tw, torch.as_tensor(V),
                                     tl.lap_dense(top, tw)).numpy()
        np.testing.assert_allclose(got_d, ref, rtol=1e-12, atol=1e-12)


def test_tridiag_solve_matches_jax():
    """tridiag_solve(d, e, B) of an SPD tridiagonal system to 1e-12, and
    it solves the system."""
    rng = np.random.RandomState(5)
    n = 700
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e,
                                                                      [0]])
    B = rng.normal(size=(n, 3))
    ref = np.asarray(jax.jit(jt.tridiag_solve)(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(B)))
    got = tt.tridiag_solve(torch.as_tensor(d), torch.as_tensor(e),
                           torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(T @ got, B, atol=1e-10)


def test_preconditioners_match_jax():
    """make_chain_precond (centred pseudo-inverse of the path Laplacian),
    make_chain_precond_pinned (node 0 pinned: row 0 ignored and zero),
    make_jacobi_precond (with a zero degree floored) and identity_precond,
    each to 1e-12 on a random block; the pinned solve inverts the pinned
    path Laplacian."""
    rng = np.random.RandomState(6)
    n = 400
    chain_w = 0.5 + rng.rand(n - 1)
    deg = rng.rand(n)
    deg[3] = 0.0
    B = rng.normal(size=(n, 4))
    pairs = [(jp.make_chain_precond(jnp.asarray(chain_w)),
              tp.make_chain_precond(torch.as_tensor(chain_w))),
             (jp.make_chain_precond_pinned(jnp.asarray(chain_w)),
              tp.make_chain_precond_pinned(torch.as_tensor(chain_w))),
             (jp.make_jacobi_precond(jnp.asarray(deg)),
              tp.make_jacobi_precond(torch.as_tensor(deg))),
             (jp.identity_precond, tp.identity_precond)]
    for jf, tf in pairs:
        ref = np.asarray(jf(jnp.asarray(B)))
        got = tf(torch.as_tensor(B)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    Lc = np.diag(np.concatenate([chain_w, [0]]) + np.concatenate([[0],
                                                                   chain_w]))
    Lc -= np.diag(chain_w, 1) + np.diag(chain_w, -1)
    y = tp.make_chain_precond_pinned(torch.as_tensor(chain_w))(
        torch.as_tensor(B)).numpy()
    assert not y[0].any()
    np.testing.assert_allclose(Lc[1:, 1:] @ y[1:], B[1:], atol=1e-9)


def test_solve_box_lp_matches_jax():
    """The box LP's indicator of the positive entries, exactly (zeros and
    negative entries give 0)."""
    g = np.random.RandomState(7).normal(size=50)
    g[[3, 9]] = 0.0
    ref = np.asarray(jc.solve_box_lp(jnp.asarray(g)))
    got = tc.solve_box_lp(torch.as_tensor(g)).numpy()
    np.testing.assert_array_equal(got, ref)


def _fw_cases():
    """The JAX package's Frank-Wolfe tests' problems: (initial, objective
    shift, LP, maxiter)."""
    rng = np.random.RandomState(0)
    init = rng.rand(2)
    near_zero = np.zeros(10)
    near_zero[0] = 0.5
    return {
        "box": (0.5 * np.ones(10), 0.0, "box", 50),
        "subset": ((1 / init.sum()) * init, 0.0, "subset", 50),
        "around_zero": (near_zero, 0.25, "box", 50),
        "dual_bound": (0.9 * np.ones(5), 0.0, "box", 100),
    }


@pytest.mark.parametrize("case", list(_fw_cases()))
def test_frank_wolfe_matches_jax(case):
    """The stateless frank_wolfe on the JAX package's analytic problems
    (max -x^T x + shift over the box, or the k = 1 subset box): x and the
    dual bound u to 1e-10."""
    initial, shift, lp, maxiter = _fw_cases()[case]
    jlp = (jc.solve_box_lp if lp == "box"
           else (lambda g: jc.solve_subset_box_lp(g, 1)))
    tlp = (tc.solve_box_lp if lp == "box"
           else (lambda g: tc.solve_subset_box_lp(g, 1)))
    jx, ju = jfw.frank_wolfe(
        initial, lambda x: (-jnp.inner(x, x) + shift, -2 * x), jlp,
        maxiter=maxiter)
    tx, tu = tfw.frank_wolfe(
        initial, lambda x: (-torch.inner(x, x) + shift, -2 * x), tlp,
        maxiter=maxiter)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(float(tu), float(ju), rtol=1e-10, atol=1e-10)


def test_frank_wolfe_stepsize_matches_jax():
    """A user step size stepsize(x, g, s, k) reaches both loops with the
    same step index."""
    def jstep(x, g, s, k):
        return 1.0 / (k + 3.0)

    jx, ju = jfw.frank_wolfe(0.7 * np.ones(6),
                             lambda x: (-jnp.inner(x, x), -2 * x),
                             jc.solve_box_lp, stepsize=jstep, maxiter=20)
    tx, tu = tfw.frank_wolfe(0.7 * np.ones(6),
                             lambda x: (-torch.inner(x, x), -2 * x),
                             tc.solve_box_lp, stepsize=jstep, maxiter=20)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-10)
    np.testing.assert_allclose(float(tu), float(ju), rtol=1e-10)


def _edges(seed):
    rng = np.random.RandomState(seed)
    idx, w = chain_graph(30, 12, seed)
    return tg.arrays_to_edges(idx, w), idx, w, rng


def test_graph_helpers_match_jax():
    """arrays_to_edges, the (reduced) Laplacians of an edge list, the
    incidence vectors (node 0 pinned in the reduced one), select_edges and
    the binary mask, exactly; the refusals of mismatched lengths."""
    edges, idx, w, rng = _edges(8)
    assert edges == jg.arrays_to_edges(idx, w)
    for tf, jf in ((tg.weight_graph_lap_from_edge_list,
                    jg.weight_graph_lap_from_edge_list),
                   (tg.weight_reduced_graph_lap_from_edge_list,
                    jg.weight_reduced_graph_lap_from_edge_list)):
        np.testing.assert_array_equal(tf(edges, 30).toarray(),
                                      jf(edges, 30).toarray())
    for e in (edges[0], edges[-1], (0, 7), (7, 0)):
        np.testing.assert_array_equal(tg.get_incidence_vector(e, 30),
                                      jg.get_incidence_vector(e, 30))
        got, ref = np.full(29, 9.0), np.full(29, 9.0)
        tg.set_incidence_vector_for_edge_inplace(got, e, 30)
        jg.set_incidence_vector_for_edge_inplace(ref, e, 30)
        np.testing.assert_array_equal(got, ref)
    mask = (rng.rand(len(edges)) < 0.4).astype(float)
    sel = tg.select_edges(edges, mask)
    assert sel == jg.select_edges(edges, mask)
    np.testing.assert_array_equal(
        tg.get_edge_selection_as_binary_mask(edges, sel),
        jg.get_edge_selection_as_binary_mask(edges, sel))
    np.testing.assert_array_equal(
        tg.get_edge_selection_as_binary_mask(edges, sel), mask)
    with pytest.raises(ValueError):
        tg.select_edges(edges, mask[:-1])
    with pytest.raises(ValueError):
        tg.get_edge_selection_as_binary_mask(edges[:2], edges[:3])
    with pytest.raises(ValueError):
        tg.set_incidence_vector_for_edge_inplace(np.zeros(30), edges[0], 30)


def test_conversions_match_jax():
    """nx_to_mac (endpoints ordered, weight 1 by default) and mac_to_nx,
    exactly, on a weighted graph with reversed edges and one without a
    weight."""
    edges, _, _, _ = _edges(9)
    G = nx.Graph()
    for e in edges:
        G.add_edge(e.j, e.i, weight=e.weight)
    G.add_edge(40, 31)
    assert tconv.nx_to_mac(G) == jconv.nx_to_mac(G)
    rev = [tg.Edge(e.j, e.i, e.weight) for e in edges]
    for es in (edges, rev):
        a, b = tconv.mac_to_nx(es), jconv.mac_to_nx(es)
        assert sorted(a.edges(data=True)) == sorted(b.edges(data=True))


def test_pose_graph_helpers_match_jax():
    """rpm_to_arrays and rpm_to_nx of a bundled dataset exactly, and
    plot_poses (show=False) draws the same lines as the JAX package's, in
    2D and 3D."""
    path = "data/intel.g2o"
    tm, tn = tpg.read_g2o_file(path)
    jm, jn = jpg.read_g2o_file(path)
    ti, tw = tpg.rpm_to_arrays(tm)
    ji, jw = jpg.rpm_to_arrays(jm)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    assert ti.dtype == ji.dtype
    a, b = tpg.rpm_to_nx(tm), jpg.rpm_to_nx(jm)
    assert sorted(a.edges(data=True)) == sorted(b.edges(data=True))
    rng = np.random.RandomState(10)
    for d in (2, 3):
        n = 12
        Rs = [np.linalg.qr(rng.normal(size=(d, d)))[0] for _ in range(n)]
        xhat = np.concatenate([rng.normal(size=(d, n))] + Rs, axis=1)
        meas = [tpg.RelativePoseMeasurement(i, i + 1, None, None, 1.0, 1.0)
                for i in range(n - 1)]
        meas += [tpg.RelativePoseMeasurement(0, 7, None, None, 1.0, 1.0),
                 tpg.RelativePoseMeasurement(3, 11, None, None, 1.0, 1.0)]
        axes = [tpg.plot_poses(xhat, meas, show=False),
                jpg.plot_poses(xhat, meas, show=False)]
        lines = [[np.asarray(ln.get_data_3d() if d == 3 else ln.get_xydata())
                  for ln in ax.get_lines()] for ax in axes]
        assert len(lines[0]) == len(lines[1]) == 3
        for got, ref in zip(*lines):
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
        plt.close("all")


def test_native_esp_bindings_match_jax():
    """The port's bindings of esp_lazy_select_chain, esp_lazy_select_z
    (float64 and float32 Z) and esp_lazy_select return the same orders as
    the JAX package's bindings of the same library, for nested budgets;
    budgets that are not nested in 1..m, arrays of the wrong length and
    indices out of range are refused before the call."""
    rng = np.random.RandomState(11)
    n, m, ks = 60, 40, [3, 7, 12]
    rcum = np.concatenate([[0.0], np.cumsum(1.0 / (0.5 + rng.rand(n - 1)))])
    lo = rng.randint(0, n - 3, m)
    hi = np.minimum(lo + 2 + rng.randint(0, 20, m), n - 1)
    w = 0.5 + rng.rand(m)
    got = tnative.esp_lazy_select_chain(rcum, lo, hi, w, ks)
    assert got is not None and len(set(got.tolist())) == 12
    np.testing.assert_array_equal(
        got, jnative.esp_lazy_select_chain(rcum, lo, hi, w, ks))
    Z = rng.normal(size=(n, m)) * 0.1
    u, v = rng.randint(0, n, m), rng.randint(0, n, m)
    for Zc in (Z, Z.astype(np.float32)):
        np.testing.assert_array_equal(
            tnative.esp_lazy_select_z(Zc, u, v, w, ks),
            jnative.esp_lazy_select_z(Zc, u, v, w, ks))
    A = rng.normal(size=(m, m))
    G = A @ A.T / m
    np.testing.assert_array_equal(tnative.esp_lazy_select(G, w, ks),
                                  jnative.esp_lazy_select(G, w, ks))
    # What the C code trusts is checked before the call.
    for call in (lambda: tnative.esp_lazy_select(G, w, [5, 3]),
                 lambda: tnative.esp_lazy_select(G, w, [m + 1]),
                 lambda: tnative.esp_lazy_select(G, w[:-1], ks),
                 lambda: tnative.esp_lazy_select_z(Z, u, v + n, w, ks),
                 lambda: tnative.esp_lazy_select_chain(rcum[:10], lo, hi, w,
                                                       ks)):
        with pytest.raises(ValueError):
            call()

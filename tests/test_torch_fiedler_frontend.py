"""The port's host-matrix Fiedler front end (find_fiedler_pair, its
normalised branch and reference-name wrappers), TRACEMIN's warm entry, and
IncrementalFiedlerSolver, on the CPU (float64): against analytic spectra,
scipy, and the JAX package's functions on the same inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from mac_tpu.utils import fiedler as jf
from mac_tpu.utils.incremental import IncrementalFiedlerSolver as JIncremental
from mac_tpu_torch.ops.laplacian import build_operator
from mac_tpu_torch.utils import fiedler as tf
from mac_tpu_torch.utils.graphs import Edge, weight_graph_lap_from_edges
from mac_tpu_torch.utils.incremental import (CholeskyFiedlerSolver,
                                             IncrementalFiedlerSolver)

torch.set_num_threads(1)


def laplacian(idx, w, n):
    return weight_graph_lap_from_edges(np.asarray(idx), np.asarray(w, float),
                                       n)


def complete(n):
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return laplacian(idx, np.ones(len(idx)), n)


def petersen():
    idx = ([(i, (i + 1) % 5) for i in range(5)] + [(i, i + 5) for i in range(5)]
           + [(5 + i, 5 + (i + 2) % 5) for i in range(5)])
    return laplacian(idx, np.ones(15), 10)


def path(n):
    return laplacian([(i, i + 1) for i in range(n - 1)], np.ones(n - 1), n)


def random_graph(n, m_extra, seed):
    rng = np.random.RandomState(seed)
    chain = [(i, i + 1) for i in range(n - 1)]
    extra = {(min(a, b), max(a, b)) for a, b in rng.randint(0, n, (m_extra, 2))
             if abs(a - b) > 1}
    idx = chain + sorted(extra)
    return laplacian(idx, 0.5 + rng.rand(len(idx)), n)


def jax_xprev(n, q):
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, q), dtype=jnp.float64)))


def test_default_dtype_follows_the_device():
    assert tf.default_dtype("cpu") == torch.float64
    assert tf.default_dtype("cuda") == tf.default_dtype() == torch.float32
    assert tf.default_dtype(torch.device("cuda", 0)) == torch.float32


@pytest.mark.parametrize("name,L,lam2", [
    ("complete12", complete(12), 12.0),
    ("petersen", petersen(), 2.0),
    ("path40", path(40), 2.0 - 2.0 * np.cos(np.pi / 40)),
    ("path600", path(600), 2.0 - 2.0 * np.cos(np.pi / 600)),
])
@pytest.mark.parametrize("dense_input", [False, True])
def test_find_fiedler_pair_analytic(name, L, lam2, dense_input):
    """lambda_2 of the complete, Petersen and path graphs within 1e-8
    relative, from a sparse and from a dense matrix; the returned vector is
    a centred unit eigenvector (residual within 1e-6 ||L||_inf) and the
    first column of the block."""
    Lin = L.toarray() if dense_input else L
    lam, v, X = tf.find_fiedler_pair(Lin, device="cpu")
    assert lam.dtype == torch.float64 and X.shape == (L.shape[0], 4)
    assert abs(float(lam) - lam2) <= 1e-8 * lam2
    assert torch.equal(v, X[:, 0])
    v = v.numpy()
    assert abs(np.linalg.norm(v) - 1.0) < 1e-8 and abs(v.sum()) < 1e-8
    assert np.linalg.norm(L @ v - float(lam) * v) <= 1e-6 * abs(L).sum(1).max()


@pytest.mark.parametrize("method", ["tracemin", "tracemin_lu", "lobpcg",
                                    "dense"])
def test_find_fiedler_pair_random_graph_equals_scipy_and_jax(method):
    """A random weighted graph (n = 500, the ELL operator): lambda_2 within
    1e-7 relative of numpy's dense eigh and, for "tracemin" and "dense", of
    the JAX package's find_fiedler_pair with the same start block (its
    front end runs eagerly and takes 15 s for the first iterative method,
    so "lobpcg" is held to numpy alone here and to the JAX package's engine
    in tests/test_torch_twogrid.py); a warm start from the returned block
    and a block of another width both work."""
    L = random_graph(500, 300, 0)
    ref = np.linalg.eigvalsh(L.toarray())[1]
    lam, v, X = tf.find_fiedler_pair(L, method=method, device="cpu",
                                     xprev0=jax_xprev(500, 4))
    assert abs(float(lam) - ref) <= 1e-7 * ref
    if method in ("tracemin", "dense"):
        lam_j, _, _ = jf.find_fiedler_pair(L, method=method)
        assert abs(float(lam) - float(lam_j)) <= 1e-7 * ref
    lam_w, _, _ = tf.find_fiedler_pair(L, X=X, method=method, device="cpu")
    assert abs(float(lam_w) - ref) <= 1e-7 * ref
    lam_2, _, X2 = tf.find_fiedler_pair(L, X=X[:, :2].numpy(), method=method,
                                        device="cpu")
    assert X2.shape == (500, 2) and abs(float(lam_2) - ref) <= 1e-7 * ref


def test_find_fiedler_pair_seed_and_bad_inputs():
    """An int seed and a numpy RandomState seed the start block like the
    JAX package; a block of the wrong height or width and an unknown method
    raise ValueError."""
    L = random_graph(300, 100, 1)
    ref = np.linalg.eigvalsh(L.toarray())[1]
    for seed in (3, np.random.RandomState(3)):
        lam, _, _ = tf.find_fiedler_pair(L, seed=seed, device="cpu")
        assert abs(float(lam) - ref) <= 1e-7 * ref
    np.testing.assert_array_equal(tf.default_block(300, 4, seed=3),
                                  jf.default_block(300, 4, seed=3))
    with pytest.raises(ValueError, match="shape"):
        tf.find_fiedler_pair(L, X=np.ones((299, 2)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tf.find_fiedler_pair(L, X=np.ones((300, 300)), device="cpu")
    with pytest.raises(ValueError, match="method"):
        tf.find_fiedler_pair(L, method="arnoldi", device="cpu")


def test_disconnected_graph_has_lambda2_zero():
    """Two components: lambda_2 = 0 (|lambda_2| < 1e-8), dense and ELL."""
    small = sp.block_diag([path(20), path(30)]).tocsr()
    lam, _, _ = tf.find_fiedler_pair(small, device="cpu")
    assert abs(float(lam)) < 1e-8
    big = sp.block_diag([path(300), random_graph(300, 80, 2)]).tocsr()
    lam, _, _ = tf.find_fiedler_pair(big, device="cpu")
    assert abs(float(lam)) < 1e-8


@pytest.mark.parametrize("n,m_extra", [(60, 40), (700, 500)])
def test_normalized_fiedler_equals_scipy_and_jax(n, m_extra):
    """The normalised branch (dense eigh up to 256 nodes, the conjugated
    TRACEMIN beyond): the second eigenvalue of D^(-1/2) L D^(-1/2) within
    1e-7 relative of numpy's (and, on the small graph, of the JAX
    package's); the vector is a unit eigenvector of N; the reference-name
    wrappers return numpy."""
    L = random_graph(n, m_extra, 4)
    d = L.diagonal()
    N = (L.toarray() / np.sqrt(d)[:, None]) / np.sqrt(d)[None, :]
    ref = np.linalg.eigvalsh(N)[1]
    lam, v, X = tf.find_fiedler_pair(L, normalized=True, device="cpu",
                                     xprev0=jax_xprev(n, 4))
    assert abs(float(lam) - ref) <= 1e-7 * ref
    if n <= 256:
        lam_j, _, _ = jf.find_fiedler_pair(L, normalized=True)
        assert abs(float(lam) - float(lam_j)) <= 1e-7 * ref
    v = v.numpy()
    assert np.linalg.norm(N @ v - float(lam) * v) <= 1e-5
    sigma, Xt = tf.tracemin_fiedler_cholesky(L, normalized=True, device="cpu")
    assert isinstance(sigma, np.ndarray) and Xt.shape == (4, n)
    assert abs(sigma[0] - ref) <= 1e-7 * ref
    lam_c, v_c = tf.find_fiedler_pair_cholesky(L, device="cpu")
    ref_plain = np.linalg.eigvalsh(L.toarray())[1]
    assert abs(lam_c - ref_plain) <= 1e-7 * ref_plain and v_c.shape == (n,)


def test_normalized_fiedler_isolated_node_raises():
    L = sp.block_diag([path(5), sp.csr_matrix((1, 1))]).tocsr()
    with pytest.raises(ValueError, match="strictly positive degrees"):
        tf.find_fiedler_pair(L, normalized=True, device="cpu")
    with pytest.raises(ValueError, match="strictly positive degrees"):
        jf.find_fiedler_pair(L, normalized=True)


def test_op_from_matrix_sparse_and_dense():
    """Edges, weights and chain weights of a host matrix, sparse and dense,
    equal the JAX package's extraction."""
    L = random_graph(50, 30, 5)
    for Lin in (L, L.toarray()):
        op, w, cw = tf._op_from_matrix(Lin)
        jop, jw, jcw = jf._op_from_matrix(Lin)
        np.testing.assert_array_equal(op.idx.numpy(), np.asarray(jop.idx))
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(cw, jcw)
        assert (op.n, op.mode) == (jop.n, jop.mode)
    assert tf._op_from_matrix(complete(6))[2] is not None
    star = laplacian([(0, i) for i in range(1, 6)], np.ones(5), 6)
    assert tf._op_from_matrix(star)[2] is None


def test_tracemin_warm_entry_equals_jax():
    """fiedler_pair_op with lam0 / warm_init on a perturbed operator, from
    the block a first solve returned: the warm entry gives the JAX
    package's Ritz values to 1e-9 and its outer iteration count from the
    same block; warm_init=False is the cold entry; with lam0 given at least one
    outer iteration runs even though the carried block already meets the
    tolerance."""
    from mac_tpu.ops.laplacian import build_operator as jbuild

    rng = np.random.RandomState(6)
    n = 400
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - 60, 150)
    idx = np.concatenate([chain, np.stack([lo, lo + 2 + rng.randint(0, 50,
                                                                   150)], 1)])
    w0 = 0.5 + rng.rand(len(idx))
    w1 = w0 * (1.0 + 1e-3 * rng.rand(len(idx)))
    top, jop = build_operator(idx, n), jbuild(idx, n)
    X0 = tf.default_block(n)
    xprev = jax_xprev(n, 4)
    kw = dict(tol=1e-8, maxiter=100, precond="tridiag")
    t0 = tf.fiedler_pair_op(top, torch.as_tensor(w0), torch.as_tensor(X0),
                            xprev0=xprev, **kw)
    t1 = tf.fiedler_pair_op(top, torch.as_tensor(w1), t0.X, xprev0=xprev,
                            lam0=t0.lam, warm_init=True, **kw)
    j1 = jax.jit(lambda w, X, lam: jf.fiedler_pair_op(
        jop, w, X, lam0=lam, warm_init=jnp.asarray(True), **kw))(
            jnp.asarray(w1), jnp.asarray(t0.X.numpy()),
            jnp.asarray(t0.lam.numpy()))
    np.testing.assert_allclose(t1.lam.numpy(), np.asarray(j1.lam), rtol=1e-9)
    assert t1.iters == int(j1.iters) >= 1
    cold = tf.fiedler_pair_op(top, torch.as_tensor(w1), t0.X, xprev0=xprev,
                              lam0=t0.lam, warm_init=False, **kw)
    plain = tf.fiedler_pair_op(top, torch.as_tensor(w1), t0.X, xprev0=xprev,
                               **kw)
    assert cold.iters == max(plain.iters, 1)
    np.testing.assert_allclose(cold.lam.numpy(), plain.lam.numpy(),
                               rtol=1e-9)
    # The same operator again: the carried block is converged, and min_iters
    # still forces one outer iteration.
    t2 = tf.fiedler_pair_op(top, torch.as_tensor(w0), t0.X, xprev0=xprev,
                            lam0=t0.lam, warm_init=True, **kw)
    assert t2.iters == 1
    t3 = tf.fiedler_pair_op(top, torch.as_tensor(w0), t0.X, xprev0=xprev,
                            **kw)
    assert t3.iters == 0


def incremental_problem():
    rng = np.random.RandomState(8)
    n = 300
    base = [Edge(i, i + 1, 0.5 + rng.rand()) for i in range(n - 1)]
    cands = [Edge(int(a), int(a) + 5 + int(b), 1.0 + 0.25 * int(c))
             for a, b, c in zip(rng.randint(0, 250, 12), rng.randint(0, 40, 12),
                                rng.randint(0, 4, 12))]
    return base, cands, n


def test_incremental_solver_add_remove_equals_jax_and_scipy():
    """add_edge / remove_edge / a doubled edge: after every mutation
    lambda_2 equals numpy's dense eigh of the current graph and the JAX
    package's solver to 1e-7 relative; removing restores the first value;
    the alias is the same class."""
    base, cands, n = incremental_problem()
    ts = IncrementalFiedlerSolver(base, n, candidate_edges=cands,
                                  device="cpu")
    js = JIncremental(base, n, candidate_edges=cands)
    assert ts.dtype == torch.float64 and CholeskyFiedlerSolver is (
        IncrementalFiedlerSolver)
    ts.xprev0 = jax_xprev(n, 4)
    active = []

    def check():
        edges = base + active
        L = laplacian([(e.i, e.j) for e in edges],
                      [e.weight for e in edges], n)
        ref = np.linalg.eigvalsh(L.toarray())[1]
        lam_t, v_t = ts.find_fiedler_pair()
        lam_j, _ = js.find_fiedler_pair()
        assert abs(lam_t - ref) <= 1e-7 * ref, (lam_t, ref)
        assert abs(lam_t - lam_j) <= 1e-7 * ref
        assert v_t.shape == (n,) and abs(np.linalg.norm(v_t) - 1) < 1e-8
        return lam_t

    lam0 = check()
    for e in (cands[3], cands[7], cands[3]):  # cands[3] twice: weight doubles
        ts.add_edge(e)
        js.add_edge(e)
        active.append(e)
        check()
    for e in (cands[3], cands[7], cands[3]):
        ts.remove_edge(e)
        js.remove_edge(e)
        active.remove(e)
        check()
    assert abs(check() - lam0) <= 1e-9 * lam0


def test_incremental_solver_refuses_undeclared_and_inactive_edges():
    base, cands, n = incremental_problem()
    ts = IncrementalFiedlerSolver(base, n, candidate_edges=cands,
                                  device="cpu", dtype=torch.float32)
    assert ts.dtype == torch.float32
    with pytest.raises(KeyError, match="not declared"):
        ts.add_edge(Edge(0, 299, 1.0))
    with pytest.raises(KeyError, match="not declared"):
        ts.add_edge(Edge(cands[0].i, cands[0].j, cands[0].weight + 0.5))
    with pytest.raises(ValueError, match="not active"):
        ts.remove_edge(cands[0])
    ts.add_edge((cands[0].j, cands[0].i, cands[0].weight))  # either order
    ts.remove_edge(cands[0])
    lam, _ = ts.find_fiedler_pair(X=tf.default_block(n))
    assert lam > 0

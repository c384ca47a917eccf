"""The port's host (numpy + scipy) pieces against the JAX package's on the
same inputs, to 1e-12: the host TRACEMIN engine, splu_reduced's pruning,
block_pcg, the fixed-pattern Laplacian updater, the Woodbury solves, the
connectivity check and the band-narrow splu probe."""

import numpy as np
import pytest
import torch

from mac_tpu.ops import host_tracemin as jh
from mac_tpu.solvers import mac as jmac
from mac_tpu_torch.ops import host_tracemin as th
from mac_tpu_torch.solvers import MAC, _host
from mac_tpu_torch.utils.graphs import weight_graph_lap_from_edges

torch.set_num_threads(1)


def chain_graph(n, n_cand, seed, span=40):
    """An odometry chain and short loop closures as candidates, the first
    two of them the same node pair (they share their CSR slots)."""
    rng = np.random.RandomState(seed)
    fixed = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - span - 2, n_cand)
    cand = np.stack([lo, lo + 2 + rng.randint(0, span, n_cand)], 1)
    cand[1] = cand[0]
    return (fixed, 0.5 + rng.rand(n - 1)), (cand, 0.5 + rng.rand(n_cand)), n


def lap(fixed, cands, n, x):
    idx = np.concatenate([fixed[0], cands[0]])
    return weight_graph_lap_from_edges(
        idx, np.concatenate([fixed[1], x * cands[1]]), n)


@pytest.mark.parametrize("n,q,maxiter", [(300, 4, 60), (1500, 3, 60),
                                         (300, 4, 2)])
def test_host_tracemin_equals_jax(n, q, maxiter):
    """The same Laplacian and start block: eigenvalues, Ritz block and
    iteration count equal the JAX package's to 1e-12 (also when the budget
    runs out mid-cycle), and lambda_2 equals scipy's dense eigh to 1e-9
    relative once converged."""
    fixed, cands, n = chain_graph(n, n // 5, n)
    rng = np.random.RandomState(1)
    L = lap(fixed, cands, n, rng.rand(len(cands[1])))
    X0 = rng.normal(size=(n, q))
    lam_t, X_t, it_t = th.host_tracemin_fiedler(L, X0, maxiter=maxiter)
    lam_j, X_j, it_j = jh.host_tracemin_fiedler(L, X0, maxiter=maxiter)
    assert it_t == it_j
    np.testing.assert_allclose(lam_t, lam_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(X_t, X_j, rtol=0, atol=1e-12)
    if maxiter > 2:
        ref = np.linalg.eigvalsh(L.toarray())[1]
        assert abs(lam_t[0] - ref) <= 1e-9 * ref
        assert it_t < maxiter


def test_host_tracemin_takes_a_factor_or_a_solve_function():
    """lu= and solve_fn= give the default's result (the factor is the
    default's own; the solve function is that factor's solve)."""
    fixed, cands, n = chain_graph(400, 60, 3)
    L = lap(fixed, cands, n, np.full(60, 0.5))
    X0 = np.random.RandomState(0).normal(size=(n, 4))
    ref = th.host_tracemin_fiedler(L, X0)
    lu = th.splu_reduced(L)
    for kw in (dict(lu=lu), dict(solve_fn=lu.solve)):
        lam, X, it = th.host_tracemin_fiedler(L, X0, **kw)
        assert it == ref[2]
        np.testing.assert_array_equal(lam, ref[0])
        np.testing.assert_array_equal(X, ref[1])


def test_splu_reduced_prunes_explicit_zeros():
    """A fixed-pattern Laplacian with unselected candidates stored as
    zeros factors like the pruned matrix: the factor holds no more entries
    than the JAX package's, fewer than the unpruned pattern's, solves the
    grounded system to 1e-12, and leaves the caller's matrix untouched."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    fixed, cands, n = chain_graph(600, 200, 4, span=300)
    x = np.zeros(200)
    x[:5] = 1.0
    mac = MAC(fixed, cands, n, device="cpu")
    L = mac._host_lap(x)
    stored = L.nnz
    assert stored > np.count_nonzero(L.data)  # explicit zeros present
    lu_t, lu_j = th.splu_reduced(L), jh.splu_reduced(L)
    assert L.nnz == stored
    full = spla.splu(sp.csc_matrix(L.tocsr()[1:, 1:]))
    nnz = lambda lu: lu.L.nnz + lu.U.nnz  # noqa: E731
    assert nnz(lu_t) == nnz(lu_j) < nnz(full)
    b = np.random.RandomState(0).normal(size=(n - 1, 3))
    y = lu_t.solve(b)
    np.testing.assert_allclose(L.tocsr()[1:, 1:] @ y, b, atol=1e-10)
    np.testing.assert_allclose(y, lu_j.solve(b), rtol=0, atol=1e-12)


def test_block_pcg_equals_jax():
    """block_pcg with a stale factor as the preconditioner: the JAX
    package's iterates to 1e-12, the same count and flag, and the solution
    of the current system to 1e-8 relative; an exhausted budget reports
    not converged."""
    import scipy.sparse as sp

    fixed, cands, n = chain_graph(500, 80, 5)
    rng = np.random.RandomState(2)
    x_old, x_new = rng.rand(80), rng.rand(80)
    stale = th.splu_reduced(lap(fixed, cands, n, x_old))
    A = sp.csr_matrix(lap(fixed, cands, n, x_new).tocsr()[1:, 1:])
    B = rng.normal(size=(n - 1, 4))
    Y_t, it_t, ok_t = th.block_pcg(A, B, stale.solve)
    Y_j, it_j, ok_j = jh.block_pcg(A, B, stale.solve)
    assert (it_t, ok_t) == (it_j, ok_j) and ok_t
    np.testing.assert_allclose(Y_t, Y_j, rtol=0, atol=1e-12)
    assert np.linalg.norm(A @ Y_t - B) <= 1e-8 * np.linalg.norm(B)
    assert th.block_pcg(A, B, lambda R: R, maxiter=2)[1:] == (2, False)


def test_incremental_host_lap_equals_laplacian():
    """_IncrementalHostLap.build against MAC.laplacian and against the JAX
    package's class, for several multiplier vectors, duplicate candidate
    edges included; the pattern arrays are shared between builds."""
    fixed, cands, n = chain_graph(200, 40, 6)
    idx = np.concatenate([fixed[0], cands[0]])
    inc_t = _host._IncrementalHostLap(idx, fixed[1], cands[1], cands[0], n)
    inc_j = jmac._IncrementalHostLap(idx, fixed[1], cands[1], cands[0], n)
    mac = MAC(fixed, cands, n, device="cpu")
    assert mac.fiedler_backend == "host"
    rng = np.random.RandomState(0)
    prev = None
    for _ in range(3):
        xm = rng.rand(40) * (rng.rand(40) > 0.3)
        L_t = inc_t.build(xm)
        assert abs(L_t - inc_j.build(xm)).max() == 0
        assert abs(L_t - mac.laplacian(xm)).max() < 1e-12
        assert abs(mac._host_lap(xm) - L_t).max() == 0
        assert prev is None or np.shares_memory(prev.indices, L_t.indices)
        prev = L_t


def test_woodbury_view_equals_refactorisation():
    """A trial view's solve equals the solve of the refactored matrix to
    1e-10, before and after a commit (stacked corrections), like the JAX
    package's; dropping a bridge (a disconnected trial) raises LinAlgError
    or gives no finite solve."""
    fixed, cands, n = chain_graph(120, 12, 7)
    wc, ci = cands[1], cands[0]
    r = np.zeros(12)
    r[:4] = 1.0
    base = lap(fixed, cands, n, r)
    lu = th.splu_reduced(base)

    def col(e):
        c = np.zeros(n - 1)
        for node, sign in ((ci[e, 0], 1.0), (ci[e, 1], -1.0)):
            if node > 0:
                c[node - 1] = sign
        return c

    b = np.random.RandomState(0).normal(size=(n - 1, 3))
    wb_t, wb_j = _host._WoodburyState(lu, n - 1), jmac._WoodburyState(lu, n - 1)
    for add, drop in ((6, 0), (9, 2)):
        cols = np.stack([col(add), col(drop)], 1)
        cvals = np.array([wc[add], -wc[drop]])
        r[add], r[drop] = 1.0, 0.0
        view_t, pend_t = wb_t.trial_view(cols, cvals)
        view_j, pend_j = wb_j.trial_view(cols, cvals)
        y = view_t.solve(b)
        ref = th.splu_reduced(lap(fixed, cands, n, r)).solve(b)
        np.testing.assert_allclose(y, ref, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(y, view_j.solve(b), rtol=0, atol=1e-12)
        wb_t.commit(pend_t)
        wb_j.commit(pend_j)
    assert wb_t.U.shape == (n - 1, 4)
    # Dropping an edge of the bare chain disconnects it: a singular
    # capacitance.
    e = np.zeros(n - 1)
    e[49], e[50] = 1.0, -1.0  # the chain edge (50, 51)
    bare = _host._WoodburyState(
        th.splu_reduced(lap(fixed, cands, n, np.zeros(12))), n - 1)
    try:
        view, _ = bare.trial_view(e[:, None], np.array([-fixed[1][50]]))
        y = view.solve(b)
        assert (not np.all(np.isfinite(y))) or np.abs(y).max() > 1e8
    except np.linalg.LinAlgError:
        pass


def test_graph_is_connected_and_band_probe():
    """_graph_is_connected on a chain, on two chains and on two chains
    joined by a candidate; host_band_probe_ratio on a band-narrow tiny-gap
    graph (the JAX package's ratio to 1e-12 relative, below the float32
    threshold) and None on an expander-like graph and on a disconnected
    one."""
    n = 3000
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    assert _host._graph_is_connected(chain, n)
    cut = np.delete(chain, n // 2, axis=0)
    assert not _host._graph_is_connected(cut, n)
    assert _host._graph_is_connected(
        np.concatenate([cut, [[3, n - 3]]]), n)

    rng = np.random.RandomState(0)
    w_fixed = 0.5 + rng.rand(n - 1)
    lo = rng.randint(0, n - 300, n // 2)
    ci_local = np.stack([lo, lo + 2 + rng.randint(0, 290, n // 2)], 1)
    w_local = 0.5 + rng.rand(len(ci_local))
    r_t = _host.host_band_probe_ratio(chain, w_fixed, ci_local, w_local, n)
    r_j = jmac.host_band_probe_ratio(chain, w_fixed, ci_local, w_local, n)
    assert r_t is not None and abs(r_t - r_j) <= 1e-12 * r_j
    L = weight_graph_lap_from_edges(
        np.concatenate([chain, ci_local]),
        np.concatenate([w_fixed, 0.5 * w_local]), n).toarray()
    ref = np.linalg.eigvalsh(L)[1] / np.abs(L).sum(1).max()
    assert abs(r_t - ref) <= 1e-3 * ref

    n2 = 8000  # spans up to n2 / 4: no band of MAX_BANDWIDTH
    chain2 = np.stack([np.arange(n2 - 1), np.arange(1, n2)], 1)
    lo = rng.randint(0, n2 - 3, n2 // 2)
    span = rng.randint(2, n2 // 4, n2 // 2)
    keep = lo + span <= n2 - 1
    ci_exp = np.stack([lo[keep], (lo + span)[keep]], 1)
    assert _host.host_band_probe_ratio(
        chain2, np.ones(n2 - 1), ci_exp, np.ones(len(ci_exp)), n2) is None
    assert _host.host_band_probe_ratio(cut, w_fixed[1:], ci_local[:0],
                                       w_local[:0], n) is None

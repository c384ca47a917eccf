"""The budget sweep (MAC.solve_sweep) of the PyTorch port against the JAX
package's on the CPU: the JAX package's four cases on the Petersen problem
(tests/solvers/test_sweep.py) in float64, a banded float32 sweep with the
exact chain factor (n = 600) and a matrix-free (ELL) float32 sweep, each
lane's relaxed lambda_2 scored by the scipy float64 referee. The blocked
chain factor's sweep (n = 4500) is tests/test_torch_sweep_blocked.py."""

import networkx as nx
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu.utils.conversions import nx_to_mac as jax_nx_to_mac
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.conversions import nx_to_mac
from mac_tpu_torch.utils.fiedler import scipy_lam2
from tests.test_torch_banded import pose_graph

torch.set_num_threads(1)

RTOL = 1e-8


def petersen():
    """The JAX package's sweep problem: the Petersen graph's minimum
    spanning tree fixed, its other six edges the candidates."""
    graph = nx.petersen_graph()
    tree = nx.minimum_spanning_tree(graph)
    loops = nx.difference(graph, tree)
    return tree, loops, graph.number_of_nodes()


def jax_madow_u(seed, count):
    """The offsets the JAX package's sweep draws for its Madow lanes."""
    keys = jax.random.split(jax.random.PRNGKey(seed), count)
    return torch.tensor(np.asarray(
        [jax.random.uniform(kk, (), dtype=jnp.float64) for kk in keys]))


def first_iterate(mac, k):
    """The sweep's first Frank-Wolfe vertex of budget k: the top-k
    indicator of the supergradient at the uniform start k / m."""
    m = len(mac.weights)
    _, grad = mac.problem(np.full(m, k / m))
    return grad, solve_subset_box_lp(torch.as_tensor(grad), k).numpy()


def check_individual(tree, loops, n):
    """Every lane equals the port's own individual solve on the device
    engine (the sweep's engine: dense eigh on this graph) at rtol 1e-8, in
    lambda_2 and in the dual bound; against the JAX package's sweep, lanes 2
    and 3 agree at rtol 1e-8 and every lane's lambda_2 lies below the other
    package's bound. Lanes 1 and 4 meet an exact tie of the symmetric graph
    at their first vertex -- lane 1 a double lambda_2 (the supergradient is
    whichever eigenvector LAPACK returns, and torch's MKL and the JAX
    package's LAPACK return different ones), lane 4 tied supergradient
    entries at its k-th rank, which rounding breaks either way -- and take
    another, equally valid, Frank-Wolfe path from there."""
    fixed, cands = nx_to_mac(tree), nx_to_mac(loops)
    m = len(cands)
    ks = [1, 2, 3, 4]
    mac = MAC(fixed, cands, n, device="cpu")
    assert mac.dtype == torch.float64 and mac.fiedler_backend == "host"
    rounded, unrounded, upper = mac.solve_sweep(ks, max_iters=50)
    assert rounded.shape == unrounded.shape == (4, m) and upper.shape == (4,)
    dev = MAC(fixed, cands, n, device="cpu", dtype=torch.float64,
              fiedler_backend="device")
    jm = JMAC(jax_nx_to_mac(tree), jax_nx_to_mac(loops), n)
    jr, ju, jup = jm.solve_sweep(ks, max_iters=50)
    for i, k in enumerate(ks):
        assert rounded[i].sum() == k and jr[i].sum() == k
        _, u_i, b_i = dev.solve(k, np.full(m, k / m), max_iters=50)
        lam = mac.evaluate_objective(unrounded[i])
        assert np.isclose(lam, dev.evaluate_objective(u_i), rtol=RTOL)
        assert np.isclose(upper[i], b_i, rtol=RTOL)
        lam_j = mac.evaluate_objective(ju[i])
        assert lam <= jup[i] * (1 + RTOL) and lam_j <= upper[i] * (1 + RTOL)
        if k in (2, 3):
            assert np.isclose(lam, lam_j, rtol=RTOL), (k, lam, lam_j)
            assert np.isclose(upper[i], jup[i], rtol=RTOL)
    _, x1 = first_iterate(mac, 1)
    ev = np.linalg.eigvalsh(mac.laplacian(x1).toarray())
    assert abs(ev[2] - ev[1]) < 1e-12
    _, x1 = first_iterate(mac, 4)
    _, grad = mac.problem(x1)
    top = np.sort(grad)[::-1]
    assert abs(top[3] - top[4]) < 1e-12 * top[3]


def check_k_past_m(tree, loops, n):
    """A lane with k > m takes every candidate, rounded and relaxed; the
    other lane rounds to exactly k, as in the JAX package."""
    fixed, cands = nx_to_mac(tree), nx_to_mac(loops)
    m = len(cands)
    mac = MAC(fixed, cands, n, device="cpu")
    rounded, unrounded, _ = mac.solve_sweep([2, m + 5], max_iters=20)
    np.testing.assert_array_equal(rounded[1], np.ones(m))
    np.testing.assert_array_equal(unrounded[1], np.ones(m))
    assert rounded[0].sum() == 2
    jr, _, _ = JMAC(jax_nx_to_mac(tree), jax_nx_to_mac(loops),
                    n).solve_sweep([2, m + 5], max_iters=20)
    np.testing.assert_array_equal(rounded[1], jr[1])


def check_madow(tree, loops, n):
    """Madow lanes with the JAX package's offsets injected: each rounds to
    exactly k, and the rounded rows equal the JAX package's."""
    fixed, cands = nx_to_mac(tree), nx_to_mac(loops)
    mac = MAC(fixed, cands, n, device="cpu")
    mac._madow_u = lambda seed, count: jax_madow_u(seed, count)
    rounded, _, _ = mac.solve_sweep([2, 3], rounding="madow", max_iters=30)
    assert rounded[0].sum() == 2 and rounded[1].sum() == 3
    jr, _, _ = JMAC(jax_nx_to_mac(tree), jax_nx_to_mac(loops),
                    n).solve_sweep([2, 3], rounding="madow", max_iters=30)
    np.testing.assert_array_equal(rounded, jr)


def check_warm_inner(tree, loops, n):
    """The warm inner-CG schedule threads into the sweep: the Petersen
    budgets reach the same objectives as without it (to 1e-6, the JAX
    package's tolerance), and the JAX package's schedule run's (to
    1e-8)."""
    fixed, cands = nx_to_mac(tree), nx_to_mac(loops)
    sched = ((1, 8), (5, 6))
    mac = MAC(fixed, cands, n, device="cpu", fiedler_warm_inner_iters=sched)
    assert mac._warm_inner_schedule == sched
    ks = [2, 3]
    _, unrounded, _ = mac.solve_sweep(ks, max_iters=30)
    mac0 = MAC(fixed, cands, n, device="cpu")
    _, unrounded0, _ = mac0.solve_sweep(ks, max_iters=30)
    jm = JMAC(jax_nx_to_mac(tree), jax_nx_to_mac(loops), n,
              fiedler_warm_inner_iters=sched)
    _, ju, _ = jm.solve_sweep(ks, max_iters=30)
    for i in range(len(ks)):
        lam = mac.evaluate_objective(unrounded[i])
        assert np.isclose(lam, mac0.evaluate_objective(unrounded0[i]),
                          rtol=1e-6)
        assert np.isclose(lam, mac.evaluate_objective(ju[i]), rtol=RTOL)


@pytest.mark.parametrize("case", [check_individual, check_k_past_m,
                                  check_madow, check_warm_inner],
                         ids=["individual", "k_past_m", "madow",
                              "warm_inner"])
def test_petersen_sweep_matches_jax(case):
    case(*petersen())


def check_sweep_parity(n, n_loops, span, seed, banded, R, expect_blocked,
                       **knobs):
    """Both packages sweep R budgets (25%, 50%, 75% of the candidates) from
    the uniform start in float32 (the port given the JAX package's random
    previous-iterate block), with the same extra MAC knobs; each lane's
    relaxed lambda_2, scored by the scipy float64 referee, agrees with the
    JAX package's within 1e-3 relative; each lane rounds to exactly k; each
    dual bound is finite."""
    idx, w, n = pose_graph(n, n_loops, span, seed)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    m = len(cands[1])
    ks = [m // 4, m // 2, (3 * m) // 4][:R]
    kw = (dict(use_banded=True, fw_polish=False) if banded
          else dict(use_banded=False))
    kw.update(knobs)
    jm = JMAC(fixed, cands, n, dtype=jnp.float32, **kw)
    jr, ju, jup = jm.solve_sweep(ks)
    tm = MAC(fixed, cands, n, dtype=torch.float32, device="cpu", **kw)
    assert (tm._banded is not None) == banded
    if expect_blocked is not None:
        assert (n > 4096) == expect_blocked
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    tr, tu, tup = tm.solve_sweep(ks)
    assert tr.shape == tu.shape == (R, m) and tup.shape == (R,)
    for i, k in enumerate(ks):
        lam_j = scipy_lam2(jm.laplacian(ju[i]))
        lam_t = scipy_lam2(tm.laplacian(tu[i]))
        assert abs(lam_t - lam_j) <= 1e-3 * abs(lam_j), (k, lam_t, lam_j)
        assert tr[i].sum() == k and jr[i].sum() == k
        assert set(np.unique(tr[i])) <= {0.0, 1.0}
        assert np.isfinite(tup[i])


@pytest.mark.parametrize("banded,R", [(True, 3), (False, 2)],
                         ids=["banded_exact_factor", "ell"])
def test_float32_sweep_matches_jax(banded, R):
    """n = 600: the banded operator with the fast32 policy (exact chain
    factor, 32 steps, R = 3), and the matrix-free operator (use_banded
    False: 5 steps, the two-grid V-cycle, R = 2)."""
    check_sweep_parity(600, 200, 40, 5, banded, R,
                       expect_blocked=False if banded else None)


def test_float32_sweep_with_a_wide_block_matches_jax(monkeypatch):
    """The banded sweep of two budgets with fiedler_block_q=12: each outer
    iteration's Rayleigh-Ritz eigensolves of both lanes are one (2, 36,
    36) batch through sym_eig (K4w on the card, the plain Jacobi here),
    never torch.linalg.eigh; the lanes as in test_float32_sweep_matches_jax
    against the JAX sweep at the same q."""
    import mac_tpu_torch.ops.kernels.syev as syev_mod

    shapes, real = set(), syev_mod.sym_eig

    def counted(H):
        shapes.add(tuple(H.shape))
        return real(H)

    def refused(*args, **kw):
        raise AssertionError("torch.linalg.eigh called in the sweep's lanes")

    monkeypatch.setattr(syev_mod, "sym_eig", counted)
    monkeypatch.setattr(torch.linalg, "eigh", refused)
    check_sweep_parity(600, 200, 40, 5, True, 2, expect_blocked=False,
                       fiedler_block_q=12)
    assert shapes == {(2, 12, 12), (2, 36, 36)}, shapes


def test_sweep_refuses_the_banded_float64_route():
    """use_banded=True with float64 (a route the port once refused) now
    solves a sweep on the banded operator in float64: the reference's 5
    steps, each lane rounded to exactly its k, each lane's dual bound at
    least its relaxed lambda_2 (scipy referee) and within 1e-9 relative of
    its serial solve's relaxed lambda_2 (tests/test_torch_banded_methods.py
    holds the route against the JAX package's sweep)."""
    idx, w, n = pose_graph(600, 200, 40, 5)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    mac = MAC(fixed, cands, n, dtype=torch.float64, use_banded=True,
              device="cpu")
    assert mac._banded is not None and not mac._fast32
    ks = [10, 20]
    rounded, unrounded, upper = mac.solve_sweep(ks)
    assert [int(r.sum()) for r in rounded] == ks
    for r, k in enumerate(ks):
        lam = scipy_lam2(mac.laplacian(unrounded[r]))
        assert upper[r] >= lam * (1 - 1e-9)
        serial = scipy_lam2(mac.laplacian(mac.solve(k)[1]))
        assert abs(lam - serial) <= 1e-9 * serial, (k, lam, serial)


def test_sweep_checks_its_arguments():
    tree, loops, n = petersen()
    mac = MAC(nx_to_mac(tree), nx_to_mac(loops), n, device="cpu")
    with pytest.raises(ValueError, match="rounding"):
        mac.solve_sweep([1, 2], rounding="random")
    with pytest.raises(ValueError, match="x_init"):
        mac.solve_sweep([1, 2], x_init=np.zeros((3, len(mac.weights))))

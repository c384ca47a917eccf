"""Whole MAC.solve of the PyTorch port against the JAX package on the CPU,
with the default fast32 policy on the banded float32 path, at n = 600: no
overflow split (kernel K2's tables) and the exact chain factor, with the
default eigensolver block and with a block of 11 columns. Also the
disconnected graph, held to its analytic lambda_2 = 0."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from mac_tpu_torch.utils.fiedler import scipy_lam2
from mac_tpu_torch.utils.graphs import Edge
from tests.test_torch_banded import pose_graph

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

SMALL = dict(use_banded=True, fw_polish=False)


def check_solve_parity(n, n_loops, span, seed, expect_split=None,
                       expect_blocked=None, **knobs):
    """Both packages solve the same problem from the same NaiveGreedy start
    (the port given the JAX package's random previous-iterate block), with
    the same extra MAC knobs; their relaxed lambda_2, scored by the scipy
    float64 referee, agree within 1e-3 relative; each rounding holds
    exactly k edges; each upper bound is at least the referee's lambda_2 of
    its relaxed solution. Returns both rounded selections."""
    idx, w, n = pose_graph(n, n_loops, span, seed)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    x_init = NaiveGreedy(cands).subset(k)
    jm = JMAC(fixed, cands, n, dtype=jnp.float32, **SMALL, **knobs)
    jm.round_guard = False
    jr, ju, jup = jm.solve(k, x_init)
    tm = MAC(fixed, cands, n, dtype=torch.float32, round_guard=False,
             device="cpu", **SMALL, **knobs)
    if expect_split is not None:
        assert (tm._banded.ov_rows > 0) == expect_split
    if expect_blocked is not None:
        assert (n > 4096) == expect_blocked
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    tr, tu, tup = tm.solve(k, x_init)
    assert tm.last_solve_stats["fw_iterations"] == 32
    assert tm.last_solve_stats["tail_averaged"]
    lam_j = scipy_lam2(jm.laplacian(ju))
    lam_t = scipy_lam2(tm.laplacian(tu))
    assert abs(lam_t - lam_j) <= 1e-3 * abs(lam_j), (lam_t, lam_j)
    assert tr.sum() == k and jr.sum() == k
    assert set(np.unique(tr)) <= {0.0, 1.0}
    assert np.isfinite(tup) and tup >= lam_t * (1 - 1e-9), (tup, lam_t)
    assert jup >= lam_j * (1 - 1e-9)
    return tr, jr


def test_solve_matches_jax_exact_factor():
    check_solve_parity(600, 200, 40, 5, expect_split=False,
                       expect_blocked=False)


def test_solve_with_a_wide_block_matches_jax():
    """fiedler_block_q=11: TRACEMIN's 33 x 33 Rayleigh-Ritz eigensolves
    (K4w on the card, the plain Jacobi here) in every solve; the relaxed
    lambda_2 within 1e-3 relative of the JAX package's at the same q, and
    the same rounded selection."""
    tr, jr = check_solve_parity(600, 200, 40, 5, fiedler_block_q=11)
    np.testing.assert_array_equal(tr, jr)


def test_disconnected_graph_gives_lambda2_zero():
    """Two chains that no candidate joins: lambda_2 = 0 for every
    selection. The solve stays finite, rounds to k edges and certifies a
    finite bound >= 0 (held to the analytic answer, not to the JAX
    package)."""
    n = 1200
    half = n // 2
    fixed = ([Edge(i, i + 1, 1.0) for i in range(half - 1)]
             + [Edge(i, i + 1, 1.0) for i in range(half, n - 1)])
    cands = [Edge(0, 5, 1.0), Edge(half, half + 9, 1.0), Edge(2, 30, 1.0)]
    mac = MAC(fixed, cands, n, dtype=torch.float32, round_guard=False,
              device="cpu", **SMALL)
    rounded, unrounded, upper = mac.solve(2)
    assert rounded.sum() == 2
    assert np.all(np.isfinite(unrounded)) and np.isfinite(upper)
    lam2 = scipy_lam2(mac.laplacian(unrounded))
    assert abs(lam2) < 1e-8
    assert upper >= 0.0

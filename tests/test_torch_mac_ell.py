"""Whole MAC.solve of the PyTorch port against the JAX package on the CPU on
the matrix-free route: synthetic(3000), a chain plus expander-like loop
closures with no narrow band, with the scale benchmark's knobs
(scripts/bench_scale.py). Also the automatic routing of such a graph and
chip_smoke.py's copy of the generator."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch import convert
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.fiedler import scipy_lam2
from scripts.bench_scale import synthetic

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

KNOBS = dict(fiedler_inner_iters=10, fiedler_maxiter=60, fiedler_tol=6e-4)


def problem(n):
    fi, wf, ci, wc = synthetic(n, seed=0, local=False)
    k = len(wc) // 4
    x_init = np.zeros(len(wc))
    x_init[np.argpartition(wc, -k)[-k:]] = 1.0
    return (fi, wf), (ci, wc), n, k, x_init


@pytest.mark.parametrize("local", [False, True])
def test_chip_smoke_synthetic_equals_bench_scale(local):
    for a, b in zip(chip_smoke.synthetic(3000, local=local),
                    synthetic(3000, local=local)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_ell_solve_matches_jax():
    """The port picks the matrix-free route by itself (float32 from the
    precision probe, no band, fw_polish and round_guard off, the two-grid
    preconditioner and the reference defaults); the JAX package is pinned
    to the same route (dtype float32, use_banded=False). From the same
    top-k start, with the JAX previous-iterate block injected, three
    Frank-Wolfe steps each: the same step count, relaxed lambda_2 (scipy
    float64 referee) within 1e-3 relative, k edges in each rounding, each
    upper bound at least the referee's lambda_2, and evaluate_objective of
    the same selection within 1e-4 relative."""
    fixed, cands, n, k, x_init = problem(3000)
    tm = MAC(fixed, cands, n, device="cpu", **KNOBS)
    assert tm.dtype == torch.float32 and tm._banded is None
    assert tm.op.mode == "ell" and tm.fiedler_precond == "twogrid"
    assert not tm.fw_polish and not tm.round_guard
    assert (tm.fiedler_rel_tol, tm.fiedler_coeff_dtype) == (None, None)
    assert tm._warm_schedule == ((1, 60),) and tm._warm_inner_schedule is None
    jm = JMAC(fixed, cands, n, dtype=jnp.float32, use_banded=False, **KNOBS)
    assert jm._banded is None and not jm.fw_polish and not jm.round_guard
    for a, b in zip(tm._params[:3], convert.mac_params(jm._params)[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    jr, ju, jup = jm.solve(k, x_init, max_iters=3, use_cache=True)
    tr, tu, tup = tm.solve(k, x_init, max_iters=3, use_cache=True)
    assert (tm.last_solve_stats["fw_iterations"]
            == jm.last_solve_stats["fw_iterations"] == 3)
    assert not tm.last_solve_stats["tail_averaged"]
    lam_j = scipy_lam2(jm.laplacian(ju))
    lam_t = scipy_lam2(tm.laplacian(tu))
    assert abs(lam_t - lam_j) <= 1e-3 * abs(lam_j), (lam_t, lam_j)
    assert tr.sum() == k and jr.sum() == k
    assert set(np.unique(tr)) <= {0.0, 1.0}
    assert tup >= lam_t * (1 - 1e-9) and jup >= lam_j * (1 - 1e-9)
    ev_t, ev_j = tm.evaluate_objective(ju), jm.evaluate_objective(ju)
    assert abs(ev_t - ev_j) <= 1e-4 * abs(ev_j), (ev_t, ev_j)


def test_evaluate_objective_banded_matches_jax():
    """evaluate_objective on the banded route (fast32 knobs, so the
    evaluation tolerance min(3e-2, 1e-3)): the same selection scores within
    1e-4 relative of the JAX package's, and within 1e-4 of the scipy
    float64 referee."""
    from tests.test_torch_banded import GRAPHS, pose_graph

    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    jm = JMAC(fixed, cands, n, use_banded=True, dtype=jnp.float32,
              fw_polish=False)
    tm = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
             fw_polish=False, round_guard=False, device="cpu")
    assert tm._banded is not None and tm._eval_rel_tol() == 1e-3
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    x = np.random.RandomState(6).rand(len(cands[1]))
    ev_t, ev_j = tm.evaluate_objective(x), jm.evaluate_objective(x)
    assert abs(ev_t - ev_j) <= 1e-4 * abs(ev_j), (ev_t, ev_j)
    lam = scipy_lam2(tm.laplacian(x))
    assert abs(ev_t - lam) <= 1e-4 * lam, (ev_t, lam)

"""The host Frank-Wolfe engine of the PyTorch port against the JAX package's
(JMAC(dtype=float64, fiedler_backend="host")) on the CPU: a synthetic
tiny-gap chain graph, and data/kitti_02.g2o and data/intel.g2o at full size
with scripts/bench_all.py's protocol; the k = 0 and k >= m shortcuts, the
fallback, Madow rounding on the host engine, the splu cadence and the
opt-in host_pcg."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                           split_edges)
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from mac_tpu_torch.utils.fiedler import scipy_lam2

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data"


def tiny_gap_chain(n=900, n_cand=120, seed=0):
    """A long chain with short loop closures: lambda_2 / ||L||_inf ~ 1e-6,
    below float32 resolution."""
    rng = np.random.RandomState(seed)
    fixed = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - 40, n_cand)
    cand = np.stack([lo, lo + 2 + rng.randint(0, 30, n_cand)], 1)
    return (fixed, 0.5 + rng.rand(n - 1)), (cand, 0.5 + rng.rand(n_cand)), n


def jax_host(fixed, cands, n, **kw):
    return JMAC(fixed, cands, n, dtype=jnp.float64, fiedler_backend="host",
                **kw)


def assert_same_solve(tm, jm, k, x_init, **kw):
    """Both solves from the same start: the relaxed lambda_2 (scipy
    float64 referee) within 1e-9 relative, the identical rounded selection
    of k edges, the same step counts, upper bounds within 1e-9 relative and
    at least the relaxed value."""
    tr, tu, tup = tm.solve(k, x_init, **kw)
    jr, ju, jup = jm.solve(k, x_init, **kw)
    lam_t, lam_j = scipy_lam2(tm.laplacian(tu)), scipy_lam2(jm.laplacian(ju))
    assert abs(lam_t - lam_j) <= 1e-9 * abs(lam_j), (lam_t, lam_j)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    assert tr.sum() == k
    ts, js = tm.last_solve_stats, jm.last_solve_stats
    assert ts["backend"] == js["backend"] == "host"
    assert ts["fw_iterations"] == js["fw_iterations"]
    assert ts["fiedler_iterations"] == js["fiedler_iterations"]
    assert abs(tup - jup) <= 1e-9 * abs(jup)
    assert tup >= lam_t * (1 - 1e-9)
    return tr, tu, tup


@pytest.mark.parametrize("dataset,backend_reason", [
    ("kitti_02", "below float32 resolution"),
    ("intel", "small instance")])
def test_bundled_dataset_host_solve_equals_jax(dataset, backend_reason):
    """MAC(fixed, cands, n, device="cpu") with no other knob routes the
    dataset to the float64 host engine and solves it at K = 50% of the
    loop closures from the NaiveGreedy start like the JAX package's host
    engine."""
    meas, n = read_g2o_file(str(DATA / f"{dataset}.g2o"))
    fixed, cands = split_edges(rpm_to_mac(meas))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    tm = MAC(fixed, cands, n, device="cpu")
    assert tm.dtype == torch.float64 and tm.fiedler_backend == "host"
    assert backend_reason in tm.auto_dtype_reason
    assert_same_solve(tm, jax_host(fixed, cands, n), k, x_init,
                      use_cache=True)


def test_tiny_gap_chain_host_solve_equals_jax():
    """The synthetic tiny-gap chain (n = 900, escalated by the probe): the
    automatic solve, an explicit max_iters with the gap stop off, and a
    cold (use_cache=False) solve each equal the JAX package's."""
    fixed, cands, n = tiny_gap_chain()
    k = 40
    tm = MAC(fixed, cands, n, device="cpu")
    assert tm.fiedler_backend == "host" and tm._tiny_gap
    assert tm.spectral_ratio < 1.2e-5
    jm = jax_host(fixed, cands, n)
    x_init = np.full(120, k / 120)
    assert_same_solve(tm, jm, k, x_init)
    assert_same_solve(tm, jm, k, None, max_iters=7,
                      relative_duality_gap_tol=0.0)
    assert tm.last_solve_stats["fw_iterations"] == 7
    assert_same_solve(tm, jm, k, x_init, max_iters=4, use_cache=False)


def test_host_shortcuts_fallback_and_madow():
    """k = 0 selects nothing and k >= m everything, with F of that
    selection as the bound (the JAX package's value to 1e-9 relative, and
    return_rounding_time's 0.0); fallback returns the start when it scores
    higher than the rounding; Madow rounding on the host engine selects
    exactly k edges, reproducibly, and its best of 3 scores at least its
    first sample."""
    fixed, cands, n = tiny_gap_chain()
    m, k = 120, 40
    tm = MAC(fixed, cands, n, device="cpu")
    jm = jax_host(fixed, cands, n)
    for kk, want in ((0, 0), (-3, 0), (m, m), (m + 5, m)):
        r, x, obj = tm.solve(kk)
        assert r.sum() == want and x.sum() == want
        jobj = jm.solve(kk)[2]
        assert abs(obj - jobj) <= 1e-9 * abs(jobj)
        assert tm.solve(kk, return_rounding_time=True)[3] == 0.0
    # A start no one-step solve from it beats: the full solve's rounding.
    best = tm.solve(k)[0]
    worse = np.zeros(m)
    worse[:k] = 1.0
    f_best = tm.evaluate_objective(best)
    got = tm.solve(k, best, max_iters=1, fallback=True)[0]
    assert tm.evaluate_objective(got) >= f_best * (1 - 1e-12)
    got = tm.solve(k, worse, fallback=True)[0]
    assert tm.evaluate_objective(got) >= tm.evaluate_objective(worse)
    r1 = tm.solve(k, rounding="madow", seed=3)[0]
    r2, _, _, secs = tm.solve(k, rounding="madow", seed=3,
                              return_rounding_time=True)
    np.testing.assert_array_equal(r1, r2)
    assert r1.sum() == k and secs >= 0.0
    r3 = tm.solve(k, rounding="madow", seed=3,
                  random_rounding_max_iters=3)[0]
    assert r3.sum() == k
    assert (tm.evaluate_objective(r3)
            >= tm.evaluate_objective(r1) * (1 - 1e-9))
    with pytest.raises(ValueError, match="rounding"):
        tm.solve(k, rounding="topk")


def test_host_splu_cadence_and_pcg_equal_jax():
    """precond_refresh_period as the splu cadence (a stale factor every
    other step) and the opt-in host_pcg (block CG preconditioned by the
    last factor) follow the JAX package's loops: the same iteration
    counts, the relaxed lambda_2 within 1e-9 relative, and host_pcg's
    per-step CG counts equal."""
    fixed, cands, n = tiny_gap_chain(600, 80, 1)
    k = 30
    tm = MAC(fixed, cands, n, device="cpu", precond_refresh_period=2)
    jm = jax_host(fixed, cands, n, precond_refresh_period=2)
    assert_same_solve(tm, jm, k, None, max_iters=6)
    tm = MAC(fixed, cands, n, device="cpu")
    jm = jax_host(fixed, cands, n)
    tm.host_pcg = jm.host_pcg = True
    assert_same_solve(tm, jm, k, None, max_iters=6)
    assert (tm.last_solve_stats["host_pcg_iters"]
            == jm.last_solve_stats["host_pcg_iters"])
    assert tm.last_solve_stats["host_pcg_iters"]

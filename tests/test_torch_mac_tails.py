"""The exact float64 tails of the banded float32 route, on the CPU against
the JAX package: the guarded polish step (_host_polish), the post-rounding
round guard (_round_guard_impl) with the JAX package's Madow offsets
injected, their wiring into solve through the RCM permutation, and the two
reference defects the port does not carry over (an unchanged selection
reported as improved; an explicit fw_polish=True lost to the pre-gate)."""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.fiedler import scipy_lam2
from mac_tpu_torch.utils.graphs import Edge

torch.set_num_threads(1)

BANDED32 = dict(dtype=torch.float32, use_banded=True, device="cpu")
JBANDED32 = dict(dtype=jnp.float32, use_banded=True)


def polish_problem():
    """The graph of the JAX package's test_fw_polish_guarded_improvement."""
    rng = np.random.RandomState(11)
    n = 600
    fixed = [Edge(i, i + 1, 0.5 + rng.rand()) for i in range(n - 1)]
    cands = [Edge(i, i + 4 + (i % 7), 0.5 + rng.rand())
             for i in range(0, 550, 5)]
    return fixed, cands, n, len(cands) // 2


def bridge_problem():
    """Two chain communities joined only by two candidate bridges (the JAX
    package's test_round_guard_repairs_collapsed_rounding): a selection
    with no bridge collapses lambda_2 to 0."""
    rng = np.random.RandomState(5)
    half = 40
    fixed = [Edge(i, i + 1, 1.0 + rng.rand()) for i in range(half - 1)]
    fixed += [Edge(half + i, half + i + 1, 1.0 + rng.rand())
              for i in range(half - 1)]
    bridges = [Edge(10, half + 10, 0.6), Edge(20, half + 20, 0.6)]
    inside = [Edge(i, i + 2, 1.0) for i in range(0, 30, 3)]
    return fixed, bridges + inside, 2 * half, 4


def jax_madow_u(seed, count, dtype=jnp.float32):
    """The offsets the JAX package's guard draws for its Madow samples."""
    keys = jax.random.split(jax.random.PRNGKey(seed ^ 0x5EED), count)
    return torch.tensor(np.asarray(
        [jax.random.uniform(kk, (), dtype=dtype) for kk in keys]))


def lam2(mac, x):
    return scipy_lam2(mac.laplacian(np.asarray(x, np.float64)))


def test_host_polish_equals_jax_and_is_monotone():
    """_host_polish from the same iterate: the JAX package's result to
    1e-10 (iterate, Fiedler vector up to sign, accept flag, eigensolve
    count); each accepted polish raises the float64 objective, and a polish
    whose certificate is already within its target is rejected and returns
    its input unchanged, with the exact Fiedler vector."""
    fixed, cands, n, k = polish_problem()
    tm = MAC(fixed, cands, n, **BANDED32)
    jm = JMAC(fixed, cands, n, **JBANDED32)
    assert tm.fw_polish and tm.round_guard and tm._perm is not None
    x = np.full(len(cands), k / len(cands))
    xt, vt, Xt, acc_t = tm._host_polish(x, k)
    jm._exact_evals = 0
    xj, vj, Xj, acc_j = jm._host_polish(x, k)
    assert acc_t == acc_j and acc_t
    assert tm._exact_evals == jm._exact_evals
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vt * np.sign(vt @ vj), vj, rtol=0, atol=1e-8)
    assert vt.shape == (n,) and Xt.shape == Xj.shape
    assert tm.last_polish_info["gap0"] == pytest.approx(
        jm.last_polish_info["gap0"], rel=1e-9)
    f = lam2(tm, x)
    for _ in range(2):
        x_new, _, _, accepted = tm._host_polish(x, k)
        f_new = lam2(tm, x_new)
        assert accepted and f_new > f
        x, f = x_new, f_new
    tm.fw_polish_target = 1.0
    x_new, v, _, accepted = tm._host_polish(x, k)
    assert not accepted
    np.testing.assert_array_equal(x_new, x)
    L = tm.laplacian(x)
    assert abs(v @ (L @ v) / (v @ v) - f) <= 1e-9 * f


def test_solve_runs_the_tails_through_the_permutation():
    """A banded solve whose RCM permutation is not the identity: the basis
    handed to the polish is the device's in original node ids (its first
    column's Rayleigh quotient on L(x) is lambda_2 to 1e-2, where a
    permuted one would sit near ||L||, four orders above), the certificate built from the
    polish's eigenvector is within 2% above the refereed relaxed lambda_2,
    the relaxed lambda_2 is at least the JAX package's (whose pre-gate
    skips the polish here) less 1e-3 relative, and the stats carry the
    tails' keys."""
    fixed, cands, n, k = polish_problem()
    tm = MAC(fixed, cands, n, fw_polish=True, **BANDED32)
    jm = JMAC(fixed, cands, n, **JBANDED32)
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    assert not np.array_equal(tm._perm, np.arange(n))
    seen = {}
    real = tm._host_polish

    def spy(x, k_, X_warm=None):
        seen["x"], seen["X_warm"] = x, X_warm
        return real(x, k_, X_warm=X_warm)

    tm._host_polish = spy
    tr, tu, tup = tm.solve(k)
    L = tm.laplacian(seen["x"])
    v = seen["X_warm"][:, 0]
    v = v - v.mean()
    rq = float(v @ (L @ v) / (v @ v))
    assert abs(rq - scipy_lam2(L)) <= 1e-2 * rq
    lam_t = lam2(tm, tu)
    assert lam_t * (1 - 1e-9) <= tup <= lam_t * 1.02
    jr, ju, jup = jm.solve(k)
    lam_j = lam2(jm, ju)
    assert lam_t >= lam_j * (1 - 1e-3), (lam_t, lam_j)
    assert tr.sum() == k == np.asarray(jr).sum()
    assert lam2(tm, tr) >= lam2(jm, jr) * (1 - 1e-3)
    stats = tm.last_solve_stats
    assert {"polished", "polish_time_s", "guard_time_s", "round_guard",
            "exact_evals", "fw_time_s"} <= set(stats)
    assert stats["exact_evals"] > 0


def test_explicit_fw_polish_wins_over_the_pre_gate():
    """With a big-gap threshold no endpoint passes, the automatic polish is
    skipped by the pre-gate (polished False, the gap recorded, no exact
    polish solve), while an explicit fw_polish=True runs its exact round
    all the same. (The reference skips both.)"""
    fixed, cands, n, k = polish_problem()
    auto = MAC(fixed, cands, n, round_guard=False, **BANDED32)
    auto.fw_polish_big_gap = 0.0
    auto.solve(k)
    assert auto.fw_polish and not auto.last_solve_stats["polished"]
    assert auto.last_solve_stats["polish_skipped_gap"] > 0.0
    assert "polish_time_s" not in auto.last_solve_stats
    assert auto.last_solve_stats["exact_evals"] == 0
    forced = MAC(fixed, cands, n, fw_polish=True, round_guard=False,
                 **BANDED32)
    forced.fw_polish_big_gap = 0.0
    _, xu, _ = forced.solve(k)
    assert "polish_skipped_gap" not in forced.last_solve_stats
    assert "polish_time_s" in forced.last_solve_stats
    assert forced.last_solve_stats["exact_evals"] >= 1
    off = MAC(fixed, cands, n, fw_polish=False, round_guard=False,
              **BANDED32)
    _, xo, _ = off.solve(k)
    assert "polished" not in off.last_solve_stats
    assert lam2(forced, xu) >= lam2(off, xo) * (1 - 1e-9)


def test_round_guard_repairs_collapsed_rounding_like_jax():
    """A collapsed selection (no bridge) is repaired: with the JAX
    package's Madow offsets injected, the same selection as the JAX
    package's guard, of k edges, with a bridge, its refereed lambda_2
    above the input's 0; a healthy selection comes back monotone (never
    worse, same cardinality, the JAX package's result)."""
    fixed, cands, n, k = bridge_problem()
    tm = MAC(fixed, cands, n, **BANDED32)
    jm = JMAC(fixed, cands, n, **JBANDED32)
    tm._madow_u = lambda seed, count: jax_madow_u(0, count)
    m = len(cands)
    x_rel = np.full(m, k / m)
    bad = np.zeros(m)
    bad[2:2 + k] = 1.0
    f_rel = max(lam2(tm, x_rel + 0.2), 0.05)
    rep_t, hit_t = tm._round_guard_impl(bad, x_rel.astype(np.float32), f_rel,
                                        k, seed=0)
    rep_j, hit_j = jm._round_guard_impl(
        bad, jnp.asarray(x_rel, jnp.float32), f_rel, k, seed=0)
    assert hit_t and hit_j
    np.testing.assert_array_equal(rep_t, np.asarray(rep_j))
    assert rep_t.sum() == k and (rep_t[0] > 0.5 or rep_t[1] > 0.5)
    f_bad = np.linalg.eigvalsh(tm.laplacian(bad).toarray())[1]
    assert abs(f_bad) < 1e-9 and lam2(tm, rep_t) > 1e-3

    good = np.zeros(m)
    good[:k] = 1.0
    f_good = lam2(tm, good)
    kept_t, hit2_t = tm._round_guard_impl(good, x_rel.astype(np.float32),
                                          f_good, k, seed=0)
    kept_j, hit2_j = jm._round_guard_impl(
        good, jnp.asarray(x_rel, jnp.float32), f_good, k, seed=0)
    np.testing.assert_array_equal(kept_t, np.asarray(kept_j))
    assert hit2_t == hit2_j and kept_t.sum() == k
    assert lam2(tm, kept_t) >= f_good * (1 - 1e-12)
    assert hit2_t == (not np.array_equal(kept_t, good))


def test_round_guard_certified_collapse_skips_the_base_eigensolve():
    """With the relaxed Ritz block supplied, the collapse is certified by
    a Rayleigh quotient and the repair comes from the Madow samples alone:
    at most 3 exact eigensolves (the JAX package's count), the same
    selection, a bridge added."""
    fixed, cands, n, k = bridge_problem()
    tm = MAC(fixed, cands, n, **BANDED32)
    jm = JMAC(fixed, cands, n, **JBANDED32)
    tm._madow_u = lambda seed, count: jax_madow_u(0, count)
    m = len(cands)
    x_rel = np.full(m, k / m)
    bad = np.zeros(m)
    bad[2:2 + k] = 1.0
    lam, V = np.linalg.eigh(tm.laplacian(x_rel).toarray())
    rng = np.random.RandomState(5)
    X_warm = np.concatenate([V[:, 1:2], rng.randn(n, 7)], axis=1)
    tm._exact_evals = jm._exact_evals = 0
    rep_t, hit_t = tm._round_guard_impl(bad, x_rel.astype(np.float32),
                                        float(lam[1]), k, seed=0,
                                        X_warm=X_warm)
    rep_j, hit_j = jm._round_guard_impl(
        bad, jnp.asarray(x_rel, jnp.float32), float(lam[1]), k, seed=0,
        X_warm=X_warm)
    assert hit_t and hit_j
    np.testing.assert_array_equal(rep_t, np.asarray(rep_j))
    assert rep_t.sum() == k and (rep_t[0] > 0.5 or rep_t[1] > 0.5)
    assert tm._exact_evals == jm._exact_evals <= 3
    assert lam2(tm, rep_t) > 1e-3


def test_round_guard_reports_no_improvement_for_an_unchanged_selection():
    """The input is the best selection there is (brute force over all 20),
    and a huge relaxed anchor with a poor warm vector certifies a
    "collapse" whose upper bound no sample can beat. The guard then
    anchors on the base's true value, finds no better swap, and returns the
    input with improved False. (The reference leaves its best value at the
    upper bound and reports the unchanged selection as improved.)"""
    rng = np.random.RandomState(3)
    n = 30
    fixed = [Edge(i, i + 1, 1.0 + rng.rand()) for i in range(n - 1)]
    cands = [Edge(0, 29, 1.0), Edge(3, 20, 0.7), Edge(5, 9, 0.5),
             Edge(12, 25, 0.9), Edge(1, 4, 0.4), Edge(8, 28, 0.8)]
    k, m = 3, 6
    tm = MAC(fixed, cands, n, **BANDED32)
    jm = JMAC(fixed, cands, n, **JBANDED32)

    def exact(sel):
        r = np.zeros(m)
        r[list(sel)] = 1.0
        return np.linalg.eigvalsh(tm.laplacian(r).toarray())[1], r

    f_best, best = max((exact(s) for s in
                        itertools.combinations(range(m), k)),
                       key=lambda t: t[0])
    X_warm = rng.randn(n, 4)
    x_rel = np.full(m, k / m)
    out_t, hit_t = tm._round_guard_impl(best, x_rel.astype(np.float32), 1e6,
                                        k, seed=0, X_warm=X_warm)
    np.testing.assert_array_equal(out_t, best)
    assert not hit_t
    out_j, hit_j = jm._round_guard_impl(
        best, jnp.asarray(x_rel, jnp.float32), 1e6, k, seed=0, X_warm=X_warm)
    np.testing.assert_array_equal(np.asarray(out_j), best)
    assert hit_j  # the reference's defect, absent from the port


def test_solve_round_guard_flag_follows_the_selection():
    """Through solve on the bridge graph: round_guard in the stats is True
    only if the returned selection differs from nearest rounding's, which
    the guard-free solver returns; the guarded rounding's refereed lambda_2
    is never below it."""
    fixed, cands, n, k = bridge_problem()
    on = MAC(fixed, cands, n, **BANDED32)
    off = MAC(fixed, cands, n, round_guard=False, **BANDED32)
    r_on, _, _ = on.solve(k, seed=1)
    r_off, _, _ = off.solve(k, seed=1)
    assert r_on.sum() == r_off.sum() == k
    assert on.last_solve_stats["round_guard"] == (
        not np.array_equal(r_on, r_off))
    assert off.last_solve_stats["round_guard"] is False
    assert "guard_time_s" not in off.last_solve_stats
    f_on = np.linalg.eigvalsh(on.laplacian(r_on).toarray())[1]
    f_off = np.linalg.eigvalsh(off.laplacian(r_off).toarray())[1]
    assert f_on >= f_off - 1e-10

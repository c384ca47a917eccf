"""The float64 device route of mac_tpu_torch.MAC against the JAX package's
(dtype float64, fiedler_backend="device") on the CPU, to 1e-8: the Petersen
graph on the dense operator, and chain-fixed graphs on the ELL operator
with the chain-solve and the two-grid preconditioners. Also convert's
float64 parameter tuple and the float64 rule of the tridiagonal dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch import convert
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.solvers import MAC

torch.set_num_threads(1)

TOL = 1e-8


def petersen():
    outer = [(i, (i + 1) % 5) for i in range(5)]
    spokes = [(i, i + 5) for i in range(5)]
    inner = [(5 + i, 5 + (i + 2) % 5) for i in range(5)]
    idx = np.array(outer + spokes + inner)
    rng = np.random.RandomState(0)
    w = 0.5 + rng.rand(15)
    # A spanning tree fixed (the spokes and four outer edges), the rest
    # candidates.
    fixed = list(range(4)) + list(range(5, 10))
    cand = [4] + list(range(10, 15))
    return (idx[fixed], w[fixed]), (idx[cand], w[cand]), 10


def chain_fixed(n, n_cand, seed, span):
    rng = np.random.RandomState(seed)
    fixed = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    lo = rng.randint(0, n - span - 2, n_cand)
    cand = np.stack([lo, lo + 2 + rng.randint(0, span, n_cand)], 1)
    return (fixed, 0.5 + rng.rand(n - 1)), (cand, 0.5 + rng.rand(n_cand)), n


def pair(problem, **kw):
    """The port's and the JAX package's float64 device solvers of one
    problem, the JAX previous-iterate block injected into the port's."""
    fixed, cands, n = problem
    tm = MAC(fixed, cands, n, dtype=torch.float64, device="cpu", **kw)
    jm = JMAC(fixed, cands, n, dtype=jnp.float64, fiedler_backend="device",
              **kw)
    assert tm.fiedler_backend == "device" and tm._banded is None
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float64)))
    return tm, jm


CASES = {
    "petersen_dense": (petersen, {}, "dense", "twogrid", 3),
    "chain_ell_tridiag": (lambda: chain_fixed(400, 60, 1, 30), {}, "ell",
                          "tridiag", 20),
    "chain_ell_twogrid": (lambda: chain_fixed(400, 120, 2, 60), {}, "ell",
                          "twogrid", 40),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f64_device_solve_equals_jax(case):
    """solve: the same Frank-Wolfe step count, the relaxed iterate within
    1e-8, the identical rounding, the loop's own dual bound (no float32
    certificate replaces it) within 1e-8 relative; evaluate_objective
    returns the eigensolver's float64 lambda_2 directly, within 1e-8
    relative of the JAX package's and of numpy's dense eigh; problem()
    within 1e-8."""
    make, kw, mode, precond, k = CASES[case]
    problem = make()
    tm, jm = pair(problem, **kw)
    assert tm.op.mode == mode and tm.fiedler_precond == precond
    assert tm.fiedler_precond == jm.fiedler_precond
    assert tm._eval_rel_tol() is None and not tm.fw_polish
    for a, b in zip(tm._params[:3],
                    convert.mac_params(jm._params, dtype=torch.float64)[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    tr, tu, tup = tm.solve(k)
    jr, ju, jup = jm.solve(k)
    assert (tm.last_solve_stats["fw_iterations"]
            == jm.last_solve_stats["fw_iterations"])
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=TOL)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    assert abs(tup - jup) <= TOL * abs(jup)
    x = np.random.RandomState(5).rand(len(problem[1][1]))
    ev_t, ev_j = tm.evaluate_objective(x), jm.evaluate_objective(x)
    ref = np.linalg.eigvalsh(tm.laplacian(x).toarray())[1]
    assert abs(ev_t - ev_j) <= TOL * abs(ev_j), (ev_t, ev_j)
    assert abs(ev_t - ref) <= TOL * ref, (ev_t, ref)
    (f_t, g_t), (f_j, g_j) = tm.problem(x), jm.problem(x)
    assert abs(f_t - f_j) <= TOL * abs(f_j)
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-7 * abs(g_j).max())


def test_f64_madow_and_shortcuts_on_the_device_route():
    """On the float64 device route: Madow rounding selects exactly k edges
    and its best of 3 scores at least its first sample; k = 0 and k >= m
    take the shortcuts; fallback keeps a start that beats the rounding."""
    problem = chain_fixed(400, 60, 1, 30)
    tm, _ = pair(problem)
    k, m = 20, 60
    r1 = tm.solve(k, rounding="madow", seed=1)[0]
    r3 = tm.solve(k, rounding="madow", seed=1,
                  random_rounding_max_iters=3)[0]
    assert r1.sum() == r3.sum() == k
    assert (tm.evaluate_objective(r3)
            >= tm.evaluate_objective(r1) * (1 - 1e-9))
    assert tm.solve(0)[0].sum() == 0 and tm.solve(m)[0].sum() == m
    best = tm.solve(k)[0]
    got = tm.solve(k, best, max_iters=1, fallback=True)[0]
    assert (tm.evaluate_objective(got)
            >= tm.evaluate_objective(best) * (1 - 1e-12))


def test_verbose_and_profile_dir(tmp_path, capsys):
    """verbose prints one line per Frank-Wolfe step, on the device loop and
    on the host engine; profile_dir leaves a torch.profiler Chrome trace of
    the solve and returns the same result."""
    fixed, cands, n = petersen()
    dev = MAC(fixed, cands, n, dtype=torch.float64, device="cpu")
    host = MAC(fixed, cands, n, dtype=torch.float64, fiedler_backend="host",
               device="cpu")
    for mac in (dev, host):
        plain = mac.solve(3, max_iters=4, relative_duality_gap_tol=0.0)
        capsys.readouterr()
        mac.solve(3, max_iters=4, relative_duality_gap_tol=0.0, verbose=True)
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("FW iter")]
        assert len(lines) == mac.last_solve_stats["fw_iterations"] == 4
        traced = mac.solve(3, max_iters=4, relative_duality_gap_tol=0.0,
                           profile_dir=str(tmp_path / "trace"))
        np.testing.assert_array_equal(traced[0], plain[0])
        assert (tmp_path / "trace" / "solve_trace.json").stat().st_size > 0


def test_tridiag_dispatch_sends_float64_to_the_scans(monkeypatch):
    """tridiag_solve_factored_fast on a float64 block goes to the K1
    wrapper (its float64 instantiation on a card; on the CPU tensors here
    the wrapper runs the plain scans, so the result is
    tridiag_solve_factored's bit for bit), as a float32 block does: the
    port's deliberate difference from the reference, whose float32-only
    kernels send float64 blocks to its scans."""
    calls = []
    for name in ("tridiag_solve", "tridiag_solve_blocked"):
        real = getattr(tt._kernels, name)
        monkeypatch.setattr(
            tt._kernels, name, lambda *a, _f=real, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
    rng = np.random.RandomState(0)
    n = 500
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    f = tt.tridiag_ldl(torch.as_tensor(d), torch.as_tensor(e))
    B = torch.as_tensor(rng.normal(size=(n, 3)))
    got = tt.tridiag_solve_factored_fast(f, B)
    assert calls == ["tridiag_solve"] and got.dtype == torch.float64
    assert torch.equal(got, tt.tridiag_solve_factored(f, B))
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(T @ got.numpy(), B.numpy(), atol=1e-9)
    tt.tridiag_solve_factored_fast(f, B.float())
    assert calls == ["tridiag_solve"] * 2

"""The routes the port's MAC gained on the banded operator, against the JAX
package's on the CPU at n = 600: use_banded=True in float64 (solve, and a
two-budget sweep), LOBPCG on the banded operator (at the fiedler_pair_op
level and through MAC, in float64 and float32) and the exact dense eigh on
it, whose incoming preconditioner state passes through unchanged. The port
is given the JAX package's random previous-iterate block."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu.ops.laplacian import build_operator
from mac_tpu.solvers import MAC as JMAC
from mac_tpu.utils.fiedler import fiedler_pair_op as jax_fiedler_pair_op
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.fiedler import (default_block, fiedler_pair_op,
                                         scipy_lam2)
from tests.test_torch_banded import pose_graph

torch.set_num_threads(1)

TOL64 = 1e-9  # float64: relaxed lambda_2, relative
TOL32 = 1e-3  # float32: the tolerance of the float32 banded MAC tests


def problem():
    idx, w, n = pose_graph(600, 110, 9, 11)
    return (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:]), n


def jax_xprev(n, q, dtype):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (n, q),
                                        dtype=dtype))


def pair(dtype, **kw):
    """The port's and the JAX package's solvers of problem() on the banded
    operator in `dtype`, the JAX previous-iterate block injected."""
    fixed, cands, n = problem()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    tm = MAC(fixed, cands, n, use_banded=True, dtype=dtype, device="cpu",
             **kw)
    jm = JMAC(fixed, cands, n, use_banded=True, dtype=jdt,
              fiedler_backend="device", **kw)
    assert tm._banded is not None and jm._banded is not None
    tm.xprev0 = torch.tensor(jax_xprev(n, tm._q, jdt))
    return tm, jm, len(cands[1]) // 2


@pytest.mark.parametrize("method", ["tracemin", "lobpcg"])
def test_banded_f64_solve_matches_jax(method):
    """use_banded=True in float64: the reference's conservative knobs (tol
    1e-8, 200 outer iterations, 16 inner CG steps, the reference's 5
    Frank-Wolfe steps, no tail average, no polish, no round guard); the
    relaxed lambda_2 (scipy referee) within 1e-9 relative of the JAX
    package's, the identical rounding and step count, the loop's dual
    bound at least the relaxed lambda_2."""
    tm, jm, k = pair(torch.float64, fiedler_method=method)
    assert (tm.fiedler_tol, tm.fiedler_maxiter, tm.fiedler_inner_iters) == (
        jm.fiedler_tol, jm.fiedler_maxiter, jm.fiedler_inner_iters) == (
        1e-8, 200, 16)
    assert tm.fiedler_rel_tol is None and tm.fiedler_coeff_dtype is None
    assert not (tm.fw_polish or tm.round_guard or tm.fw_tail_average)
    assert not (jm.fw_polish or jm.round_guard or jm.fw_tail_average)
    tr, tu, tup = tm.solve(k)
    jr, ju, jup = jm.solve(k)
    assert (tm.last_solve_stats["fw_iterations"]
            == jm.last_solve_stats["fw_iterations"] == 5)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    lam_t = scipy_lam2(tm.laplacian(tu))
    lam_j = scipy_lam2(jm.laplacian(np.asarray(ju)))
    assert abs(lam_t - lam_j) <= TOL64 * lam_j, (lam_t, lam_j)
    assert tr.sum() == k and tup >= lam_t * (1 - 1e-9)
    ev_t, ev_j = tm.evaluate_objective(tu), jm.evaluate_objective(ju)
    assert abs(ev_t - ev_j) <= TOL64 * ev_j


def test_banded_f64_sweep_matches_jax():
    """A two-budget solve_sweep on the banded operator in float64 against
    the JAX package's sweep: each lane's relaxed iterate within 1e-9, the
    identical rounding, the lanes' dual bounds within 1e-9 relative."""
    tm, jm, k = pair(torch.float64)
    ks = [k // 2, k]
    tr, tu, tup = tm.solve_sweep(ks)
    jr, ju, jup = jm.solve_sweep(ks)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=TOL64)
    np.testing.assert_allclose(tup, np.asarray(jup), rtol=TOL64)
    assert [int(r.sum()) for r in tr] == ks


@jax.jit
def _jax_lobpcg_pair(op, w, X, jbop):
    return jax_fiedler_pair_op(op, w, X, method="lobpcg", banded=jbop)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_lobpcg_pair_on_banded_operator_matches_jax(dtype):
    """fiedler_pair_op(method="lobpcg") on the banded operator (the banded
    products, the two-level preconditioner inside 16 PCG steps on the
    shifted operator) against the JAX package's at the same weights:
    lambda_2 within 1e-9 relative in float64, 1e-3 in float32; a carried
    preconditioner state comes back refreshed; lanes run lane after lane,
    each equal to its single solve."""
    fixed, cands, n = problem()
    idx = np.concatenate([fixed[0], cands[0]])
    w = np.concatenate([fixed[1], 0.5 * cands[1]])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jbop, ridx = jb.build_banded_rcm(idx, n, dtype=jdt)
    X = default_block(n, 4)
    jres = _jax_lobpcg_pair(build_operator(ridx, n), jnp.asarray(w, jdt),
                            jnp.asarray(X, jdt), jbop)
    tbop = convert.banded_operator(jbop)
    tw = torch.as_tensor(w, dtype=dtype)
    kw = dict(xprev0=torch.tensor(jax_xprev(n, 4, jdt)), method="lobpcg")
    res = fiedler_pair_op(tbop, tw, torch.as_tensor(X, dtype=dtype), **kw)
    tol = TOL64 if dtype == torch.float64 else TOL32
    lam_j = float(jres.lam[0])
    assert abs(float(res.lam[0]) - lam_j) <= tol * lam_j
    ref = np.linalg.eigvalsh(
        tb.banded_dense(tbop, tb.assemble_bd(tbop, tw)).double().numpy())[1]
    assert abs(float(res.lam[0]) - ref) <= tol * ref
    nc = tbop.coarse_nc
    pstate = tb.PrecondState(Lc_inv=torch.zeros((nc, nc), dtype=dtype),
                             chain_dp=torch.zeros(n, dtype=dtype),
                             chain_l=torch.zeros(n, dtype=dtype))
    res2, st = fiedler_pair_op(tbop, tw, torch.as_tensor(X, dtype=dtype),
                               banded_pstate=pstate, banded_use_prev=False,
                               return_banded_pstate=True, **kw)
    assert float(st.Lc_inv.abs().max()) > 0
    assert abs(float(res2.lam[0]) - lam_j) <= tol * lam_j
    if dtype == torch.float64:
        W = torch.stack([tw, 2 * tw])
        Xl = torch.as_tensor(X).expand(2, n, 4)
        lanes = fiedler_pair_op(tbop, W, Xl, **kw)
        assert lanes.lam.shape == (2, 4)
        for r in range(2):
            single = fiedler_pair_op(tbop, W[r], Xl[r], **kw)
            assert torch.equal(lanes.lam[r], single.lam)


def test_lobpcg_banded_float32_solve_matches_jax():
    """LOBPCG through MAC on the banded operator in float32 (the fast32
    knobs, no polish, no round guard): the relaxed lambda_2 (scipy
    referee) within 1e-3 relative of the JAX package's, exactly k edges
    each, the float64 certificate at least the relaxed lambda_2."""
    tm, jm, k = pair(torch.float32, fiedler_method="lobpcg", fw_polish=False)
    tm.round_guard = jm.round_guard = False
    assert tm.fiedler_tol == jm.fiedler_tol == 6e-4
    tr, tu, tup = tm.solve(k)
    jr, ju, jup = jm.solve(k)
    assert tm.last_solve_stats["fw_iterations"] == 32
    lam_t = scipy_lam2(tm.laplacian(tu))
    lam_j = scipy_lam2(jm.laplacian(np.asarray(ju)))
    assert abs(lam_t - lam_j) <= TOL32 * lam_j, (lam_t, lam_j)
    assert tr.sum() == k and np.asarray(jr).sum() == k
    assert tup >= lam_t * (1 - 1e-9)


def test_dense_fiedler_method_keeps_banded_pytree_carry():
    """fiedler_method="dense" with use_banded (the counterpart of the JAX
    package's test of the same name): the Frank-Wolfe loop carries the
    banded preconditioner state through the dense eigh unchanged, and the
    solve selects k edges with a finite bound; the dense pair is the exact
    eigh of L(w) in RCM ids, lanes as one batched eigh."""
    from mac_tpu_torch.utils.graphs import Edge

    rng = np.random.RandomState(5)
    n = 600  # the banded path needs n >= 4 * BS = 512
    fixed = [Edge(i, i + 1, 0.5 + rng.rand()) for i in range(n - 1)]
    cands = [Edge(i, i + 4 + (i % 7), 1.0) for i in range(0, 550, 5)]
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              fiedler_method="dense", device="cpu")
    assert mac._banded is not None
    k = len(cands) // 2
    rounded, unrounded, upper = mac.solve(k, max_iters=3)
    assert rounded.sum() == k
    assert np.isfinite(upper)
    # The pair itself, in float64 on the same operator tables.
    bop = mac._banded
    w = mac._w_all(mac._params, torch.full((len(cands),), 0.5)).double()
    X0 = mac._X0.double()
    nc = bop.coarse_nc
    pstate = tb.PrecondState(Lc_inv=torch.ones((nc, nc)),
                             chain_dp=torch.ones(n), chain_l=torch.zeros(n))
    res, st = fiedler_pair_op(bop, w, X0, xprev0=mac.xprev0.double(),
                              method="dense", banded_pstate=pstate,
                              banded_use_prev=True,
                              return_banded_pstate=True)
    assert st is pstate
    L = mac.laplacian(np.full(len(cands), 0.5)).toarray()
    np.testing.assert_allclose(res.lam.numpy(),
                               np.linalg.eigvalsh(L)[1:5], rtol=1e-10)
    lanes = fiedler_pair_op(bop, torch.stack([w, 2 * w]),
                            X0.expand(2, n, -1), xprev0=mac.xprev0.double(),
                            method="dense")
    torch.testing.assert_close(lanes.lam[1], 2 * res.lam, rtol=1e-10,
                               atol=0)

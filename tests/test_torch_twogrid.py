"""Parity of the PyTorch port's two-grid V-cycle (mac_tpu_torch.ops.twogrid)
and of its Fiedler front end on a matrix-free GraphOperator
(mac_tpu_torch.utils.fiedler.fiedler_pair_op) against the JAX package, on
the CPU: the V-cycle with the exact chain factor (n = 3000, kernel K1's
plain version) and with the blocked one (n = 34000, past 32768 rows: kernel
K1b's plain version), TRACEMIN on the ELL product, and the LOBPCG and
dense-eigh methods. The random block that seeds the eigensolvers'
previous-iterate memory is drawn by JAX and injected into the port."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import laplacian as jl
from mac_tpu.ops.twogrid import make_twogrid_precond as jax_twogrid
from mac_tpu.utils.fiedler import fiedler_pair_op as jax_fiedler
from mac_tpu_torch.ops import laplacian as tl
from mac_tpu_torch.ops.precond import extract_chain_weights
from mac_tpu_torch.ops.twogrid import make_twogrid_precond
from mac_tpu_torch.utils.fiedler import fiedler_pair_op
from mac_tpu.ops.precond import extract_chain_weights as jax_chain_weights
from tests.test_torch_eigen import jax_xprev
from tests.test_torch_laplacian import graph_and_weights

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [3000, 34000])
def test_twogrid_precond_matches_jax(n):
    """The V-cycle applied to a random (n, 4) block agrees within 1e-4 of
    its largest entry (the JAX package sums the coarse operator in float32,
    the port in float64); its output is centred."""
    idx, w, n = graph_and_weights(n)
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    B = np.random.RandomState(3).normal(size=(n, 4)).astype(np.float32)

    @jax.jit
    def run_jax(w, B):
        M = jax_twogrid(jop, w, lambda V: jl.lap_apply(jop, w, V))
        return M(B)

    ref = np.asarray(run_jax(jnp.asarray(w), jnp.asarray(B)))
    tw = torch.as_tensor(w)
    M = make_twogrid_precond(top, tw, tl.lap_applier(top, tw))
    got = M(torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    assert np.abs(got.mean(axis=0)).max() <= 1e-5 * np.abs(got).max()


def test_fiedler_pair_op_ell_matches_jax():
    """TRACEMIN on the ELL product with the V-cycle at n = 34000 (blocked
    chain factor), four outer iterations of four inner CG steps from the
    same start block: the same iteration count and lambda_2 within 1e-4
    relative."""
    idx, w, n = graph_and_weights(34000)
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    X0 = np.random.RandomState(4).normal(size=(n, 4)).astype(np.float32)
    kw = dict(maxiter=4, inner_iters=4)
    jres = jax.jit(functools.partial(jax_fiedler, **kw))(
        jop, jnp.asarray(w), jnp.asarray(X0))
    tres = fiedler_pair_op(top, torch.as_tensor(w), torch.as_tensor(X0),
                           xprev0=torch.tensor(jax_xprev(n, 4, jnp.float32)),
                           **kw)
    assert tres.iters == int(jres.iters) == 4
    np.testing.assert_allclose(float(tres.lam[0]), float(jres.lam[0]),
                               rtol=1e-4)


@pytest.mark.parametrize("n,method,precond", [
    (600, "lobpcg", "twogrid"), (600, "tracemin", "tridiag"),
    (600, "dense", "twogrid"), (200, "tracemin", "twogrid")])
def test_fiedler_methods_match_jax(n, method, precond):
    """In float64: LOBPCG (preconditioned by PCG on the V-cycle) and
    TRACEMIN with the tridiagonal preconditioner on the ELL product, ten
    outer iterations each; the exact dense eigh asked for by method="dense"
    and taken by a dense-mode operator (n <= 256). The q = 4 Ritz values
    agree within 1e-6 relative."""
    idx, w, n = graph_and_weights(n)
    w = w.astype(np.float64)
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    assert top.mode == ("dense" if n <= 256 else "ell")
    X0 = np.random.RandomState(5).normal(size=(n, 4))
    kw = dict(maxiter=10, inner_iters=4, method=method, precond=precond)
    jres = jax.jit(functools.partial(jax_fiedler, **kw))(
        jop, jnp.asarray(w), jnp.asarray(X0))
    tres = fiedler_pair_op(top, torch.as_tensor(w), torch.as_tensor(X0),
                           xprev0=torch.tensor(jax_xprev(n, 4, jnp.float64)),
                           **kw)
    assert tres.iters == int(jres.iters)
    np.testing.assert_allclose(tres.lam.numpy(), np.asarray(jres.lam),
                               rtol=1e-6)


def test_extract_chain_weights_matches_jax():
    """The odometry-chain detection behind the preconditioner policy: the
    per-slot weights when the fixed edges hold the whole chain (parallel
    edges summed), None when a link is missing."""
    idx, w, n = graph_and_weights(600)
    fixed_idx, fixed_w = idx[:n - 1], w[:n - 1].astype(np.float64)
    dup_idx = np.concatenate([fixed_idx, fixed_idx[:5]])
    dup_w = np.concatenate([fixed_w, fixed_w[:5]])
    for fi, fw in ((fixed_idx, fixed_w), (dup_idx, dup_w),
                   (fixed_idx[1:], fixed_w[1:])):
        got = extract_chain_weights(fi, fw, n)
        ref = jax_chain_weights(fi, fw, n)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    assert extract_chain_weights(fixed_idx[1:], fixed_w[1:], n) is None


@pytest.mark.parametrize("n", [200, 3000, 34000])
def test_ell_lanes_equal_single_lanes(n):
    """The matrix-free operator's lane forms (R = 3 weight vectors): the
    ELL (or dense) product, the degrees, the tridiagonal part, the coarse
    Laplacian and the V-cycle (one chain factor and one coarse level per
    lane; K1b's plain version past 32768 nodes) equal the single-lane calls
    in float64."""
    idx, w, n = graph_and_weights(n)
    op = tl.build_operator(idx, n)
    gen = torch.Generator().manual_seed(n)
    W = torch.as_tensor(w, dtype=torch.float64) * (
        0.25 + torch.rand((3, len(w)), generator=gen, dtype=torch.float64))
    V = torch.randn((3, n, 4), generator=gen, dtype=torch.float64)
    out = tl.lap_applier(op, W)(V)
    d, e = tl.lap_tridiagonal_part(op, W)
    norms = tl.lap_inf_norm(op, W)
    pre = (make_twogrid_precond(op, W, tl.lap_applier(op, W))(V)
           if op.mode == "ell" else None)
    for r in range(3):
        torch.testing.assert_close(out[r], tl.lap_applier(op, W[r])(V[r]),
                                   rtol=1e-12, atol=1e-12)
        d1, e1 = tl.lap_tridiagonal_part(op, W[r])
        assert torch.equal(d[r], d1) and torch.equal(e[r], e1)
        assert torch.equal(norms[r], tl.lap_inf_norm(op, W[r]))
        if pre is not None:
            from mac_tpu_torch.ops.twogrid import coarse_laplacian

            assert torch.equal(coarse_laplacian(op, W)[r],
                               coarse_laplacian(op, W[r]))
            torch.testing.assert_close(
                pre[r], make_twogrid_precond(op, W[r], tl.lap_applier(
                    op, W[r]))(V[r]), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,method,precond", [
    (200, "tracemin", "twogrid"), (1500, "tracemin", "twogrid"),
    (1500, "tracemin", "tridiag"), (1500, "lobpcg", "twogrid")])
def test_fiedler_pair_op_lanes_equal_single_lanes(n, method, precond):
    """fiedler_pair_op on R = 2 weight vectors and per-lane start blocks
    (dense eigh at n = 200; TRACEMIN with the V-cycle or the chain solve
    alone, and LOBPCG, at n = 1500) gives each lane's eigenpair of the
    single call, in float64: lambda to 1e-9 relative, the Fiedler vector
    to 1e-6 up to sign."""
    idx, w, n = graph_and_weights(n)
    op = tl.build_operator(idx, n)
    gen = torch.Generator().manual_seed(3)
    W = torch.as_tensor(w, dtype=torch.float64) * (
        0.25 + torch.rand((2, len(w)), generator=gen, dtype=torch.float64))
    X = torch.randn((2, n, 4), generator=gen, dtype=torch.float64)
    xprev = torch.randn((n, 4), generator=gen, dtype=torch.float64)
    kw = dict(xprev0=xprev, method=method, precond=precond, tol=1e-10)
    res = fiedler_pair_op(op, W, X, **kw)
    assert res.lam.shape == (2, 4) and res.X.shape == (2, n, 4)
    for r in range(2):
        one = fiedler_pair_op(op, W[r], X[r], **kw)
        assert abs(float(res.lam[r, 0] - one.lam[0])) <= 1e-9 * float(
            one.lam[0])
        v, v1 = res.X[r, :, 0], one.X[:, 0]
        torch.testing.assert_close(v * torch.sign(v @ v1), v1, rtol=0,
                                   atol=1e-6)

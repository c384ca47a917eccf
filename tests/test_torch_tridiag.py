"""Parity of the PyTorch port's tridiagonal LDL^T factors and solves
(kernels K1 and K1b, run here as their plain versions) against the JAX
package, on the CPU, and the port's solve dispatch. Inputs are made from
seeds with numpy and handed to both as arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import tridiag as jt
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
                                               tridiag_solve_blocked,
                                               tridiag_solve_blocked_plain,
                                               tridiag_solve_plain)

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _chain_system(n, seed):
    rng = np.random.RandomState(seed)
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    return d, e, rng


@pytest.mark.parametrize("kind", ["exact", "blocked"])
def test_tridiag_ldl_pivots_match_f64(kind):
    """Exact (Moebius doubling scan) and blocked (128-step recurrence)
    LDL^T factors match the JAX package's in float64 at rtol 1e-10."""
    d, e, _ = _chain_system(3000, 0)
    if kind == "exact":
        jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d), jnp.asarray(e))
        tf = tt.tridiag_ldl(torch.as_tensor(d), torch.as_tensor(e))
        assert tf.seg is None
    else:
        jf = jt.tridiag_ldl_blocked(jnp.asarray(d), jnp.asarray(e), block=128)
        tf = tt.tridiag_ldl_blocked(torch.as_tensor(d), torch.as_tensor(e),
                                    block=128)
        assert tf.seg == 128
    np.testing.assert_allclose(tf.dp.numpy(), np.asarray(jf.dp), rtol=1e-10)
    np.testing.assert_allclose(tf.l.numpy(), np.asarray(jf.l), rtol=1e-10,
                               atol=1e-300)


def test_tridiag_plain_solve_matches_pallas_kernel():
    """K1's plain version against the Pallas kernel (interpret mode) in f32
    at rtol/atol 2e-4, the tolerance the JAX package holds its kernel to;
    the wrapper on CPU tensors is the plain version."""
    from mac_tpu.ops.pallas.tridiag_kernel import tridiag_solve_fused

    d, e, rng = _chain_system(1200, 1)
    jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d, jnp.float32),
                                 jnp.asarray(e, jnp.float32))
    B = rng.normal(size=(1200, 3)).astype(np.float32)
    ref = np.asarray(tridiag_solve_fused(jf.dp, jf.l, jnp.asarray(B),
                                         interpret=True))
    dp, l = torch.tensor(np.asarray(jf.dp)), torch.tensor(np.asarray(jf.l))
    got = tridiag_solve_plain(dp, l, torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    before = tridiag_solve.launches
    np.testing.assert_array_equal(
        tridiag_solve(dp, l, torch.as_tensor(B)).numpy(), got)
    assert tridiag_solve.launches == before
    with pytest.raises(ValueError):
        tridiag_solve(dp[:-1], l, torch.as_tensor(B))


@pytest.mark.parametrize("n,q,kind", [(2500, 3, "blocked"),
                                       (2500, 3, "exact"),
                                       (40000, 8, "blocked")])
def test_blocked_plain_solve_matches_pallas_kernel(n, q, kind):
    """K1b's plain version against the segment-decoupled Pallas kernel
    (interpret mode) in f32 at rtol/atol 2e-4: on blocked factors (seg
    1024), and on an exact factor, whose non-zero couplings at the 1024
    boundaries both versions force to 0; the wrapper on CPU tensors is the
    plain version and counts no launch."""
    from mac_tpu.ops.pallas.tridiag_kernel import tridiag_solve_fused_blocked

    d, e, rng = _chain_system(n, 1 if n < 10000 else 7)
    ldl = jt.tridiag_ldl_blocked if kind == "blocked" else jt.tridiag_ldl
    jf = jax.jit(ldl)(jnp.asarray(d, jnp.float32),
                      jnp.asarray(e, jnp.float32))
    if kind == "exact":
        assert np.all(np.asarray(jf.l)[1024::1024] != 0)
    B = rng.normal(size=(n, q)).astype(np.float32)
    ref = np.asarray(tridiag_solve_fused_blocked(
        jf.dp.astype(jnp.float32), jf.l.astype(jnp.float32), jnp.asarray(B),
        block=1024, interpret=True))
    dp, l = torch.tensor(np.asarray(jf.dp)), torch.tensor(np.asarray(jf.l))
    got = tridiag_solve_blocked_plain(dp, l, torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    before = tridiag_solve_blocked.launches
    np.testing.assert_array_equal(
        tridiag_solve_blocked(dp, l, torch.as_tensor(B)).numpy(), got)
    assert tridiag_solve_blocked.launches == before


def test_tridiag_dispatch_refuses_unported_blocked_kernel(monkeypatch):
    """No blocked factor is refused any more, now that K1b is ported (a
    float64 block on the card is, which tests/test_torch_cuda.py checks).
    The dispatch rule of the JAX package: past 32768
    rows a factor decoupled at segments dividing 1024 (seg 1024 or 128)
    goes to K1b, and an exact factor to K1 (the TPU's 32768 cap was its
    VMEM budget; K1 has none), so no plain scan runs on this path; up to
    32768 rows every factor goes to K1; blocks wider than 32 columns go to
    the same kernels (the 32-column cap was the TPU's too). On CPU tensors
    each wrapper is its plain version, which agrees with the plain
    whole-row scans."""
    calls = []
    for name in ("tridiag_solve", "tridiag_solve_blocked"):
        real = getattr(tt, name)
        monkeypatch.setattr(
            tt, name, lambda *a, _f=real, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
    n = 33000
    d, e, rng = _chain_system(n, 2)
    d32 = torch.as_tensor(d, dtype=torch.float32)
    e32 = torch.as_tensor(e, dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(n, 40)), dtype=torch.float32)
    cases = [(tt.tridiag_ldl_blocked(d32, e32, block=1024), n, 2,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl_blocked(d32, e32, block=128), n, 2,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl(d32, e32), n, 2, "tridiag_solve"),
             (tt.tridiag_ldl_blocked(d32[:3000], e32[:2999], block=1024),
              3000, 2, "tridiag_solve"),
             (tt.tridiag_ldl_blocked(d32, e32, block=1024), n, 40,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl(d32[:3000], e32[:2999]), 3000, 40,
              "tridiag_solve")]
    for f, rows, q, want in cases:
        calls.clear()
        got = tt.tridiag_solve_factored_fast(f, B[:rows, :q])
        assert calls == [want], (f.seg, rows, calls)
        ref = tt.tridiag_solve_factored(f, B[:rows, :q])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)

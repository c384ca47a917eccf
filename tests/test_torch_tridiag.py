"""Parity of the PyTorch port's tridiagonal LDL^T factors and solve (kernel
K1, run here as its plain version) against the JAX package, on the CPU.
Inputs are made from seeds with numpy and handed to both as arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import tridiag as jt
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
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


def test_tridiag_dispatch_refuses_unported_blocked_kernel():
    """n > 32768 with a blocked factor is kernel K1b's, not ported yet: the
    dispatch raises for CUDA tensors rather than run something else; on
    the CPU it runs the plain scans, like the JAX dispatch off the TPU."""
    n = 33000
    d, e, rng = _chain_system(n, 2)
    f = tt.tridiag_ldl_blocked(torch.as_tensor(d, dtype=torch.float32),
                               torch.as_tensor(e, dtype=torch.float32),
                               block=128)
    B = torch.as_tensor(rng.normal(size=(n, 2)), dtype=torch.float32)
    got = tt.tridiag_solve_factored_fast(f, B)
    np.testing.assert_array_equal(got.numpy(),
                                  tt.tridiag_solve_factored(f, B).numpy())

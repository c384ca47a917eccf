"""Whole MAC.solve of the PyTorch port against the JAX package on the CPU
with explicit Frank-Wolfe options: an explicit step count (reference
stopping semantics, duality-gap stop on), a preconditioner refresh period
of 2 (steps >= 8 reuse the carried coarse inverse and chain factor every
other step), and the warm-start cache off."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.solvers import MAC as JMAC
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from mac_tpu_torch.utils.fiedler import scipy_lam2
from tests.test_torch_banded import pose_graph

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


@pytest.mark.parametrize("ctor,solve", [
    (dict(precond_refresh_period=2), dict(max_iters=12)),
    (dict(), dict(max_iters=6, use_cache=False)),
])
def test_solve_options_match_jax(ctor, solve):
    """Same start, same options: equal step counts, relaxed lambda_2
    (scipy referee) within 1e-3 relative, upper bounds within 1e-3
    relative, k edges rounded."""
    idx, w, n = pose_graph(600, 200, 40, 5)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    x_init = NaiveGreedy(cands).subset(k)
    jm = JMAC(fixed, cands, n, use_banded=True, dtype=jnp.float32,
              fw_polish=False, **ctor)
    jm.round_guard = False
    jr, ju, jup = jm.solve(k, x_init, **solve)
    tm = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
             fw_polish=False, round_guard=False, device="cpu", **ctor)
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    tr, tu, tup = tm.solve(k, x_init, **solve)
    assert (tm.last_solve_stats["fw_iterations"]
            == jm.last_solve_stats["fw_iterations"])
    assert not tm.last_solve_stats["tail_averaged"]
    lam_j = scipy_lam2(jm.laplacian(ju))
    lam_t = scipy_lam2(tm.laplacian(tu))
    assert abs(lam_t - lam_j) <= 1e-3 * abs(lam_j), (lam_t, lam_j)
    assert abs(tup - jup) <= 1e-3 * abs(jup), (tup, jup)
    assert tr.sum() == k

"""Whole MAC.solve of the PyTorch port against the JAX package on the CPU
at n = 4500, past the 4096-node gate: the chain smoother runs the blocked
LDL^T factor (128-node segments)."""

from tests.test_torch_mac_exact import check_solve_parity


def test_solve_matches_jax_blocked_factor():
    check_solve_parity(4500, 1500, 40, 3, expect_split=False,
                       expect_blocked=True)

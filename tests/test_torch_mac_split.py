"""Whole MAC.solve of the PyTorch port against the JAX package on the CPU
on a graph whose banded tables take the overflow split (kernel K2b's
tables): n = 1500, 1200 loop closures of span <= 25."""

from tests.test_torch_mac_exact import check_solve_parity


def test_solve_matches_jax_overflow_split():
    check_solve_parity(1500, 1200, 25, 3, expect_split=True,
                       expect_blocked=False)

"""The banded float32 budget sweep of the PyTorch port against the JAX
package's on the CPU at n = 4500, past the 4096-node gate: every lane's
chain smoother runs the blocked LDL^T factor (128-node segments), all
lanes' segments in each step of its loop."""

from tests.test_torch_sweep import check_sweep_parity


def test_float32_sweep_matches_jax_blocked_factor():
    check_sweep_parity(4500, 1500, 40, 3, True, 3, expect_blocked=True)

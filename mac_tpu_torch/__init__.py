"""mac_tpu_torch -- the PyTorch and CUDA port of mac_tpu.

Maximum algebraic connectivity graph sparsification: select K candidate
edges maximizing lambda_2 of the weighted graph Laplacian, by Frank-Wolfe
over the relaxed selection with a warm-started TRACEMIN Fiedler oracle.
The module names mirror mac_tpu's; the hot kernels (the banded Laplacian
assembly and the tridiagonal chain solve, whole-row and segmented) are
hand-written CUDA for Hopper under mac_tpu_torch/csrc/, built with nvcc at
first use. MAC routes an instance by itself: float32 graphs with a narrow
RCM band take the banded operator (small ones with exact float64 host
tails after it), other float32 graphs the matrix-free ELL operator with a
two-grid preconditioner, and small or tiny-gap instances a float64 host
engine (numpy and scipy splu); see mac_tpu_torch.solvers.mac.

    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    mac = MAC(fixed, cands, n)          # on the card; device="cpu" otherwise
    rounded, unrounded, upper = mac.solve(k, x_init)

This package imports torch, numpy and scipy, never JAX.
"""

from mac_tpu_torch.device import configure_numerics
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from mac_tpu_torch.utils.graphs import Edge

configure_numerics()

__version__ = "0.1.0"

__all__ = ["Edge", "MAC", "NaiveGreedy", "__version__"]

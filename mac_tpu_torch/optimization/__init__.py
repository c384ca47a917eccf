"""Frank-Wolfe and its LP oracle; the package exports the names of
mac_tpu.optimization."""

from mac_tpu_torch.optimization.constraints import (solve_box_lp,
                                                    solve_subset_box_lp)
from mac_tpu_torch.optimization.frankwolfe import (frank_wolfe,
                                                   frank_wolfe_with_state,
                                                   naive_stepsize)

__all__ = [
    "frank_wolfe",
    "frank_wolfe_with_state",
    "naive_stepsize",
    "solve_subset_box_lp",
    "solve_box_lp",
]

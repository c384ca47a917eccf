"""Solver layer: the MAC Frank-Wolfe solver and the NaiveGreedy baseline."""

from mac_tpu_torch.solvers.baseline import NaiveGreedy
from mac_tpu_torch.solvers.mac import MAC

__all__ = ["MAC", "NaiveGreedy"]

"""Solver layer: the MAC Frank-Wolfe solver and the baselines NaiveGreedy,
GreedyEig and GreedyESP."""

from mac_tpu_torch.solvers.baseline import NaiveGreedy
from mac_tpu_torch.solvers.greedy_eig import GreedyEig
from mac_tpu_torch.solvers.greedy_esp import GreedyESP
from mac_tpu_torch.solvers.mac import MAC

__all__ = ["GreedyEig", "GreedyESP", "MAC", "NaiveGreedy"]

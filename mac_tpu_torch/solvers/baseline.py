"""NaiveGreedy: select the top-k candidate edges by raw weight (numpy only;
carried over from mac_tpu.solvers.baseline)."""

import numpy as np

from mac_tpu_torch.utils.graphs import edges_to_arrays


class NaiveGreedy:
    def __init__(self, edges):
        _, w = edges_to_arrays(edges)
        self.weights = np.asarray(w)

    def subset(self, k: int) -> np.ndarray:
        k = int(k)
        solution = np.zeros(len(self.weights))
        if k <= 0:
            return solution
        if k >= len(self.weights):
            return np.ones(len(self.weights))
        idx = np.argpartition(self.weights, -k)[-k:]
        solution[idx] = 1.0
        return solution

"""Petersen graph sparsification: MAC vs GreedyEig vs GreedyESP vs Naive
(mac_tpu_torch's counterpart of the JAX package's
examples/petersen_graph_sparsification.py).

Run: python -m mac_tpu_torch.examples.petersen_graph_sparsification [--cpu]
"""

import argparse

import networkx as nx

from mac_tpu_torch.solvers import MAC, GreedyEig, GreedyESP, NaiveGreedy
from mac_tpu_torch.utils.conversions import nx_to_mac


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    device = "cpu" if ap.parse_args(argv).cpu else "cuda"

    graph = nx.petersen_graph()
    spanning_tree = nx.minimum_spanning_tree(graph)
    loop_graph = nx.difference(graph, spanning_tree)
    fixed = nx_to_mac(spanning_tree)
    candidates = nx_to_mac(loop_graph)
    n = graph.number_of_nodes()

    pct = 0.6
    k = int(pct * len(candidates))
    print(f"Petersen: |fixed|={len(fixed)}, |candidates|={len(candidates)}, k={k}")

    mac = MAC(fixed, candidates, n, device=device)

    naive = NaiveGreedy(candidates).subset(k)
    print(f"NaiveGreedy lambda2 = {mac.evaluate_objective(naive):.6f}")

    eig_mask, _ = GreedyEig(fixed, candidates, n, device=device).subset(k)
    print(f"GreedyEig   lambda2 = {mac.evaluate_objective(eig_mask):.6f}")

    esp_mask, _ = GreedyESP(fixed, candidates, n, device=device).subset(k)
    print(f"GreedyESP   lambda2 = {mac.evaluate_objective(esp_mask):.6f}")

    rounded, unrounded, upper = mac.solve(k, naive, max_iters=100)
    print(f"MAC         lambda2 = {mac.evaluate_objective(rounded):.6f}"
          f"  (relaxed {mac.evaluate_objective(unrounded):.6f}, upper {upper:.6f})")


if __name__ == "__main__":
    main()

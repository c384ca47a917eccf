"""Sparsify a random Erdos-Renyi graph with a forced chain, 20% budget,
Madow rounding with best-of-R trials (mac_tpu_torch's counterpart of the JAX
package's examples/random_graph_sparsification.py).

Run: python -m mac_tpu_torch.examples.random_graph_sparsification [--cpu]
"""

import argparse

import networkx as nx

from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.conversions import nx_to_mac
from mac_tpu_torch.utils.graphs import select_edges


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    device = "cpu" if ap.parse_args(argv).cpu else "cuda"

    n = 20
    G = nx.erdos_renyi_graph(n, 0.6, seed=42)
    # Guarantee connectivity of the "fixed" part with a chain.
    for i in range(n - 1):
        G.add_edge(i, i + 1)

    edges = nx_to_mac(G)
    fixed = [e for e in edges if abs(e.i - e.j) == 1]
    candidates = [e for e in edges if abs(e.i - e.j) > 1]

    pct_candidates = 0.2
    k = int(pct_candidates * len(candidates))
    mac = MAC(fixed, candidates, n, device=device)

    rounded, unrounded, upper = mac.solve(
        k,
        rounding="madow",
        random_rounding_max_iters=10,
        max_iters=50,
        use_cache=True,
    )

    print(f"n={n}, |fixed|={len(fixed)}, |candidates|={len(candidates)}, k={k}")
    print(f"lambda2(relaxed)  = {mac.evaluate_objective(unrounded):.6f}")
    print(f"lambda2(rounded)  = {mac.evaluate_objective(rounded):.6f}")
    print(f"dual upper bound  = {upper:.6f}")
    print(f"selected edges    = {select_edges(candidates, rounded)}")


if __name__ == "__main__":
    main()

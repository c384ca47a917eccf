"""Parity of the PyTorch port's GreedyESP (mac_tpu_torch.solvers.greedy_esp)
against the JAX package's, on the CPU in float64: the brute-force oracle
and the lazy budget sweep, a candidate at the pinned node, the scan
selection against the host cores on a chain (closed-form Gram) and on a
non-chain graph (Z by batched PCG), streaming mode against the dense Z on
every selection core, and the solve-vector parity helpers. Every instance
has at most 4096 candidates, where the selections must be identical."""

import networkx as nx
import numpy as np
import pytest
import torch

from chip_smoke import chain_instance
from mac_tpu.solvers.greedy_esp import GreedyESP as JESP
from mac_tpu.utils.graphs import weight_graph_lap_from_edge_list
from mac_tpu_torch.solvers import GreedyESP
from mac_tpu_torch.solvers import greedy_esp as tesp
from mac_tpu_torch.utils.conversions import nx_to_mac
from mac_tpu_torch.utils.graphs import Edge, edges_to_arrays

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def esp(fixed, cands, n, **kw):
    return GreedyESP(fixed, cands, n, device="cpu", **kw)


def chain_plus_loops(n, n_loops, seed):
    """The JAX package's test graph: a path with random weighted loop
    closures, split into (fixed chain, candidates)."""
    rng = np.random.RandomState(seed)
    G = nx.path_graph(n)
    while G.number_of_edges() < n - 1 + n_loops:
        i, j = rng.randint(0, n, 2)
        if abs(int(i) - int(j)) > 1:
            G.add_edge(int(i), int(j))
    for i, j in G.edges():
        G[i][j]["weight"] = 0.5 + rng.rand()
    edges = nx_to_mac(G)
    return ([e for e in edges if abs(e.i - e.j) == 1],
            [e for e in edges if abs(e.i - e.j) > 1])


def brute_force(fixed, cands, n, k):
    """Eager greedy maximum weighted effective resistance by dense solves
    of the reduced Laplacian: the selection mask."""
    L = weight_graph_lap_from_edge_list(fixed, n).toarray()[1:, 1:]
    cand_idx, w = edges_to_arrays(cands)
    result = np.zeros(len(w))

    def a_vec(e):
        a = np.zeros(n - 1)
        if e[0] >= 1:
            a[e[0] - 1] = 1.0
        if e[1] >= 1:
            a[e[1] - 1] = -1.0
        return a

    for _ in range(k):
        scores = np.full(len(w), -np.inf)
        for e in np.flatnonzero(result == 0):
            a = a_vec(cand_idx[e])
            scores[e] = w[e] * (a @ np.linalg.solve(L, a))
        p = int(np.argmax(scores))
        result[p] = 1.0
        a = a_vec(cand_idx[p])
        L = L + w[p] * np.outer(a, a)
    return result


def order_of(selected, cands):
    ids = {id(e): i for i, e in enumerate(cands)}
    return [ids[id(e)] for e in selected]


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_esp_matches_bruteforce_and_jax(seed):
    """Eager and lazy selections equal the brute-force oracle and the JAX
    package's, in the same order; the default dtype is float64."""
    fixed, cands = chain_plus_loops(24, 10, seed)
    oracle = brute_force(fixed, cands, 24, 5)
    t = esp(fixed, cands, 24)
    assert t.dtype == torch.float64 and t._fixed_is_chain
    mask, sel = t.subset(5)
    jmask, jsel = JESP(fixed, cands, 24).subset(5)
    np.testing.assert_array_equal(mask, oracle)
    assert order_of(sel, cands) == order_of(jsel, cands)
    mask_l, sel_l, secs = esp(fixed, cands, 24).subset_lazy(5)
    np.testing.assert_array_equal(mask_l, oracle)
    assert secs >= 0
    mask_z, _ = esp(fixed + [Edge(0, 2, 0.7)], cands, 24).subset(5)
    jmask_z, _ = JESP(fixed + [Edge(0, 2, 0.7)], cands, 24).subset(5)
    np.testing.assert_array_equal(mask_z, jmask_z)


def test_greedy_esp_budget_sweep_monotone():
    """subsets_lazy over budgets 2, 4, 6: nested selections of exactly those
    sizes, the JAX package's, times nondecreasing; a decreasing budget
    list, a zero budget and a budget past m are refused."""
    fixed, cands = chain_plus_loops(20, 8, 3)
    results, selected, times = esp(fixed, cands, 20).subsets_lazy([2, 4, 6])
    jresults, jselected, _ = JESP(fixed, cands, 20).subsets_lazy([2, 4, 6])
    assert [int(r.sum()) for r in results] == [2, 4, 6]
    assert np.all(results[0] <= results[1]) and np.all(
        results[1] <= results[2])
    for r, jr in zip(results, jresults):
        np.testing.assert_array_equal(r, jr)
    assert order_of(selected, cands) == order_of(jselected, cands)
    assert times == sorted(times)
    for ks in ([4, 2], [0, 2], [3, 9]):
        with pytest.raises(ValueError):
            esp(fixed, cands, 20).subsets_lazy(ks)


def test_greedy_esp_edges_touching_pinned_node():
    """Candidates at node 0 (a one-entry reduced incidence vector): the
    oracle's and the JAX package's selection."""
    fixed = [Edge(i, i + 1, 1.0) for i in range(9)]
    cands = [Edge(0, 5, 2.0), Edge(0, 9, 1.0), Edge(2, 7, 1.5)]
    mask, _ = esp(fixed, cands, 10).subset(2)
    np.testing.assert_array_equal(mask, brute_force(fixed, cands, 10, 2))
    np.testing.assert_array_equal(mask, JESP(fixed, cands, 10).subset(2)[0])


@pytest.mark.parametrize("case", ["chain", "z"])
def test_scan_matches_host_cores_and_jax(case):
    """Above SCAN_MIN_WORK the selection is the device scan (here on CPU
    tensors): on a chain (n 900, m 2500, k 840; closed-form Gram) and on a
    non-chain graph (n 700, m 2100, k 960; Z by batched PCG), its order is
    the JAX package's scan order, and its set is that of the port's native
    lazy core and numpy loop (SCAN_MIN_WORK raised) and of the JAX
    package's subset_lazy."""
    if case == "chain":
        fixed, cands = chain_instance(900, 2500, 5)
        n, k = 900, 840
    else:
        fixed, cands = chain_instance(700, 2100, 9, extra=(0, 5, 1.3))
        n, k = 700, 960
    t, j = esp(fixed, cands, n), JESP(fixed, cands, n)
    assert t._fixed_is_chain == (case == "chain")
    order = t._select_scan_device(k)
    assert order is not None and len(set(order.tolist())) == k
    np.testing.assert_array_equal(order, j._select_scan_device(k))
    # The host cores, on the same objects (the Gram source is cached).
    t.SCAN_MIN_WORK = j.SCAN_MIN_WORK = 10 ** 18
    res_native, sel_native, _ = t.subset_lazy(k)
    assert set(np.flatnonzero(res_native)) == set(order.tolist())
    res_numpy, sel_numpy = t.subset(k)
    assert order_of(sel_numpy, cands) == order.tolist()
    np.testing.assert_array_equal(res_native, j.subset_lazy(k)[0])


def test_streaming_matches_dense_z():
    """Streaming mode (z_budget_bytes = 1: Gram entries from one solve per
    committed pivot, never a dense Z) selects what the dense Z selects, on
    the eager, the lazy-sweep and the scan cores, with Z never built and at
    most k cached pivot columns; the dense selection is the JAX
    package's."""
    n, m, k = 500, 300, 12
    fixed, cands = chain_instance(n, m, 11, extra=(0, 5, 1.3))
    dense = esp(fixed, cands, n)
    assert not dense._fixed_is_chain and not dense._z_streaming()
    mask_dense, sel_dense = dense.subset(k)
    jmask, jsel = JESP(fixed, cands, n).subset(k)
    np.testing.assert_array_equal(mask_dense, jmask)
    assert order_of(sel_dense, cands) == order_of(jsel, cands)

    stream = esp(fixed, cands, n, z_budget_bytes=1)
    assert stream._z_streaming()
    mask_s, sel_s = stream.subset(k)
    assert stream._Z is None and len(stream._gcols) <= k
    np.testing.assert_array_equal(mask_s, mask_dense)
    assert order_of(sel_s, cands) == order_of(sel_dense, cands)

    stream2 = esp(fixed, cands, n, z_budget_bytes=1)
    results, _, _ = stream2.subsets_lazy([4, k])
    assert stream2._Z is None and len(stream2._gcols) <= k
    np.testing.assert_array_equal(results[-1], mask_dense)
    assert np.all(results[0] <= results[1]) and results[0].sum() == 4

    stream3 = esp(fixed, cands, n, z_budget_bytes=1)
    stream3.SCAN_MIN_WORK = 1
    order = stream3._select_scan_device(k)
    assert order is not None and stream3._Z is None
    assert order.tolist() == order_of(sel_dense, cands)
    np.testing.assert_allclose(stream3._gram_diag(None), dense._gram_diag(
        dense._compute_Z()), rtol=1e-9)


def test_parity_helpers_match_jax():
    """get_all_xuv's squared row norms (the effective resistances against
    L_S: S empty, and S given as a mask) to rtol 1e-8 of the JAX package's,
    row 0 of each solve zero; S given as candidate indices gives the
    mask's rows; get_best_edge and the module helpers pick the same
    candidate."""
    fixed, cands = chain_instance(80, 30, 13)
    t, j = esp(fixed, cands, 80, chunk=8), JESP(fixed, cands, 80, chunk=8)
    M = [3, 0, 17, 29, 8, 11, 5, 21, 2, 14]
    mask = np.zeros(30)
    mask[[1, 4]] = 1.0
    for selected in (None, mask):
        rows, ids = t.get_all_xuv(M, selected=selected)
        jrows, jids = j.get_all_xuv(M, selected=selected)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose((rows ** 2).sum(1), (jrows ** 2).sum(1),
                                   rtol=1e-8)
        assert not rows[:, 0].any()
    np.testing.assert_allclose(t.get_all_xuv(M, np.array([1, 4]))[0], rows,
                               rtol=1e-12, atol=1e-14)
    assert t.get_best_edge(set(M), mask) == j.get_best_edge(set(M), mask)
    w = t.edge_weights[M]
    np.testing.assert_allclose(
        tesp.compute_weighted_effective_resistances(rows, w),
        (rows ** 2).sum(1) * w)
    assert (tesp.find_idx_with_max_weighted_effective_resistance(rows, w)
            == int(np.argmax((rows ** 2).sum(1) * w)))

"""Parity of the PyTorch port's GreedyEig (mac_tpu_torch.solvers.greedy_eig)
and of its lane-batched trial solve (mac_tpu_torch.utils.fiedler.
fiedler_pair_lanes) against the JAX package's GreedyEig, on the CPU in
float64: the brute-force oracle and the cross-chunk tie on the dense branch
(n <= 256), and an ELL graph (n 300) whose trial chunks run TRACEMIN over
the lanes with the incumbent's shared V-cycle, against the JAX package's
vmapped trial evaluation and the port's per-lane loop. The random block
that seeds TRACEMIN's previous-iterate memory is drawn by JAX and
injected."""

import numpy as np
import jax.numpy as jnp
import torch
from scipy.linalg import eigh

from mac_tpu.solvers.greedy_eig import GreedyEig as JEig
from mac_tpu.utils.graphs import weight_graph_lap_from_edge_list
from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                           split_edges)
from mac_tpu_torch.solvers import GreedyEig
from mac_tpu_torch.solvers.greedy_eig import TRIAL_MIN_ITERS
from mac_tpu_torch.utils.fiedler import (fiedler_pair_lanes,
                                         fiedler_pair_lanes_plain, scipy_lam2)
from mac_tpu_torch.utils.graphs import (Edge, edges_to_arrays,
                                        weight_graph_lap_from_edges)
from tests.test_torch_eigen import jax_xprev
from tests.test_torch_greedy_esp import chain_plus_loops

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def brute_force(fixed, cands, n, k):
    """Greedy argmax of lambda_2 by exact dense eigensolves: the mask."""
    cand_idx, w = edges_to_arrays(cands)
    sol = np.zeros(len(w))
    L0 = weight_graph_lap_from_edge_list(fixed, n).toarray()
    for _ in range(k):
        best, best_l2 = -1, -np.inf
        for e in np.flatnonzero(sol == 0):
            L = L0.copy()
            for t in np.flatnonzero(sol == 1).tolist() + [e]:
                i, j = cand_idx[t]
                a = np.zeros(n)
                a[i], a[j] = 1.0, -1.0
                L += w[t] * np.outer(a, a)
            l2 = np.sort(eigh(L, eigvals_only=True))[1]
            if l2 > best_l2 + 1e-9:
                best, best_l2 = e, l2
        sol[best] = 1.0
    return sol


def ell_instance():
    """n 300 (past the dense branch): a weighted chain and 16 candidates,
    8 spanning more than 50 nodes (the first at node 0) and 8 spanning 2
    or 3. The short ones barely move lambda_2, so with chunk 8 their chunk
    is pruned by its supergradient bound at every step."""
    rng = np.random.RandomState(3)
    n = 300
    fixed = [Edge(i, i + 1, 0.5 + rng.rand()) for i in range(n - 1)]
    cands, seen = [Edge(0, 150, 1.2)], {(0, 150)}
    while len(cands) < 8:
        i, j = sorted(rng.randint(0, n, 2))
        if j - i > 50 and (i, j) not in seen:
            seen.add((i, j))
            cands.append(Edge(int(i), int(j), 0.5 + rng.rand()))
    while len(cands) < 16:
        i = int(rng.randint(0, n - 3))
        j = i + 2 + int(rng.randint(0, 2))
        if (i, j) not in seen:
            seen.add((i, j))
            cands.append(Edge(i, j, 0.5 + rng.rand()))
    return fixed, cands, n


def test_greedy_eig_matches_bruteforce_and_jax():
    """n 12, dense branch (one batched eigh per chunk): the oracle's and
    the JAX package's selection; float64 on the CPU by default."""
    fixed, cands = chain_plus_loops(12, 6, 5)
    g = GreedyEig(fixed, cands, 12, device="cpu")
    assert g.dtype == torch.float64 and g.op.mode == "dense"
    mask, sel = g.subset(3)
    np.testing.assert_array_equal(mask, brute_force(fixed, cands, 12, 3))
    jmask, jsel = JEig(fixed, cands, 12).subset(3)
    np.testing.assert_array_equal(mask, jmask)
    assert sel == jsel


def test_greedy_eig_exact_cross_chunk_tie():
    """Two symmetric candidates with exactly equal lambda_2 in different
    chunks (chunk=1): the lower index wins, in either listing order."""
    fixed = [Edge(i, i + 1, 1.0) for i in range(7)]
    for cands, want in (([Edge(0, 4, 1.0), Edge(3, 7, 1.0)], (0, 4)),
                        ([Edge(3, 7, 1.0), Edge(0, 4, 1.0)], (3, 7))):
        mask, sel = GreedyEig(fixed, cands, 8, chunk=1,
                              device="cpu").subset(1)
        np.testing.assert_array_equal(mask, [1.0, 0.0])
        assert (sel[0].i, sel[0].j) == want
        assert sel == JEig(fixed, cands, 8, chunk=1).subset(1)[1]


def test_dense_lanes_match_per_lane_loop():
    """The dense branch of fiedler_pair_lanes (one batched eigh of the
    trial Laplacians) against fiedler_pair_op per lane: lambda to 1e-12,
    the blocks up to sign."""
    fixed, cands = chain_plus_loops(40, 12, 7)
    g = GreedyEig(fixed, cands, 40, device="cpu")
    x = np.zeros(len(cands))
    x[[2, 5]] = 1.0
    c = torch.tensor([0, 1, 3, 4, 11])
    args = (g.op, g._weights(x), c + g._m_fixed, g._w_cand[c], g._X0)
    got = fiedler_pair_lanes(*args, xprev0=g.xprev0)
    ref = fiedler_pair_lanes_plain(*args, xprev0=g.xprev0)
    np.testing.assert_allclose(got.lam.numpy(), ref.lam.numpy(), rtol=1e-12)
    dots = torch.einsum("rnq,rnq->rq", got.X, ref.X).abs()
    np.testing.assert_allclose(dots.numpy(), 1.0, atol=1e-9)


def test_ell_chunk_matches_jax_and_per_lane_loop():
    """n 300 (ELL, two-grid V-cycle), chunk 8, k 2, float64. The first
    step's first chunk (its candidates best bound first; one of them at
    node 0): the batched lanes' lambda_2 match the JAX package's vmapped
    trial evaluation and the port's per-lane loop (each lane with its own
    weights and preconditioner) to rtol 1e-7, every lane converged; the
    selections equal the JAX package's, and both packages evaluate the
    same chunks (the first of each step, the other pruned)."""
    fixed, cands, n = ell_instance()
    g = GreedyEig(fixed, cands, n, chunk=8, device="cpu")
    assert g.op.mode == "ell"
    g.xprev0 = torch.tensor(jax_xprev(n, 4, jnp.float64))
    j = JEig(fixed, cands, n, chunk=8)
    x = np.zeros(len(cands))
    lam, X = g._eval(x, g._X0)
    grad = g.grad_from_fiedler(X[:, 0].numpy())
    cand = np.argsort(-(float(lam) + grad))[:8]
    assert 0 in cand  # a lane whose candidate touches node 0
    lams, Xs = g._eval_chunk(x, cand, X)
    c = torch.as_tensor(cand)
    args = (g.op, g._weights(x), c + g._m_fixed, g._w_cand[c], X)
    res = fiedler_pair_lanes(*args, xprev0=g.xprev0, tol=g.fiedler_tol,
                             min_iters=TRIAL_MIN_ITERS)
    np.testing.assert_array_equal(res.lam[:, 0].numpy(), lams)
    assert bool((res.iters < 200).all()) and float(res.res.max()) < 1e-8
    xs = np.repeat(x[None, :], len(cand), axis=0)
    xs[np.arange(len(cand)), cand] = 1.0
    jlams, _ = j._eval_batch(jnp.asarray(xs),
                             jnp.asarray(X.numpy()))
    np.testing.assert_allclose(lams, np.asarray(jlams), rtol=1e-7)
    ref = fiedler_pair_lanes_plain(*args, xprev0=g.xprev0,
                                   tol=g.fiedler_tol,
                                   min_iters=TRIAL_MIN_ITERS)
    np.testing.assert_allclose(lams, ref.lam[:, 0].numpy(), rtol=1e-7)
    assert Xs.shape == (8, n, 4)
    print(f"n {n}, first chunk of 8 lanes: batched lambda_2 against the "
          f"JAX vmap {np.abs(lams / np.asarray(jlams) - 1).max():.2e}, "
          f"against the per-lane loop "
          f"{np.abs(lams / ref.lam[:, 0].numpy() - 1).max():.2e} "
          f"(largest relative gap); outer iterations batched "
          f"{res.iters.tolist()}, loop {ref.iters.tolist()}")
    # Record the chunks each package evaluates.
    chunks, jlanes = [], []
    eval_chunk, eval_batch = g._eval_chunk, j._eval_batch
    g._eval_chunk = lambda x, c, X: chunks.append(list(c)) or eval_chunk(
        x, c, X)
    j._eval_batch = lambda xs, X: jlanes.append(xs.shape[0]) or eval_batch(
        xs, X)
    mask, sel = g.subset(2)
    jmask, jsel = j.subset(2)
    np.testing.assert_array_equal(mask, jmask)
    assert sel == jsel
    assert chunks[0] == cand.tolist()
    assert [len(c) for c in chunks] == jlanes == [8, 8]


def test_trial_lanes_leave_the_incumbent_block_in_float32():
    """intel in float32 (the card's dtype), without a floor on the outer
    iterations (the JAX package's vmap semantics): step 1's winner,
    candidate 716 (edge (278, 1446), the best lane of step 1's first chunk
    of 64), solved here as a lane of its own (a lane's result does not
    depend on the other lanes of its chunk), gives the incumbent's block
    for the trial of candidate 429. That lane passes TRACEMIN's float32
    stop test at entry, runs 0 iterations and returns a lambda_2 31% above
    the scipy referee's; with GreedyEig's TRIAL_MIN_ITERS = 1 it iterates
    and lands within 1e-3."""
    meas, n = read_g2o_file("data/intel.g2o")
    fixed, cands = split_edges(rpm_to_mac(meas))
    g = GreedyEig(fixed, cands, n, dtype=torch.float32, device="cpu")
    assert (cands[716].i, cands[716].j) == (278, 1446)
    x = np.zeros(len(cands))
    _, X = g._eval(x, g._X0)
    c = torch.tensor([716])
    X1 = fiedler_pair_lanes(g.op, g._weights(x), c + g._m_fixed,
                            g._w_cand[c], X, xprev0=g.xprev0,
                            tol=g.fiedler_tol).X[0].contiguous()
    x[716] = 1.0
    c = torch.tensor([429])
    bare = fiedler_pair_lanes(g.op, g._weights(x), c + g._m_fixed,
                              g._w_cand[c], X1, xprev0=g.xprev0,
                              tol=g.fiedler_tol)
    lam_g, _ = g._eval_chunk(x, np.array([429]), X1)
    sel = [716, 429]
    idx = np.concatenate([[[e.i, e.j] for e in fixed],
                          [[cands[i].i, cands[i].j] for i in sel]])
    w = np.concatenate([[e.weight for e in fixed],
                        [cands[i].weight for i in sel]])
    ref = scipy_lam2(weight_graph_lap_from_edges(idx, w, n))
    print(f"intel step 2, candidate 429: lambda_2 without a floor "
          f"{float(bare.lam[0, 0]):.8g} ({int(bare.iters[0])} iterations), "
          f"GreedyEig's {float(lam_g[0]):.8g}, scipy referee {ref:.8g}")
    assert int(bare.iters[0]) == 0
    assert float(bare.lam[0, 0]) > 1.3 * ref
    assert abs(float(lam_g[0]) - ref) < 1e-3 * ref

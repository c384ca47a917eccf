"""The sharded pieces of the PyTorch port (mac_tpu_torch.parallel.sharded),
on 4 gloo ranks, against the JAX package's (mac_tpu.parallel.sharded) on 4
of the 8 virtual CPU devices the root conftest.py provides, from the same
numpy inputs: the row and edge shards' tables bitwise, their float64
products at rtol 1e-12, the candidate gradient exactly, and the two-stage
top-k indicator for k in {1, 7, m - 1, m}, with and without exact ties,
equal to the JAX package's and to solve_subset_box_lp. The port's side runs
once per module (tests.test_torch_mac_mesh.rank_parity)."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu.ops.laplacian import build_operator as jax_build_operator
from mac_tpu.ops.laplacian import lap_apply as jax_lap_apply
from mac_tpu.parallel import sharded as jsh
from mac_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.parallel.launch import spawn
from mac_tpu_torch.parallel.sharded import edge_shard_tables
from tests.test_torch_mac_mesh import (DEADLINE_S, chain_plus_loops,
                                       rank_parity)

torch.set_num_threads(1)

G = 4
M = 123  # the score vector's length: not a multiple of the group size


def graph(n, n_loops, seed):
    """(idx, w, n, V, v): every edge of a chain plus loops, float64 weights,
    a (n, 4) block and a vector, from seed."""
    (fi, fw), (ci, cw), n = chain_plus_loops(n, n_loops, seed)
    rng = np.random.RandomState(seed + 100)
    return (np.concatenate([fi, ci]).astype(np.int64),
            np.concatenate([fw, cw]), n, rng.randn(n, 4), rng.randn(n))


# n = 101 and 97 are not multiples of the group size (padding rows).
GRAPHS = {"n101": graph(101, 30, 0), "n97": graph(97, 41, 5)}
SCORES = {"distinct": np.random.RandomState(4).randn(M),
          "ties": np.random.RandomState(6).randint(0, 4, M).astype(float)}
KS = (1, 7, M - 1, M)  # the port's ranks compute every k for both vectors


@pytest.fixture(scope="module")
def started():
    """The port's side on G ranks, started in the background while this
    process computes the JAX package's side: a future of spawn's result."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, rank_parity, G, device_type="cpu",
                          timeout_s=DEADLINE_S, args=(GRAPHS, SCORES, KS))


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(n_graph=G, n_sweep=1)


def jax_operator(name):
    idx, _, n, _, _ = GRAPHS[name]
    return jax_build_operator(idx, n, mode="ell")


@pytest.mark.parametrize("kind", ["row", "edge"])
@pytest.mark.parametrize("name", GRAPHS)
def test_products_match_jax(started, jax_mesh, name, kind):
    """Both sharded products, float64, rtol 1e-12 of the JAX package's
    sharded product and of its meshless lap_apply; every rank the same."""
    _, w, _, V, _ = GRAPHS[name]
    op = jax_operator(name)
    cls = jsh.ShardedLaplacian if kind == "row" else jsh.EdgeShardedLaplacian
    ref = np.asarray(cls(op, jax_mesh).apply(jnp.asarray(w), jnp.asarray(V)))
    plain = np.asarray(jax_lap_apply(op, jnp.asarray(w), jnp.asarray(V)))
    port = started.result()
    got = port[0][name][f"{kind}_product"]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, plain, rtol=1e-12, atol=1e-12)
    for res in port[1:]:
        np.testing.assert_array_equal(res[name][f"{kind}_product"], got)


@pytest.mark.parametrize("name", GRAPHS)
def test_row_shard_tables_bitwise(started, jax_mesh, name):
    ref = jsh.ShardedLaplacian(jax_operator(name), jax_mesh)
    nbr, eid = np.asarray(ref.nbr_tbl), np.asarray(ref.eid_tbl)
    for r, res in enumerate(started.result()):
        mine_nbr, mine_eid = res[name]["row_tables"]
        rows = slice(r * ref.blk, (r + 1) * ref.blk)
        np.testing.assert_array_equal(mine_nbr, nbr[rows])
        np.testing.assert_array_equal(mine_eid, eid[rows])


@pytest.mark.parametrize("name", GRAPHS)
def test_edge_shard_tables_bitwise(started, jax_mesh, name):
    ref = jsh.EdgeShardedLaplacian(jax_operator(name), jax_mesh)
    nbr, eid = np.asarray(ref.nbr_tbl), np.asarray(ref.eid_tbl)
    idx, _, n, _, _ = GRAPHS[name]
    host_nbr, host_eid = edge_shard_tables(idx, n, G)
    np.testing.assert_array_equal(host_nbr, nbr)
    np.testing.assert_array_equal(host_eid, eid)
    for r, res in enumerate(started.result()):
        np.testing.assert_array_equal(res[name]["edge_tables"][0], nbr[r])
        np.testing.assert_array_equal(res[name]["edge_tables"][1], eid[r])


@pytest.mark.parametrize("name", GRAPHS)
def test_degrees_of_both_shardings(started, name):
    idx, w, n, _, _ = GRAPHS[name]
    deg = np.zeros(n)
    np.add.at(deg, idx[:, 0], w)
    np.add.at(deg, idx[:, 1], w)
    rows, edges = started.result()[0][name]["degrees"]
    np.testing.assert_allclose(rows, deg, rtol=1e-14)
    np.testing.assert_allclose(edges, deg, rtol=1e-14)


@pytest.mark.parametrize("name", GRAPHS)
def test_candidate_gradient_exact(started, jax_mesh, name):
    idx, w, _, _, v = GRAPHS[name]
    ref = np.asarray(jsh.sharded_candidate_gradient(
        jax_mesh, idx, jnp.asarray(w), jnp.asarray(v)))
    for res in started.result():
        np.testing.assert_array_equal(res[name]["gradient"], ref)


@pytest.mark.parametrize("scores,k", [("distinct", k) for k in KS]
                         + [("ties", 7), ("ties", M - 1)])
def test_top_k_indicator(started, jax_mesh, scores, k):
    """The two-stage top-k equals the JAX package's and the meshless
    oracle's indicator, ties to the lower index, on every rank."""
    s = SCORES[scores]
    ref = np.asarray(jsh.sharded_top_k_indicator(jax_mesh, jnp.asarray(s),
                                                 k))
    plain = solve_subset_box_lp(torch.as_tensor(s), k).numpy()
    np.testing.assert_array_equal(ref, plain)
    for res in started.result():
        np.testing.assert_array_equal(res[scores][k], plain)

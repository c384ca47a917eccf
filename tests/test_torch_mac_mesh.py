"""MAC on a device mesh (mac_tpu_torch.parallel) against the meshless port,
on gloo ranks on the CPU: the counterparts of the JAX package's
tests/parallel/test_sharded.py solves, on 2 ranks, on a 2 x 2 mesh and on 4
ranks (an ELL solve with node rows and with edges, the budget sweep over
'sweep', the banded operator with its block rows through K2/K2b's plain
version, n = 10000), every rank's outputs bitwise the same, a rank whose
share of the coarse matrix is one ulp off, the mesh's dry run, and the
launcher's and make_mesh's refusals.

Each group of ranks is started once per module (a fixture) and runs every
case of its mesh; the tests read their case. The rank functions live here,
in a module that imports neither JAX nor the JAX package, because every
rank imports the module of its function (tests/test_torch_parallel.py uses
them too)."""

import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.parallel import sharded
from mac_tpu_torch.parallel.launch import dryrun_multigpu, spawn
from mac_tpu_torch.parallel.mesh import make_mesh
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.fiedler import scipy_lam2

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
# A spawned group's deadline: far above its run (a few seconds to tens),
# far below the suite's limit.
DEADLINE_S = 300.0
HANG_DEADLINE_S = 30.0


def chain_plus_loops(n, n_loops, seed=0):
    """A path 0-1-...-(n-1) (the fixed edges) and n_loops distinct loop
    closures |i - j| > 1 (the candidates), weights 0.5 + U[0, 1)."""
    rng = np.random.RandomState(seed)
    fixed = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    loops = set()
    while len(loops) < n_loops:
        i, j = (int(v) for v in rng.randint(0, n, 2))
        if abs(i - j) > 1:
            loops.add((min(i, j), max(i, j)))
    cands = np.array(sorted(loops))
    return ((fixed, 0.5 + rng.rand(n - 1)),
            (cands, 0.5 + rng.rand(n_loops)), n)


# The cases: (graph, MAC knobs, k, solve knobs). Every collective costs
# the gloo ranks milliseconds here, so the eigensolves are capped; the
# graphs of the ELL cases have n > DENSE_MAX_N, so that the meshless solve
# runs the same TRACEMIN on the ELL operator.
CAPPED = dict(F64, fiedler_maxiter=10, fiedler_inner_iters=4)
ELL = (chain_plus_loops(300, 100, seed=13), CAPPED, 40, dict(max_iters=3))
SWEEP = (chain_plus_loops(300, 100, seed=11), CAPPED, [10, 20, 30, 40],
         dict(max_iters=3))
BANDED = (chain_plus_loops(640, 200, seed=15),
          dict(use_banded=True, dtype=torch.float32, fiedler_maxiter=20),
          100, dict(max_iters=6))
# The banded operator in float64 with LOBPCG or the dense eigh.
BANDED64 = (BANDED[0], dict(use_banded=True, fiedler_maxiter=10, **F64), 100,
            dict(max_iters=2))
BIG = (chain_plus_loops(10_000, 2_000, seed=11),
       dict(F64, fiedler_maxiter=20, fiedler_inner_iters=6), 1000,
       dict(max_iters=3))


def banded_graph(n=700, n_loops=260, span=40, seed=3):
    """An odometry chain plus short-range loop closures (banded after RCM)
    and its edge weights, float64."""
    rng = np.random.RandomState(seed)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([np.stack([np.arange(n - 1), np.arange(1, n)], 1),
                          np.array(sorted(loops))])
    return idx, torch.as_tensor(0.5 + rng.rand(len(idx))), n


def bjacobi_block():
    """The block the block-Jacobi preconditioner is applied to."""
    return torch.as_tensor(np.random.RandomState(5).normal(size=(700, 4)))


def bjacobi_sharded(mesh):
    """The block-Jacobi preconditioner under sharded= (its diagonal blocks
    all-gathered from each rank's own rows) at n = 700 in float64, both
    cycle forms: M(B) of bjacobi_block()."""
    idx, w, n = banded_graph()
    sh = sharded.ShardedBanded(tb.build_banded_rcm(idx, n)[0], mesh)
    BD = sh.assemble(w)
    return [tb.make_banded_precond(sh.bop, BD, smoother="bjacobi", kind=kind,
                                   sharded=sh)(bjacobi_block()).numpy()
            for kind in ("mult", "additive")]


def x_init(mac, k):
    return np.full(len(mac.weights), k / len(mac.weights))


def mesh_solve(mesh, case, **kw):
    (fixed, cands, n), knobs, k, solve_kw = case
    mac = MAC(fixed, cands, n, mesh=mesh, **knobs, **kw)
    return mac.solve(k, x_init(mac, k), **solve_kw)


BANDED_KS = [50, 100]  # the banded budget sweep's (3 steps)


def sliced_ut(mesh, case):
    """The rank's ut rows [h0, b1) from its sliced tables, and the same
    rows of the whole operator's assembly, at the mid-box weights."""
    (fixed, cands, n), _, _, _ = case
    idx = np.concatenate([fixed[0], cands[0]])
    bop, _ = tb.build_banded_rcm(idx, n)
    sh = sharded.ShardedBanded(bop, mesh)
    w = torch.as_tensor(np.concatenate([fixed[1], 0.5 * cands[1]]),
                        dtype=torch.float32)
    whole = tb.assemble_bd(bop, w).ut[:, sh.h0:sh.b1]
    return sh.assemble(w).ut.numpy(), whole.numpy(), (sh.b0, sh.b1, sh.h0)


def rank_two(rank, world):
    """The 2-rank cases: ELL rows and edges, banded (a solve and a sweep
    of 2 budgets; float64 solves by LOBPCG and by the dense eigh), the
    sliced ut rows, the block-Jacobi preconditioner, and the ELL solve with
    rank 1's share of the coarse matrix one ulp off."""
    mesh = make_mesh(device_type="cpu")
    (fixed, cands, n), knobs, _, _ = BANDED
    out = {"rows": mesh_solve(mesh, ELL),
           "edges": mesh_solve(mesh, ELL, mesh_apply="edges"),
           "banded": mesh_solve(mesh, BANDED),
           "banded_sweep": MAC(fixed, cands, n, mesh=mesh, **knobs
                               ).solve_sweep(BANDED_KS, max_iters=3),
           "ut": sliced_ut(mesh, BANDED),
           "bjacobi": bjacobi_sharded(mesh)}
    for method in ("lobpcg", "dense"):
        out[f"banded64_{method}"] = mesh_solve(mesh, BANDED64,
                                               fiedler_method=method)
    plain = sharded.coarse_laplacian

    def off_by_one_ulp(op, w):
        Lc = plain(op, w)
        if rank == 1:
            Lc[..., 0, 0] = torch.nextafter(Lc[..., 0, 0],
                                            torch.tensor(np.inf,
                                                         dtype=Lc.dtype))
        return Lc

    sharded.coarse_laplacian = off_by_one_ulp
    try:
        out["perturbed"] = mesh_solve(mesh, ELL)
    finally:
        sharded.coarse_laplacian = plain
    return out


def rank_four(rank, world):
    """The 4-rank cases: ELL rows and edges and the sweep on a 2 x 2 mesh,
    the n = 10000 solve on 1 x 4, then the dry run on this group."""
    mesh = make_mesh(n_graph=2, n_sweep=2, device_type="cpu")
    (fixed, cands, n), knobs, ks, solve_kw = SWEEP
    mac = MAC(fixed, cands, n, mesh=mesh, **knobs)
    out = {"rows2x2": mesh_solve(mesh, ELL),
           "edges2x2": mesh_solve(mesh, ELL, mesh_apply="edges"),
           "sweep": mac.solve_sweep(ks, **solve_kw)}
    out["big"] = mesh_solve(make_mesh(n_graph=4, device_type="cpu"), BIG)
    out["dryrun"] = dryrun_multigpu(world, device_type="cpu")
    return out


def rank_parity(rank, world, graphs, scores, ks):
    """The sharded pieces on a 1 x world mesh, for
    tests/test_torch_parallel.py: for each graph (idx, w, n, V, v) the row
    and edge shards' tables and float64 products, and the candidate
    gradient; for each score vector the top-k indicator of each k."""
    from mac_tpu_torch.ops.laplacian import build_operator

    mesh = make_mesh(device_type="cpu")
    out = {}
    for name, (idx, w, n, V, v) in graphs.items():
        op = build_operator(idx, n, mode="ell")
        rows = sharded.ShardedLaplacian(op, mesh)
        edges = sharded.EdgeShardedLaplacian(op, mesh)
        w, V, v = (torch.as_tensor(a) for a in (w, V, v))
        out[name] = {
            "row_tables": (rows.nbr_tbl.numpy(), rows.eid_tbl.numpy()),
            "edge_tables": (edges.nbr_tbl.numpy(), edges.eid_tbl.numpy()),
            "row_product": rows.apply(w, V).numpy(),
            "edge_product": edges.apply(w, V).numpy(),
            "degrees": (rows.degrees(w).numpy(), edges.degrees(w).numpy()),
            "gradient": sharded.sharded_candidate_gradient(
                mesh, idx, w, v).numpy()}
    for name, s in scores.items():
        out[name] = {k: sharded.sharded_top_k_indicator(
            mesh, torch.as_tensor(s), k).numpy() for k in ks}
    return out


def rank_raise(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def rank_hang(rank, world):
    if rank == 0:
        time.sleep(3600)  # never reaches the barrier
    dist.barrier()
    return rank


@pytest.fixture(scope="module")
def groups():
    """Every group of ranks of this module, started at once (the ranks
    wait on their collectives far more than they compute, and this process
    solves the meshless cases meanwhile): futures of spawn's results."""
    with ThreadPoolExecutor(4) as pool:
        yield {
            "two": pool.submit(spawn, rank_two, 2, device_type="cpu",
                               timeout_s=DEADLINE_S),
            "four": pool.submit(spawn, rank_four, 4, device_type="cpu",
                                timeout_s=DEADLINE_S),
            "raise": pool.submit(spawn, rank_raise, 2, device_type="cpu",
                                 timeout_s=DEADLINE_S),
            "hang": pool.submit(spawn, rank_hang, 2, device_type="cpu",
                                timeout_s=HANG_DEADLINE_S)}


@pytest.fixture(scope="module")
def two(groups):
    return groups["two"].result()


@pytest.fixture(scope="module")
def four(groups):
    return groups["four"].result()


def meshless(case, **kw):
    (fixed, cands, n), knobs, k, solve_kw = case
    mac = MAC(fixed, cands, n, device="cpu", fiedler_backend="device",
              **knobs, **kw)
    return mac, mac.solve(k, x_init(mac, k), **solve_kw)


@pytest.fixture(scope="module")
def ell_meshless(groups):
    mac, out = meshless(ELL)
    assert mac.op.mode == "ell"
    return mac, out


@pytest.fixture(scope="module")
def banded_meshless(groups):
    return meshless(BANDED, fw_polish=False)


@pytest.fixture(scope="module")
def big_meshless(groups):
    return meshless(BIG)


def lam2(mac, x):
    """The relaxed objective by the float64 scipy referee."""
    return scipy_lam2(mac.laplacian(x))


def same_everywhere(results, key):
    for got in results[1:]:
        for a, b in zip(results[0][key], got[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_banded_mesh_matches_meshless(banded_meshless, two):
    """Banded float32 at n = 640 on 2 ranks (block rows, K2/K2b's plain
    version on each rank's slice) against the meshless banded solve with
    fw_polish=False: relaxed objective rtol 1e-4."""
    mac, (_, x2, _) = banded_meshless
    assert mac._banded is not None
    r1, x1, _ = two[0]["banded"]
    np.testing.assert_allclose(lam2(mac, x1), lam2(mac, x2), rtol=1e-4)
    assert int(r1.sum()) == BANDED[2]
    same_everywhere(two, "banded")


@pytest.mark.parametrize("method", ["lobpcg", "dense"])
def test_banded_f64_methods_on_mesh_match_meshless(two, method):
    """The banded operator in float64 on 2 ranks with LOBPCG (the sharded
    products inside its PCG preconditioner) and with the dense eigh (each
    rank's rows of L(w), summed by one all-reduce) against the meshless
    solve: relaxed objective and bound rtol 1e-8, the same rounding, every
    rank the same arrays."""
    mac, (r2, x2, u2) = meshless(BANDED64, fiedler_method=method)
    assert mac._banded is not None and not mac.fw_polish
    r1, x1, u1 = two[0][f"banded64_{method}"]
    np.testing.assert_allclose(lam2(mac, x1), lam2(mac, x2), rtol=1e-8)
    np.testing.assert_allclose(u1, u2, rtol=1e-8)
    np.testing.assert_array_equal(r1, r2)
    same_everywhere(two, f"banded64_{method}")


def test_big_solve_on_4_ranks_matches_meshless(big_meshless, four):
    """n = 10000 ELL on 4 ranks (the eigensolver capped at 20 outer and 6
    inner iterations, 3 Frank-Wolfe steps): relaxed objective and bound
    rtol 1e-5 of the meshless solve's."""
    mac, (_, x2, u2) = big_meshless
    _, x1, u1 = four[0]["big"]
    np.testing.assert_allclose(lam2(mac, x1), lam2(mac, x2), rtol=1e-5)
    np.testing.assert_allclose(u1, u2, rtol=1e-5)
    same_everywhere(four, "big")


@pytest.mark.parametrize("ranks,key", [("two", "rows"), ("two", "edges"),
                                       ("four", "rows2x2"),
                                       ("four", "edges2x2")])
def test_ell_solve_matches_meshless(request, ell_meshless, ranks, key):
    """Float64 ELL solve on the mesh (row or edge shards) against the
    meshless port solve: relaxed objective and bound rtol 1e-8, the same
    rounded selection, every rank the same arrays."""
    results = request.getfixturevalue(ranks)
    mac, (r2, x2, u2) = ell_meshless
    r1, x1, u1 = results[0][key]
    np.testing.assert_allclose(lam2(mac, x1), lam2(mac, x2), rtol=1e-8)
    np.testing.assert_allclose(u1, u2, rtol=1e-8)
    np.testing.assert_array_equal(r1, r2)
    same_everywhere(results, key)


def test_sweep_on_2x2_matches_meshless(four):
    """solve_sweep with its 4 budgets split over 'sweep' (2 lanes per
    coordinate, products over 'graph'): upper bounds and each lane's
    relaxed objective rtol 1e-8 of the meshless sweep's, k edges rounded
    per lane."""
    (fixed, cands, n), knobs, ks, solve_kw = SWEEP
    mac = MAC(fixed, cands, n, device="cpu", **knobs)
    _, x2, u2 = mac.solve_sweep(ks, **solve_kw)
    r1, x1, u1 = four[0]["sweep"]
    np.testing.assert_allclose(u1, u2, rtol=1e-8)
    for a, b in zip(x1, x2):
        np.testing.assert_allclose(lam2(mac, a), lam2(mac, b), rtol=1e-8)
    assert [int(v) for v in r1.sum(axis=1)] == ks
    same_everywhere(four, "sweep")


def test_banded_sweep_on_mesh_matches_meshless(two):
    """The banded operator's lanes on 2 ranks (each lane's ut rows, its
    coarse share summed per lane): 2 budgets, 3 steps, each lane's relaxed
    objective rtol 1e-4 of the meshless sweep's, k edges per lane."""
    (fixed, cands, n), knobs, _, _ = BANDED
    mac = MAC(fixed, cands, n, device="cpu", **knobs)
    _, x2, _ = mac.solve_sweep(BANDED_KS, max_iters=3)
    r1, x1, _ = two[0]["banded_sweep"]
    for a, b in zip(x1, x2):
        np.testing.assert_allclose(lam2(mac, a), lam2(mac, b), rtol=1e-4)
    assert [int(v) for v in r1.sum(axis=1)] == BANDED_KS
    same_everywhere(two, "banded_sweep")


def test_bjacobi_precond_on_mesh_matches_meshless(two):
    """The block-Jacobi preconditioner under sharded= on 2 ranks (both
    cycle forms, n = 700, float64): every rank's M(B) bitwise the same and
    within 1e-12 of max |M(B)| of the meshless call."""
    same_everywhere(two, "bjacobi")
    idx, w, n = banded_graph()
    bop = tb.build_banded_rcm(idx, n)[0]
    BD = tb.assemble_bd(bop, w)
    for kind, got in zip(("mult", "additive"), two[0]["bjacobi"]):
        ref = tb.make_banded_precond(bop, BD, smoother="bjacobi",
                                     kind=kind)(bjacobi_block()).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


def test_banded_sliced_ut_rows_bitwise(two):
    """Each rank's ut, assembled from its slice of the slot tables, equals
    the same block rows of the whole assembly bitwise; rank 0 starts at
    block 0 and rank 1's halo reaches above its own rows."""
    for res in two:
        mine, whole, (b0, b1, h0) = res["ut"]
        np.testing.assert_array_equal(mine, whole)
        assert mine.shape[1] == b1 - h0
    assert two[0]["ut"][2][0] == 0
    b0, _, h0 = two[1]["ut"][2]
    assert 0 < h0 < b0


def test_perturbed_rank_agrees(two, ell_meshless):
    """Rank 1's share of the coarse matrix is one ulp off in every V-cycle
    (as a card's atomics may leave it): the ranks still build one coarse
    matrix (its shares are summed by an all-reduce), the solve ends on both
    with the same arrays, close to the meshless solve."""
    mac, (_, x2, _) = ell_meshless
    same_everywhere(two, "perturbed")
    _, x1, _ = two[0]["perturbed"]
    np.testing.assert_allclose(lam2(mac, x1), lam2(mac, x2), rtol=1e-6)


def test_dryrun_multigpu_on_four_cpu_ranks(four):
    """dryrun_multigpu(4, device_type="cpu") runs to its end on a 2 x 2
    mesh: one lane step with lambda_2 > 0, a capped solve, the sweep, the
    banded solve."""
    summary = four[0]["dryrun"]
    assert summary["mesh"] == (2, 2) and summary["banded_n"] == 640
    assert all(v > 0 for v in summary["lambda2"])
    assert all(res["dryrun"] == summary for res in four)


def test_spawn_raises_on_a_failed_rank(groups):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        groups["raise"].result()


def test_spawn_stops_a_hang_at_its_deadline(groups):
    """Rank 0 never reaches the barrier rank 1 waits in: the deadline
    stops both and raises, well before DEADLINE_S."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        groups["hang"].result()
    assert time.monotonic() - t0 < DEADLINE_S


@pytest.fixture
def one_rank_group():
    """A started gloo process group of one rank in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")


def test_make_mesh_cuda_needs_a_gpu_per_rank(one_rank_group):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU for rank 0")
    with pytest.raises(RuntimeError, match="no GPU of its own"):
        make_mesh(device_type="cuda")


def test_placements_and_padding(one_rank_group):
    """The three placements of the JAX package's sharding helpers, as
    torch.distributed.tensor placements over ("sweep", "graph"), and
    pad_to_multiple."""
    from torch.distributed.tensor import Replicate, Shard

    from mac_tpu_torch.parallel.mesh import (pad_to_multiple, replicated,
                                             row_sharded, sweep_sharded)

    mesh = make_mesh(device_type="cpu")
    assert replicated(mesh) == (Replicate(), Replicate())
    assert row_sharded(mesh) == (Replicate(), Shard(0))
    assert sweep_sharded(mesh) == (Shard(0), Replicate())
    padded, size = pad_to_multiple(np.arange(10).reshape(5, 2), 4, fill=-1)
    assert size == 5 and padded.shape == (8, 2) and (padded[5:] == -1).all()
    same, size = pad_to_multiple(np.arange(8), 4)
    assert size == 8 and same.shape == (8,)


def test_mac_on_a_mesh_needs_its_process_group(one_rank_group):
    (fixed, cands, n), knobs, _, _ = ELL
    mesh = make_mesh(device_type="cpu")
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        MAC(fixed, cands, n, mesh=mesh, **knobs)

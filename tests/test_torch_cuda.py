"""The hand-written CUDA kernels of the PyTorch port on the card: each against
its plain PyTorch version (float32, and the float64 instantiations at
rtol/atol 1e-10, K2/K2b bitwise), the wrappers' input checks, a banded solve
that goes through K1 and K2 and a matrix-free one that goes through K1b, the
banded float64 route and LOBPCG / dense eigh on the banded operator, and the
baselines on the card (GreedyEig's lane-batched trial chunk through K1,
GreedyESP's scan), and the chain factor's kernels K3 (exact, against its
plain doubling scan within 1e-13 relative in float64 and one float32
ulp) and K3b (segment-decoupled, bitwise), the banded preconditioner's
block-Jacobi and additive variants against their CPU calls, and the
eigensolver's inner solve replayed as a CUDA graph against the eager loop
(bitwise, across weight vectors, with the launch counts), and the
Rayleigh-Ritz eigensolver K4 at every order up to 32 and on batches that
leave its last block partial, its cluster body K4w past 32 (both storage
forms, bitwise equal, at and past the shared-memory edge; its phase
stamps; a replayed solve at q = 11), with
TRACEMIN's lanes (GreedyEig's trial chunk, the budget sweep) launching it
once a lane batch and never calling torch.linalg.eigh, and TRACEMIN's
inner CG step's kernels: K5 (the banded product in its forms), K6 (the
PCG update's passes and sums), K1p (K1's permuted entry: its cluster
body bitwise K1 on the gathered input, its segment body bitwise K1b) and
K7 (the coarse correction) against their plain
versions, bitwise repeatable, and a replayed city10000 inner solve in at
most 16 device kernels a CG step; the matrix-free route's K8 (the ELL
product in its forms over the slot-major tables, on graphs whose warps
walk to dmax and on chains, its dots bitwise their order's model, a
replayed graph bitwise the eager call), its
V-cycle's kernels (EllVCycle) against its plain form, and a replayed
n = 100000 inner solve bitwise the eager one in ELL_STEP_KERNELS device
kernels a CG step; and the Frank-Wolfe step's K9 (the supergradient and
the top-k oracle) and K10 (bound, stop test, tail average, step, next
weights) against their plain versions (bitwise; u and ||g|| to rounding),
NaN first, a replayed graph of the pair bitwise the eager pair, their
refusals, and a replayed warm solve with the loop on the device bitwise
the host loop's, on a banded and a matrix-free graph, with and without a
stop that fires. Marked `cuda`;
each test skips when no CUDA device is present. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import k1_whole_row_limit
from mac_tpu_torch.ops import banded
from mac_tpu_torch.ops.kernels import ldl
from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
                                               tridiag_solve_blocked,
                                               tridiag_solve_blocked_plain,
                                               tridiag_solve_permuted,
                                               tridiag_solve_plain)
from mac_tpu_torch.ops.tridiag import (tridiag_ldl, tridiag_ldl_blocked,
                                       tridiag_solve_factored_fast)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _graph(n, n_loops, span, seed):
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


def _chain(n, seed, dev):
    rng = np.random.RandomState(seed)
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    return (torch.as_tensor(d, dtype=torch.float32, device=dev),
            torch.as_tensor(e, dtype=torch.float32, device=dev), rng)


# Where K1's cluster splits the rows raggedly (fewer rows than blocks, than
# the blocks' first warps, spans not a multiple of 4) at one to 40 columns
# (past 8, columns run in passes), exact factors too large for the
# cluster's shared memory (the tiled two-pass branch), and blocks wider
# than one launch's 128 columns (launches on column groups at row stride q;
# (5000, 200) also tiles).
_K1_EDGES = [(n, q, False) for n in (1, 2, 3, 31, 100, 255, 257, 1001, 10001)
             for q in (1, 3, 4, 5, 40) if (n, q) != (1, 1)]
_K1_TILED = [(33000, 40, False), (100000, 4, False)]
_K1_WIDE = [(1001, 130, False), (5000, 200, False)]


@pytest.mark.parametrize("n,q,blocked", [
    (1, 1, False), (5, 3, False), (777, 4, False), (4000, 4, False),
    (10000, 4, True), (32768, 32, True), (1500, 17, True)]
    + _K1_EDGES + _K1_TILED + _K1_WIDE)
def test_tridiag_kernel_matches_plain(dev, n, q, blocked):
    """K1 against its plain version at rtol/atol 2e-4, for ragged n, one to
    200 right-hand sides, exact and segment-decoupled factors, at the edges
    of the cluster's row split, on its tiled branch and past one launch's
    columns."""
    d, e, rng = _chain(max(n, 2), n, dev)
    d, e = d[:n], e[:n - 1]
    f = (tridiag_ldl_blocked(d, e, block=128) if blocked
         else tridiag_ldl(d, e))
    B = torch.as_tensor(rng.normal(size=(n, q)), dtype=torch.float32,
                        device=dev)
    before = tridiag_solve.launches
    got = tridiag_solve(f.dp, f.l, B)
    ref = tridiag_solve_plain(f.dp, f.l, B)
    torch.cuda.synchronize()
    assert tridiag_solve.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


# K1b's branches: one to 130 right-hand sides (q % 4 != 0 takes the scalar
# loads, q > 4 several column groups), segment lengths passed explicitly
# (1024, 256, 128, and 96, which the rows of a thread do not divide evenly
# into warps), ragged last segments (n 1, 1025), and a right-hand side whose
# storage is 4 bytes off a 16-byte boundary (the scalar loads at q % 4 == 0).
_K1B_CASES = [
    (1, 1, 1024, 1024, False), (1000, 3, 1024, 1024, False),
    (1024, 4, 1024, 1024, False), (1025, 5, 1024, 1024, False),
    (40000, 8, 1024, 1024, False), (40000, 32, 1024, 1024, False),
    (100000, 4, 1024, 1024, False), (33000, 2, 128, 1024, False),
    (40000, 16, None, 1024, False), (5000, 1, None, 1024, False),
    (1025, 1, 1024, 1024, False), (1025, 4, 1024, 1024, False),
    (40000, 40, 1024, 1024, False), (5000, 130, 1024, 1024, False),
    (33000, 4, 128, 128, False), (33000, 5, 128, 128, False),
    (1025, 4, 256, 256, False), (40000, 3, 256, 256, False),
    (1, 4, 128, 128, False), (1000, 4, None, 96, False),
    (100000, 4, 1024, 1024, True), (1025, 8, 256, 256, True)]


@pytest.mark.parametrize("n,q,seg,block,misaligned", _K1B_CASES)
def test_blocked_tridiag_kernel_matches_plain(dev, n, q, seg, block,
                                              misaligned):
    """K1b against its plain version at rtol/atol 2e-4: ragged n, one to
    130 right-hand sides, factors decoupled every `seg` rows solved in
    segments of `block` rows (the kernel and its plain version both force
    the couplings at the `block` boundaries to 0, also where an exact
    factor, seg None, holds non-zero ones there), and a misaligned
    right-hand side."""
    d, e, rng = _chain(max(n, 2), n + 1, dev)
    d, e = d[:n], e[:n - 1]
    f = tridiag_ldl(d, e) if seg is None else tridiag_ldl_blocked(d, e, seg)
    if seg is None and n > 1024:
        assert bool((f.l[1024::1024] != 0).all())
    B = torch.as_tensor(rng.normal(size=(n, q)), dtype=torch.float32,
                        device=dev)
    if misaligned:
        flat = torch.empty(n * q + 1, dtype=torch.float32, device=dev)
        flat[1:] = B.reshape(-1)
        B = flat[1:].view(n, q)
        assert B.is_contiguous() and B.data_ptr() % 16 == 4
    before = tridiag_solve_blocked.launches
    got = tridiag_solve_blocked(f.dp, f.l, B, block=block)
    ref = tridiag_solve_blocked_plain(f.dp, f.l, B, block=block)
    torch.cuda.synchronize()
    assert tridiag_solve_blocked.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


def test_dispatch_launches_the_kernel_its_rule_names(dev):
    """Past 32768 rows a seg-1024 or seg-128 factor launches K1b and an
    exact factor K1; up to 32768 rows every factor launches K1; a block
    wider than 32 columns launches the same kernels; a float64 block
    launches the float64 instantiation of the kernel the same rule names
    (never the plain scans), agreeing with the float32 kernel to 2e-4."""
    n = 33000
    d, e, rng = _chain(n, 9, dev)
    B = torch.as_tensor(rng.normal(size=(n, 40)), dtype=torch.float32,
                        device=dev)
    for f, rows, q, kern in (
            (tridiag_ldl_blocked(d, e, 1024), n, 4, tridiag_solve_blocked),
            (tridiag_ldl_blocked(d, e, 128), n, 4, tridiag_solve_blocked),
            (tridiag_ldl(d, e), n, 4, tridiag_solve),
            (tridiag_ldl_blocked(d[:3000], e[:2999], 1024), 3000, 4,
             tridiag_solve),
            (tridiag_ldl_blocked(d, e, 1024), n, 40, tridiag_solve_blocked),
            (tridiag_ldl(d[:3000], e[:2999]), 3000, 40, tridiag_solve)):
        k1, k1b = tridiag_solve.launches, tridiag_solve_blocked.launches
        tridiag_solve_factored_fast(f, B[:rows, :q].contiguous())
        torch.cuda.synchronize()
        assert (tridiag_solve.launches - k1,
                tridiag_solve_blocked.launches - k1b) == (
            (1, 0) if kern is tridiag_solve else (0, 1))
    for f, kern in ((tridiag_ldl(d, e), tridiag_solve),
                    (tridiag_ldl_blocked(d, e, 1024), tridiag_solve_blocked)):
        k1 = dict(tridiag_solve.launches_by_dtype)
        k1b = dict(tridiag_solve_blocked.launches_by_dtype)
        got64 = tridiag_solve_factored_fast(f, B.double())
        new = [w.launches_by_dtype.get("float64", 0) - c.get("float64", 0)
               for w, c in ((tridiag_solve, k1), (tridiag_solve_blocked,
                                                  k1b))]
        assert new == ([1, 0] if kern is tridiag_solve else [0, 1])
        assert got64.dtype == torch.float64 and got64.is_cuda
        torch.testing.assert_close(got64.float(),
                                   tridiag_solve_factored_fast(f, B),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("graph", [(700, 120, 40, 3), (1500, 1200, 25, 3),
                                   (4500, 2000, 40, 4)])
def test_assemble_kernel_bitwise_equals_plain(dev, graph):
    """K2/K2b against its plain version: bitwise equal, with and without
    the overflow split."""
    idx, w, n = _graph(*graph)
    bop, _ = banded.build_banded_rcm(idx, n)
    bop = bop.to(dev)
    w_pad = torch.cat([-torch.as_tensor(w, dtype=torch.float32, device=dev),
                       torch.zeros(1, device=dev)])
    dd = bop.du_dense
    args = (bop.dcol_tbl[:dd].contiguous(), w_pad[bop.ueid_tbl[:dd]],
            bop.ocol_tbl, bop.olane_tbl, w_pad[bop.oeid_tbl], bop.half,
            bop.nb)
    got = assemble_ut(*args)
    ref = assemble_ut_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("graph,half_min,split", [
    ((2000, 600, 450, 5, 0), 3, False), ((2000, 3000, 450, 5, 200), 3, True),
    ((1500, 300, 25, 3, 300), 1, True), ((1500, 1200, 25, 3, 300), 1, True)])
def test_assemble_kernel_bitwise_on_wide_bands_and_duplicates(dev, graph,
                                                             half_min, split):
    """K2/K2b against its plain version, bitwise: bands of half 4 with and
    without the overflow split, and slot rows holding duplicate edges
    (dense and overflow), which must sum in slot order."""
    from chip_smoke import k2_args, wide_graph

    n_, n_loops, span, seed, dup = graph
    idx, w, n = wide_graph(n_, n_loops, span, seed, dup=dup)
    bop = banded.build_banded(idx, n).to(dev)
    assert bop.half >= half_min and (bop.ov_rows > 0) == split
    args = k2_args(bop, torch.as_tensor(w, dtype=torch.float32, device=dev))
    got = assemble_ut(*args)
    ref = assemble_ut_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d, e, rng = _chain(100, 0, dev)
    f = tridiag_ldl(d, e)
    B = torch.as_tensor(rng.normal(size=(100, 4)), device=dev)
    with pytest.raises(TypeError):
        tridiag_solve(f.dp, f.l, B)  # float64 right-hand sides, float32 dp
    with pytest.raises(TypeError, match="float32 or float64"):
        tridiag_solve(f.dp.half(), f.l.half(), B.half())
    with pytest.raises(ValueError):
        tridiag_solve(f.dp, f.l, B.float().t().contiguous().t())
    with pytest.raises(ValueError):
        tridiag_solve(f.dp.cpu(), f.l, B.float())
    with pytest.raises(TypeError):
        tridiag_solve_blocked(f.dp, f.l, B)
    with pytest.raises(TypeError, match="l is torch.float64"):
        tridiag_solve_blocked(f.dp, f.l.double(), B.float())
    with pytest.raises(ValueError, match="B not contiguous"):
        tridiag_solve_blocked(f.dp, f.l, B.float().t().contiguous().t())
    with pytest.raises(ValueError, match="dp not contiguous"):
        tridiag_solve_blocked(f.dp.repeat_interleave(2)[::2], f.l, B.float())
    with pytest.raises(ValueError, match="different devices"):
        tridiag_solve_blocked(f.dp, f.l.cpu(), B.float())
    with pytest.raises(ValueError, match="want dp, l"):
        tridiag_solve_blocked(f.dp[:-1], f.l, B.float())
    for block in (100, 16, 2048):
        with pytest.raises(ValueError):
            tridiag_solve_blocked(f.dp, f.l, B.float(), block=block)
    idx, w, n = _graph(700, 120, 40, 3)
    bop, _ = banded.build_banded_rcm(idx, n)
    bop = bop.to(dev)
    wu = torch.zeros(bop.dcol_tbl.shape, dtype=torch.float64, device=dev)
    ov = torch.zeros((0, bop.nb), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        assemble_ut(bop.dcol_tbl, wu, ov, ov, ov.float(), bop.half, bop.nb)


def _k1_body(dtype=None):
    """Launches of K1's body: K1, and K1p (its permuted entry, the banded
    V-cycle's smoother), in all or of one dtype name."""
    if dtype is None:
        return tridiag_solve.launches + tridiag_solve_permuted.launches
    return (tridiag_solve.launches_by_dtype.get(dtype, 0)
            + tridiag_solve_permuted.launches_by_dtype.get(dtype, 0))


def test_solve_on_cuda_goes_through_both_kernels(dev):
    """A MAC solve on the card launches both kernels (K1's body as K1p in
    the banded V-cycle) and returns a rounded selection of k edges."""
    from mac_tpu_torch.solvers import MAC

    idx, w, n = _graph(1500, 1200, 25, 3)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              fw_polish=False, round_guard=False, device="cuda")
    t0, a0 = _k1_body(), assemble_ut.launches
    rounded, unrounded, upper = mac.solve(k)
    assert _k1_body() > t0 and assemble_ut.launches > a0
    assert rounded.sum() == k and np.isfinite(upper)
    assert np.all(np.isfinite(unrounded))


def test_ell_solve_on_cuda_launches_the_blocked_kernel(dev):
    """A matrix-free MAC solve past 32768 nodes (an expander-like graph, no
    narrow band) runs every V-cycle's chain solve on K1b's solve, as K1p's
    segment body (the cycle's kernels: K1p, K8, K7), never K1b between
    PyTorch gathers, and returns k edges."""
    from chip_smoke import synthetic
    from mac_tpu_torch.ops.kernels.ell import ell_product
    from mac_tpu_torch.solvers import MAC

    fi, wf, ci, wc = synthetic(40000)
    k = len(wc) // 4
    mac = MAC((fi, wf), (ci, wc), 40000, dtype=torch.float32,
              fiedler_maxiter=10, fiedler_inner_iters=4, device="cuda")
    assert mac._banded is None and mac.op.mode == "ell"
    before = (tridiag_solve_blocked.launches,
              tridiag_solve_permuted.launches_by_body.get("segment", 0),
              ell_product.launches)
    rounded, unrounded, upper = mac.solve(k, max_iters=2)
    assert tridiag_solve_blocked.launches == before[0]
    assert tridiag_solve_permuted.launches_by_body["segment"] > before[1]
    assert ell_product.launches > before[2]
    assert rounded.sum() == k and np.isfinite(upper)
    assert np.all(np.isfinite(unrounded))


def _launch_counts():
    """(K1's body: K1 and K1p, K1b, K2/K2b) launches."""
    return (_k1_body(), tridiag_solve_blocked.launches, assemble_ut.launches)


def test_banded_tails_on_cuda_agree_with_the_cpu_run(dev):
    """The banded float32 route with its exact host tails, on the card and
    on the CPU: both launch-count classes (K1 and the assembly kernel on the
    card, none on the CPU), k edges each, the tails' stats, and relaxed
    lambda_2 values (scipy float64 referee) within 5e-3 relative of each
    other (two float32 Frank-Wolfe trajectories)."""
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    idx, w, n = _graph(600, 110, 9, 11)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    lam = {}
    for device in ("cuda", "cpu"):
        mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
                  fw_polish=True, device=device)
        assert mac.round_guard
        before = _launch_counts()
        rounded, unrounded, upper = mac.solve(k)
        k1, k1b, k2 = (a - b for a, b in zip(_launch_counts(), before))
        assert (k1 > 0 and k2 > 0) == (device == "cuda") and k1b == 0
        stats = mac.last_solve_stats
        assert {"polished", "polish_time_s", "guard_time_s",
                "exact_evals"} <= set(stats) and stats["exact_evals"] > 0
        assert rounded.sum() == k
        lam[device] = scipy_lam2(mac.laplacian(unrounded))
        assert upper >= lam[device] * (1 - 1e-9)
    assert abs(lam["cuda"] - lam["cpu"]) <= 5e-3 * lam["cpu"], lam


def test_float64_device_route_runs_k1_f64_and_host_route_none(dev):
    """In float64 on the card: the device route (ELL, the chain-solve
    preconditioner) evaluates lambda_2 within 1e-8 relative of numpy's
    dense eigh and solves to k edges, its chain solves all through K1's
    float64 instantiation; the default constructor sends a small instance
    to the host engine, which launches no kernel."""
    from mac_tpu_torch.solvers import MAC

    idx, w, n = _graph(400, 60, 30, 1)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    before = _launch_counts()
    k1_64 = tridiag_solve.launches_by_dtype.get("float64", 0)
    mac = MAC(fixed, cands, n, dtype=torch.float64)
    assert (mac.device.type, mac.fiedler_backend, mac.fiedler_precond) == (
        "cuda", "device", "tridiag")
    x = np.random.RandomState(5).rand(60)
    ref = np.linalg.eigvalsh(mac.laplacian(x).toarray())[1]
    assert abs(mac.evaluate_objective(x) - ref) <= 1e-8 * ref
    rounded, _, upper = mac.solve(20)
    assert rounded.sum() == 20 and np.isfinite(upper)
    k1, k1b, k2 = (a - b for a, b in zip(_launch_counts(), before))
    assert k1 > 0 and (k1b, k2) == (0, 0)
    assert tridiag_solve.launches_by_dtype["float64"] - k1_64 == k1
    before = _launch_counts()
    host = MAC(fixed, cands, n)
    assert (host.dtype, host.fiedler_backend) == (torch.float64, "host")
    assert host.solve(20)[0].sum() == 20
    assert _launch_counts() == before


def test_front_ends_default_to_cuda(dev):
    """find_fiedler_pair and IncrementalFiedlerSolver run on the card in
    float32 unless told otherwise: tensors on the card, lambda_2 within
    1e-3 relative of numpy's dense eigh."""
    from mac_tpu_torch.utils.fiedler import find_fiedler_pair
    from mac_tpu_torch.utils.graphs import weight_graph_lap_from_edges
    from mac_tpu_torch.utils.incremental import IncrementalFiedlerSolver

    idx, w, n = _graph(500, 200, 60, 2)
    L = weight_graph_lap_from_edges(idx, w, n)
    ref = np.linalg.eigvalsh(L.toarray())[1]
    lam, v, X = find_fiedler_pair(L)
    assert lam.is_cuda and X.is_cuda and X.dtype == torch.float32
    assert abs(float(lam) - ref) <= 1e-3 * ref
    edges = [(int(i), int(j), float(wt)) for (i, j), wt in zip(idx, w)]
    solver = IncrementalFiedlerSolver(edges[:n - 1], n,
                                      candidate_edges=edges[n - 1:])
    assert solver.device.type == "cuda" and solver.dtype == torch.float32
    for e in edges[n - 1:]:
        solver.add_edge(e)
    lam_inc, v_inc = solver.find_fiedler_pair()
    assert abs(lam_inc - ref) <= 1e-3 * ref and v_inc.shape == (n,)


def test_greedy_eig_batched_chunk_matches_per_lane_loop(dev):
    """GreedyEig on the card (float32, ELL, n 1200, 600 long candidates,
    400 of them selected): a trial chunk of 64 lanes as one solve launches
    K1's body (K1p, the V-cycle's chain solve) and K8 on the (n, 256)
    block, and its lambda_2 agree with the per-lane loop
    (each lane with its own weights and V-cycle) to 5e-4 relative, none
    below the incumbent's; two greedy steps select two edges."""
    from chip_smoke import chain_instance
    from mac_tpu_torch.solvers import GreedyEig
    from mac_tpu_torch.solvers.greedy_eig import TRIAL_MIN_ITERS
    from mac_tpu_torch.utils.fiedler import fiedler_pair_lanes_plain

    fixed, cands = chain_instance(1200, 600, 3)
    g = GreedyEig(fixed, cands, 1200)
    assert g.device.type == "cuda" and g.dtype == torch.float32
    x = np.zeros(len(cands))
    x[:400] = 1.0
    lam, X = g._eval(x, g._X0)
    from mac_tpu_torch.ops.kernels.ell import ell_product

    cand = np.arange(400, 464)
    before, k8 = _k1_body(), ell_product.launches_by_lanes.get(1, 0)
    lams, Xs = g._eval_chunk(x, cand, X)
    assert _k1_body() > before and Xs.is_cuda
    assert ell_product.launches_by_lanes[1] > k8
    c = torch.as_tensor(cand, device=dev)
    ref = fiedler_pair_lanes_plain(g.op, g._weights(x), c + g._m_fixed,
                                   g._w_cand[c], X, xprev0=g.xprev0,
                                   tol=g.fiedler_tol,
                                   min_iters=TRIAL_MIN_ITERS)
    np.testing.assert_allclose(lams, ref.lam[:, 0].cpu().numpy(), rtol=5e-4)
    assert np.all(lams >= float(lam) * (1 - 5e-4))
    mask, sel = g.subset(2)
    assert mask.sum() == 2 and len(sel) == 2


def test_greedy_esp_scan_on_card_matches_host_loop(dev):
    """GreedyESP's scan on the card (chain n 900, m 2500, k 840, U in
    float64) selects the host numpy loop's order; TF32 stays off."""
    from chip_smoke import chain_instance
    from mac_tpu_torch.solvers import GreedyESP

    assert not torch.backends.cuda.matmul.allow_tf32
    fixed, cands = chain_instance(900, 2500, 5)
    order = GreedyESP(fixed, cands, 900)._select_scan_device(840)
    host = GreedyESP(fixed, cands, 900)
    host.SCAN_MIN_WORK = 10 ** 18
    _, sel = host.subset(840)
    ids = {id(e): i for i, e in enumerate(cands)}
    assert [ids[id(e)] for e in sel] == order.tolist()


@pytest.mark.parametrize("R,n,q,shared", [
    (8, 10000, 4, False), (3, 257, 5, False), (2, 33000, 40, False),
    (64, 1728, 4, True), (2, 5000, 200, False), (1, 1001, 130, True)])
def test_tridiag_kernel_lanes_match_plain(dev, R, n, q, shared):
    """K1's lane form in one launch (a cluster per (column group, lane)):
    B (R, n, q) with a factor per lane (R, n) or one shared (n,), against
    the plain version at rtol/atol 2e-4; also the (n, R q) block of a
    shared factor (GreedyEig's layout) in one launch."""
    d, e, rng = _chain(n, R + n, dev)
    dd = d * torch.as_tensor(1.0 + rng.rand(R, 1), dtype=torch.float32,
                             device=dev)
    f = tridiag_ldl(d, e) if shared else tridiag_ldl(dd, e.expand(R, -1))
    B = torch.as_tensor(rng.normal(size=(R, n, q)), dtype=torch.float32,
                        device=dev)
    before = tridiag_solve.launches
    got = tridiag_solve(f.dp, f.l, B)
    ref = tridiag_solve_plain(f.dp, f.l, B)
    torch.cuda.synchronize()
    assert tridiag_solve.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    if shared:
        wide = B.permute(1, 0, 2).reshape(n, R * q).contiguous()
        torch.testing.assert_close(tridiag_solve(f.dp, f.l, wide),
                                   tridiag_solve_plain(f.dp, f.l, wide),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("R,n,q,shared", [
    (2, 100000, 4, False), (3, 40000, 8, False), (2, 33003, 4, False),
    (4, 40000, 4, True), (2, 1025, 5, False)])
def test_blocked_tridiag_kernel_lanes_match_plain(dev, R, n, q, shared):
    """K1b's lane form, grid (segments, column groups, R): per-lane and
    shared factors, the tiled (q 4), vector (q 8) and scalar (q 5, or lanes
    at n % 4 != 0) load paths, against the plain version at 2e-4."""
    d, e, rng = _chain(n, 2 * R + n, dev)
    dd = d * torch.as_tensor(1.0 + rng.rand(R, 1), dtype=torch.float32,
                             device=dev)
    f = (tridiag_ldl_blocked(d, e, 1024) if shared
         else tridiag_ldl_blocked(dd, e.expand(R, -1), 1024))
    B = torch.as_tensor(rng.normal(size=(R, n, q)), dtype=torch.float32,
                        device=dev)
    before = tridiag_solve_blocked.launches
    got = tridiag_solve_blocked(f.dp, f.l, B)
    ref = tridiag_solve_blocked_plain(f.dp, f.l, B)
    torch.cuda.synchronize()
    assert tridiag_solve_blocked.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("graph", [(700, 120, 40, 3), (4500, 2000, 40, 4)])
def test_assemble_kernel_lanes_bitwise_equal_plain(dev, graph):
    """K2/K2b's lane form (grid (nb, half+1, R), shared slot tables): one
    launch, bitwise its plain version, lane r the single assembly."""
    idx, w, n = _graph(*graph)
    bop, _ = banded.build_banded_rcm(idx, n)
    bop = bop.to(dev)
    W = torch.as_tensor(w, dtype=torch.float32, device=dev) * torch.linspace(
        0.5, 1.5, 3, device=dev)[:, None]
    w_pad = torch.cat([-W, W.new_zeros((3, 1))], dim=-1)
    dd = bop.du_dense
    args = (bop.dcol_tbl[:dd].contiguous(), w_pad[:, bop.ueid_tbl[:dd]],
            bop.ocol_tbl, bop.olane_tbl, w_pad[:, bop.oeid_tbl], bop.half,
            bop.nb)
    before = assemble_ut.launches
    got = assemble_ut(*args)
    torch.cuda.synchronize()
    assert assemble_ut.launches == before + 1
    assert torch.equal(got, assemble_ut_plain(*args))
    assert torch.equal(got[1], banded.assemble_bd(bop, W[1]).ut)


def test_sweep_on_cuda_goes_through_the_lane_kernels(dev):
    """A banded float32 sweep of 3 budgets on the card launches K1 and K2
    once per call for all lanes (the same count as one solve's calls, not 3
    times it), and each lane rounds to exactly k."""
    from mac_tpu_torch.solvers import MAC

    idx, w, n = _graph(1500, 1200, 25, 3)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    m = len(cands[1])
    ks = [m // 4, m // 2, 3 * m // 4]
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              device="cuda")
    t0, a0 = _k1_body(), assemble_ut.launches
    rounded, unrounded, upper = mac.solve_sweep(ks)
    assert assemble_ut.launches - a0 == 32
    assert _k1_body() > t0
    assert [int(r.sum()) for r in rounded] == ks
    assert np.all(np.isfinite(unrounded)) and np.all(np.isfinite(upper))


# The float64 instantiations. K1 splits its rows over a 16-block cluster
# and keeps a block's rows in shared memory while they fit: with 8-byte
# elements at q = 4 up to 16 blocks of 4140 rows (n 66240), past that the
# tiled two-pass branch (chip_smoke.k1_whole_row_limit).
F64 = dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n,q,blocked", [
    (1, 1, False), (31, 3, False), (2500, 4, False), (10000, 4, True),
    (10001, 5, False), (1001, 130, False), (5000, 200, False),
    (33000, 40, False), (100000, 4, False), (4000, 4, True)]
    + [(k1_whole_row_limit(4, 8) + d, 4, False) for d in (0, 1)])
def test_tridiag_kernel_f64_matches_plain(dev, n, q, blocked):
    """K1's float64 instantiation against its plain version at rtol/atol
    1e-10: ragged n, one to 200 right-hand sides, exact and blocked
    factors, an exact factor on each side of the whole-row / tiled
    threshold, past one launch's 128 columns."""
    d, e, rng = _chain(max(n, 2), n, dev)
    d, e = d[:n].double(), e[:n - 1].double()
    f = (tridiag_ldl_blocked(d, e, block=128) if blocked
         else tridiag_ldl(d, e))
    B = torch.as_tensor(rng.normal(size=(n, q)), dtype=torch.float64,
                        device=dev)
    before = tridiag_solve.launches_by_dtype.get("float64", 0)
    got = tridiag_solve(f.dp, f.l, B)
    ref = tridiag_solve_plain(f.dp, f.l, B)
    torch.cuda.synchronize()
    assert tridiag_solve.launches_by_dtype["float64"] == before + 1
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, **F64)


@pytest.mark.parametrize("n,q,block,misaligned", [
    (100000, 4, 1024, False), (40000, 8, 1024, False), (1025, 5, 1024, False),
    (40000, 32, 1024, False), (1000, 4, 96, False), (33000, 4, 128, False),
    (100000, 4, 1024, True), (40000, 8, 1024, True), (1, 1, 1024, False)])
def test_blocked_tridiag_kernel_f64_matches_plain(dev, n, q, block,
                                                  misaligned):
    """K1b's float64 instantiation against its plain version at rtol/atol
    1e-10 on its three load paths (q 4: the tile; q 8, 32: four values per
    row; q 5, or a right-hand side 8 bytes off a 16-byte boundary: value by
    value), segments of 1024, 128 and 96 rows."""
    d, e, rng = _chain(max(n, 2), n + 3, dev)
    d, e = d[:n].double(), e[:n - 1].double()
    f = tridiag_ldl_blocked(d, e, 1024) if n > 1 else tridiag_ldl(d, e)
    B = torch.as_tensor(rng.normal(size=(n, q)), dtype=torch.float64,
                        device=dev)
    if misaligned:
        flat = torch.empty(n * q + 1, dtype=torch.float64, device=dev)
        flat[1:] = B.reshape(-1)
        B = flat[1:].view(n, q)
        assert B.is_contiguous() and B.data_ptr() % 16 == 8
    before = tridiag_solve_blocked.launches_by_dtype.get("float64", 0)
    got = tridiag_solve_blocked(f.dp, f.l, B, block=block)
    ref = tridiag_solve_blocked_plain(f.dp, f.l, B, block=block)
    torch.cuda.synchronize()
    assert tridiag_solve_blocked.launches_by_dtype["float64"] == before + 1
    torch.testing.assert_close(got, ref, **F64)


@pytest.mark.parametrize("R,n,q,blocked", [
    (8, 10000, 4, False), (2, 100000, 4, True), (3, 40000, 8, True),
    (2, 5000, 200, False)])
def test_tridiag_kernels_f64_lanes_match_plain(dev, R, n, q, blocked):
    """The float64 lane forms of K1 and K1b (a factor per lane) against
    their plain versions at 1e-10."""
    d, e, rng = _chain(n, 3 * R + n, dev)
    dd = d.double() * torch.as_tensor(1.0 + rng.rand(R, 1), device=dev)
    ee = e.double().expand(R, -1)
    f = tridiag_ldl_blocked(dd, ee, 1024) if blocked else tridiag_ldl(dd, ee)
    B = torch.as_tensor(rng.normal(size=(R, n, q)), dtype=torch.float64,
                        device=dev)
    kern, plain = ((tridiag_solve_blocked, tridiag_solve_blocked_plain)
                   if blocked else (tridiag_solve, tridiag_solve_plain))
    got = kern(f.dp, f.l, B)
    torch.testing.assert_close(got, plain(f.dp, f.l, B), **F64)


@pytest.mark.parametrize("graph", [(700, 120, 40, 3), (1500, 1200, 25, 3),
                                   (4500, 2000, 40, 4)])
def test_assemble_kernel_f64_bitwise_equals_plain(dev, graph):
    """K2/K2b's float64 instantiation (128 KB tiles) against its plain
    version, bitwise, with and without the overflow split, single and with
    3 lanes (the middle lane's weights are w); float32's kernel on w
    within 1e-6 of it."""
    idx, w, n = _graph(*graph)
    bop, _ = banded.build_banded_rcm(idx, n)
    bop = bop.to(dev)
    w64 = torch.as_tensor(w, dtype=torch.float64, device=dev)
    W = w64 * torch.linspace(0.5, 1.5, 3, dtype=torch.float64,
                             device=dev)[:, None]
    from chip_smoke import k2_args

    for weights in (w64, W):
        args = k2_args(bop, weights)
        before = assemble_ut.launches_by_dtype.get("float64", 0)
        got = assemble_ut(*args)
        ref = assemble_ut_plain(*args)
        torch.cuda.synchronize()
        assert assemble_ut.launches_by_dtype["float64"] == before + 1
        assert got.dtype == torch.float64 and torch.equal(got, ref)
    ut32 = assemble_ut(*k2_args(bop, w64.float()))
    torch.testing.assert_close(ut32, got[1].float(), rtol=1e-6, atol=1e-6)


def test_banded_float64_and_methods_on_cuda(dev):
    """use_banded=True in float64 on the card: the banded operator with the
    reference's conservative knobs and no host tails, K2 and K1 launched in
    float64 only, exactly k edges, upper bound at least the relaxed
    lambda_2, which agrees with the CPU run's to 1e-9 relative (the same
    float64 semantics); LOBPCG and the dense eigh on the banded operator
    (float32) select exactly k edges too."""
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    idx, w, n = _graph(600, 110, 9, 11)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    lam = {}
    for device in ("cuda", "cpu"):
        mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float64,
                  device=device)
        assert mac._banded is not None and not mac.fw_polish
        assert (mac.fiedler_tol, mac.fiedler_maxiter) == (1e-8, 200)
        k1 = dict(tridiag_solve_permuted.launches_by_dtype)
        k2 = dict(assemble_ut.launches_by_dtype)
        rounded, unrounded, upper = mac.solve(k)
        if device == "cuda":
            for wrapper, was in ((tridiag_solve_permuted, k1),
                                 (assemble_ut, k2)):
                now = wrapper.launches_by_dtype
                assert now.get("float64", 0) > was.get("float64", 0)
                assert now.get("float32", 0) == was.get("float32", 0)
        lam[device] = scipy_lam2(mac.laplacian(unrounded))
        assert rounded.sum() == k and upper >= lam[device] * (1 - 1e-9)
    assert abs(lam["cuda"] - lam["cpu"]) <= 1e-9 * lam["cpu"], lam
    for method in ("lobpcg", "dense"):
        mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
                  fiedler_method=method, device="cuda")
        rounded, unrounded, upper = mac.solve(k, max_iters=3)
        assert rounded.sum() == k and np.all(np.isfinite(unrounded))


def _ulps(a, b):
    """Largest distance in float32 ulps between two float32 tensors."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def _factor_inputs(n, seed, dev, dtype, lanes=None):
    """_chain's d (n,) and e (n - 1,) in dtype, or R lanes of them (one
    seed a lane)."""
    if lanes is None:
        d, e, _ = _chain(n, seed, dev)
        return d.to(dtype), e.to(dtype)
    chains = [_chain(n, seed + r, dev)[:2] for r in range(lanes)]
    return tuple(torch.stack(part).to(dtype) for part in zip(*chains))


# chip_smoke.py phase 3d's shapes (n, block, lanes): city10000's chain at
# block 128, the n = 100000 two-grid chain at 1024, a partial last segment,
# the sweeps' 8 and 2 lanes; and small edges (one row, one segment); the
# chain warp's edges: two and 17 rows, a segment shorter than its block,
# segments that end inside a 32-row ring slot (block 100, 33), 125
# segments (four blocks of 32, the last one partial).
_K3B_CASES = [(10000, 128, None), (100000, 1024, None), (100003, 1024, None),
              (10000, 128, 8), (100000, 1024, 2), (1, 128, None),
              (129, 128, None), (5, 1024, 3), (2, 128, None),
              (17, 128, None), (17, 1024, None), (10000, 100, None),
              (4097, 33, None), (4097, 33, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,block,lanes", _K3B_CASES)
def test_blocked_ldl_kernel_bitwise_equals_plain(dev, n, block, lanes,
                                                 dtype):
    """K3b against its plain version, dp and l bit for bit."""
    d, e = _factor_inputs(n, n + block, dev, dtype, lanes)
    before = ldl.tridiag_ldl_blocked.launches
    dp, l = ldl.tridiag_ldl_blocked(d, e, block)
    assert ldl.tridiag_ldl_blocked.launches == before + 1
    ref_dp, ref_l = ldl.tridiag_ldl_blocked_plain(d, e, block)
    torch.cuda.synchronize()
    assert dp.dtype == dtype and dp.shape == d.shape
    assert torch.equal(dp, ref_dp) and torch.equal(l, ref_l)


# Phase 3d's exact shapes: sphere2500's chain length, the auto route's
# largest n, n = 40000 past it (tridiag_solve(d, e, B)), 8 lanes; the
# edges of the 1024-thread row split; 17 rows, and 4096 and 4097, the
# largest chain the kernel keeps in registers and the smallest it stages.
_K3_CASES = [(2500, None), (32768, None), (40000, None), (10000, 8),
             (1, None), (2, None), (1023, None), (1025, None), (3000, 3),
             (17, None), (4096, None), (4097, None), (4096, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,lanes", _K3_CASES)
def test_exact_ldl_kernel_matches_plain(dev, n, lanes, dtype):
    """K3 against its plain doubling scan: 1e-13 relative in float64, at
    most one ulp in float32; l_0 = 0 exactly."""
    d, e = _factor_inputs(n, n, dev, dtype, lanes)
    before = ldl.tridiag_ldl.launches
    dp, l = ldl.tridiag_ldl(d, e)
    assert ldl.tridiag_ldl.launches == before + 1
    ref_dp, ref_l = ldl.tridiag_ldl_plain(d, e)
    torch.cuda.synchronize()
    assert bool((l[..., 0] == 0).all())
    for got, ref in ((dp, ref_dp), (l, ref_l)):
        if dtype == torch.float64:
            assert torch.allclose(got, ref, rtol=1e-13, atol=0), float(
                ((got - ref).abs() / ref.abs().clamp_min(1e-300)).max())
        else:
            assert _ulps(got, ref) <= 1


@pytest.mark.parametrize("n", [2500, 4097])
@pytest.mark.parametrize("power", [400, -400])
def test_ldl_kernels_on_a_chain_scaled_far_from_one(dev, n, power):
    """A float64 chain scaled by 2^power (e^2 near 2^(2 power)): K3 within
    F64_FACTOR_RTOL of the extended-precision referee, in registers (2500
    rows) and staged (4097), and bit for bit the unscaled chain's factor
    with dp scaled by the same power of two; K3b bit for bit its plain
    version."""
    from chip_smoke import F64_FACTOR_RTOL, pivot_referee

    d1, e1 = _factor_inputs(n, n, dev, torch.float64)
    d, e = d1 * 2.0 ** power, e1 * 2.0 ** power
    dp, l = ldl.tridiag_ldl(d, e)
    dp1, l1 = ldl.tridiag_ldl(d1, e1)
    ref_dp, ref_l = pivot_referee(d, e)
    torch.cuda.synchronize()
    for got, ref in ((dp, ref_dp[0]), (l, ref_l[0])):
        got = got.cpu().numpy().astype(np.longdouble)
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
        assert float(rel.max()) <= F64_FACTOR_RTOL, float(rel.max())
    assert torch.equal(dp, dp1 * 2.0 ** power)
    assert torch.equal(l, l1)
    bdp, bl = ldl.tridiag_ldl_blocked(d, e, 128)
    pdp, pl = ldl.tridiag_ldl_blocked_plain(d, e, 128)
    assert torch.equal(bdp, pdp) and torch.equal(bl, pl)


def test_solve_past_the_scan_limit_factors_on_the_card(dev):
    """tridiag_solve(d, e, B) at n = 40000 factors through K3 (one launch)
    and solves T X = B: the residual within float64 rounding."""
    from mac_tpu_torch.ops.tridiag import tridiag_solve as solve_de

    d, e = _factor_inputs(40000, 4, dev, torch.float64)
    B = torch.randn((40000, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0)).to(dev)
    before = ldl.tridiag_ldl.launches
    X = solve_de(d, e, B)
    assert ldl.tridiag_ldl.launches == before + 1
    TX = d[:, None] * X
    TX[1:] += e[:, None] * X[:-1]
    TX[:-1] += e[:, None] * X[1:]
    assert float((TX - B).abs().max()) <= 1e-10 * float(B.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ldl_stamped_build_and_chain_probe(dev, dtype):
    """The kernels with their phase stamps (ldl.phases) return what the
    kernels return, bit for bit, with every stamp set and not counted as a
    launch; the chain probe runs both chains and counts their cycles."""
    for n, block in ((10000, 128), (2500, None), (4097, None)):
        d, e = _factor_inputs(n, n, dev, dtype)
        kern = (ldl.tridiag_ldl if block is None
                else lambda d_, e_: ldl.tridiag_ldl_blocked(d_, e_, block))
        counts = (ldl.tridiag_ldl.launches, ldl.tridiag_ldl_blocked.launches)
        dp, l, clk = ldl.phases(d, e, block)
        assert counts == (ldl.tridiag_ldl.launches,
                          ldl.tridiag_ldl_blocked.launches)
        ref_dp, ref_l = kern(d, e)
        assert torch.equal(dp, ref_dp) and torch.equal(l, ref_l)
        clk = clk.cpu().tolist()
        assert clk[0] in (4, 5) and all(c >= 0 for c in clk[1:1 + clk[0]])
        assert clk[14] > 0 and clk[15] > 0
    out = torch.zeros(2, dtype=torch.float64, device=dev)
    for which, want in ((0, 2.0), (1, None)):
        ldl.step_probe(dtype, 256, which, out)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()) and float(out[1]) > 0
        if want is not None:
            assert abs(float(out[0]) - want) < 1e-12


def test_ldl_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d, e = _factor_inputs(100, 0, dev, torch.float32)
    for fn in (ldl.tridiag_ldl, ldl.tridiag_ldl_blocked):
        with pytest.raises(TypeError, match="float32 or float64"):
            fn(d.half(), e.half())
        with pytest.raises(TypeError, match="e is torch.float64"):
            fn(d, e.double())
        with pytest.raises(ValueError, match="d not contiguous"):
            fn(d.repeat_interleave(2)[::2], e)
        with pytest.raises(ValueError, match="different devices"):
            fn(d, e.cpu())
        with pytest.raises(ValueError, match="want d"):
            fn(d, e[:-1])
    with pytest.raises(ValueError, match="block"):
        ldl.tridiag_ldl_blocked(d, e, 0)
    # One chain shared by every lane (a lane stride of 0) is taken as is.
    dp, l = ldl.tridiag_ldl_blocked(d.expand(3, -1), e.expand(3, -1), 32)
    ref = ldl.tridiag_ldl_blocked_plain(d, e, 32)
    assert torch.equal(dp, ref[0].expand(3, -1)) and torch.equal(
        l, ref[1].expand(3, -1))


def test_banded_solve_launches_k3b_once_per_factorisation(dev, monkeypatch):
    """A MAC solve on a banded graph past 4096 nodes factors its chain by
    K3b, one launch per factorisation, and never hands a plain factor a
    CUDA tensor: counted on the eager solve path (graphs.plain_solve),
    where every factorisation is a Python call; a warm solve through the
    replayed set-up graphs launches K3b as often."""
    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.solvers import MAC

    calls = {"factor": 0, "plain": 0}
    real_factor = banded.tridiag_ldl_blocked

    def factor(*args, **kw):
        calls["factor"] += 1
        return real_factor(*args, **kw)

    def watch(real):
        def plain(*args, **kw):
            calls["plain"] += any(isinstance(a, torch.Tensor) and a.is_cuda
                                  for a in args)
            return real(*args, **kw)
        return plain

    monkeypatch.setattr(banded, "tridiag_ldl_blocked", factor)
    for name in ("tridiag_ldl_plain", "tridiag_ldl_blocked_plain"):
        monkeypatch.setattr(ldl, name, watch(getattr(ldl, name)))
    idx, w, n = _graph(4500, 2000, 40, 4)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              fw_polish=False, round_guard=False, device="cuda")
    replayed = graphs.graphed_solve
    monkeypatch.setattr(graphs, "graphed_solve", graphs.plain_solve)
    k3b, k3 = ldl.tridiag_ldl_blocked.launches, ldl.tridiag_ldl.launches
    rounded, unrounded, upper = mac.solve(k)
    assert calls["factor"] > 0 and calls["plain"] == 0
    eager = ldl.tridiag_ldl_blocked.launches - k3b
    assert eager == calls["factor"]
    assert ldl.tridiag_ldl.launches == k3
    assert rounded.sum() == k and np.isfinite(upper)
    monkeypatch.setattr(graphs, "graphed_solve", replayed)
    mac.solve(k)  # cold: captures the graphs
    k3b = ldl.tridiag_ldl_blocked.launches
    mac.solve(k)
    assert ldl.tridiag_ldl_blocked.launches - k3b == eager
    assert calls["plain"] == 0 and ldl.tridiag_ldl.launches == k3


_PRECOND_VARIANTS = [("chain", "mult"), ("chain", "additive"),
                     ("bjacobi", "mult"), ("bjacobi", "additive")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("smoother,kind", _PRECOND_VARIANTS)
def test_precond_variants_on_cuda_match_the_cpu_call(dev, smoother, kind,
                                                     dtype):
    """The banded preconditioner's four (smoother, kind) pairs on the card
    against the same call on CPU tensors (the kernels' plain versions), on
    an exact-factor graph (n 700: K3) and a blocked one (n 4500: K3b):
    within 2e-4 of max |M(B)| in float32 (K1's tolerance) and 1e-10 in
    float64. The chain smoother launches K1 and its factor's kernel,
    block-Jacobi neither."""
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    for graph in ((700, 120, 40, 3), (4500, 2000, 40, 4)):
        idx, w_np, n = _graph(*graph)
        out = {}
        for device in ("cpu", "cuda"):
            bop = banded.build_banded_rcm(idx, n)[0].to(device)
            w = torch.as_tensor(w_np, dtype=dtype, device=device)
            B = torch.as_tensor(np.random.RandomState(8).normal(size=(n, 4)),
                                dtype=dtype, device=device)
            before = (_k1_body(), ldl.tridiag_ldl.launches
                      + ldl.tridiag_ldl_blocked.launches)
            BD = banded.assemble_bd(bop, w)
            M = banded.make_banded_precond(
                bop, BD, w=w if smoother == "chain" else None,
                smoother=smoother, kind=kind)
            out[device] = M(B).cpu()
        # The card's launches (the CPU call launches none).
        k1 = _k1_body() - before[0]
        k3 = (ldl.tridiag_ldl.launches + ldl.tridiag_ldl_blocked.launches
              - before[1])
        assert (k1 > 0, k3 > 0) == (smoother == "chain",) * 2, (k1, k3)
        ref = out["cpu"]
        assert bool(torch.isfinite(out["cuda"]).all())
        torch.testing.assert_close(out["cuda"], ref, rtol=tol,
                                   atol=tol * float(ref.abs().max()))


def _inner_steps(route, dev, seeds):
    """For each seed, a Frank-Wolfe step's inner-solve inputs on
    the card: (Route, state, fresh apply_inner, fresh Minv), built as
    utils.fiedler built them before the set-up was graphed, on a small
    banded graph (n 1500, chain factor K3) or the ELL operator past 32768
    nodes (K1b, K3b); the edge weights scaled by 0.5 + U(0, 1) from the
    seed (None: unscaled)."""
    from chip_smoke import synthetic
    from mac_tpu_torch.ops import graphs, laplacian, twogrid
    from mac_tpu_torch.ops.lobpcg import as_operator

    if route == "banded":
        idx, w_np, n = _graph(1500, 1200, 25, 3)
        op = banded.build_banded_rcm(idx, n)[0].to(dev)
    else:
        fi, wf, ci, wc = synthetic(40000)
        idx, w_np, n = np.concatenate([fi, ci]), np.concatenate([wf, wc]), \
            40000
        op = laplacian.build_operator(idx, n).to(dev)
    out = []
    for seed in seeds:
        scale = (1.0 if seed is None
                 else 0.5 + np.random.RandomState(seed).rand(len(w_np)))
        w = torch.as_tensor(w_np * scale, dtype=torch.float32, device=dev)
        if route == "banded":
            BD = banded.assemble_bd(op, w)
            M, st = banded.make_banded_precond(op, BD, w=w, return_state=True)
            solve = graphs.banded_route(op, banded.PRECOND_KIND)
            state = graphs.banded_state(BD, st)
            lnorm = 2.0 * BD.deg.amax()
            apply_L = banded.BandedProduct(op, BD)
        else:
            w_tbl = laplacian.lap_weight_table(op, w)
            apply_L = laplacian.ell_applier(op, w_tbl)
            fac, Lc_inv = twogrid.twogrid_level(op, w)
            M = twogrid.twogrid_cycle(op, fac, Lc_inv, apply_L)
            solve = graphs.twogrid_route(op)
            state = graphs.twogrid_state(w_tbl, fac, Lc_inv)
            lnorm = laplacian.lap_inf_norm(op, w)
        c = lnorm.to(torch.float32)
        sigma = 32 * torch.finfo(torch.float32).eps * c
        state = dict(state, c=c, sigma=sigma)
        # The step's form, as ops.graphs.inner_replay builds it (K5 with
        # the shift on the banded route).
        apply_inner = as_operator(apply_L).shifted(c, sigma)
        out.append((solve, state, apply_inner, M))
    return n, out


@pytest.mark.parametrize("route", ["banded", "ell"])
def test_graphed_inner_solve_is_bitwise_the_eager_loop(dev, route):
    """The replayed graph of the inner solve alone (graphs.inner_replay,
    the form before the set-up and the outer iteration were captured)
    against pcg_fixed on the eager closures of the same step, bitwise, for
    two weight vectors in turn through one captured graph (each step's
    state lives at fresh addresses: the graph reads its static copies),
    and again for the first: one capture, three replays, and after the
    capture each replay counts the kernel launches the eager loop does
    (K1p on both graphs, and K8 on the ELL one)."""
    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.ops.cg import pcg_fixed

    from mac_tpu_torch.ops.kernels.ell import ell_product

    n, steps = _inner_steps(route, dev, (None, 2))
    kern = tridiag_solve_permuted if route == "banded" else ell_product
    rng = np.random.RandomState(12)
    B = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                        device=dev)
    X0 = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                         device=dev)
    solve = steps[0][0]
    assert all(s is solve for s, *_ in steps)
    for turn, (_, state, apply_inner, M) in enumerate(steps + steps[:1]):
        k0 = kern.launches
        eager = pcg_fixed(apply_inner, B, M, iters=5, X0=X0)
        torch.cuda.synchronize()
        k_eager = kern.launches - k0
        k0 = kern.launches
        got = graphs.inner_replay(solve, state, B, X0, 5)
        torch.cuda.synchronize()
        if turn:
            assert kern.launches - k0 == k_eager > 0
        assert torch.equal(got, eager), float((got - eager).abs().max())
    assert (solve.captures, solve.replays) == (1, 3)
    assert solve.pool_bytes >= 0 and solve.static_bytes > 0


def _solve_inputs(dev, route, dtype=torch.float32, q=4):
    """(operator, weight vectors at two seeds, start block of q columns,
    xprev0) of a small banded graph (n 1500, K3) or the ELL operator past
    32768 nodes (K1b, K3b), on the card."""
    from chip_smoke import synthetic
    from mac_tpu_torch.ops import laplacian

    if route.startswith("banded"):
        idx, w_np, n = _graph(1500, 1200, 25, 3)
        op = banded.build_banded_rcm(idx, n)[0].to(dev)
    else:
        fi, wf, ci, wc = synthetic(40000)
        idx, w_np, n = (np.concatenate([fi, ci]), np.concatenate([wf, wc]),
                        40000)
        op = laplacian.build_operator(idx, n).to(dev)
    ws = [torch.as_tensor(w_np * (0.5 + np.random.RandomState(seed).rand(
        len(w_np))), dtype=dtype, device=dev) for seed in (1, 2)]
    rng = np.random.RandomState(3)
    X = torch.as_tensor(rng.normal(size=(n, q)), dtype=dtype, device=dev)
    xprev0 = torch.as_tensor(rng.normal(size=(n, q)), dtype=dtype,
                             device=dev)
    return op, ws, X, xprev0


@pytest.mark.parametrize("route", ["banded", "banded-f64", "ell",
                                   "banded-q11", "banded-f64-q11"])
def test_replayed_solves_are_bitwise_the_eager_ones(dev, route):
    """Frank-Wolfe-like solves through ops.graphs.solve on the card: the
    banded route a cold build, then a Newton-Schulz refresh and a carried
    state from the state the step before returned (float32 and float64),
    the ELL route a cold build at each weight vector; a block of 4
    columns, or of 11 (q11: the 33 x 33 Rayleigh-Ritz eigensolves in
    K4w). The first round captures both replayed paths' graphs; in the
    second the set-up and outer-iteration graphs' replays must be bitwise
    the eager path (graphs.plain_solve on the card, K4 as in the graphs)
    and the inner-replay path (the inner CG steps alone replayed), with
    the same launches of every kernel wrapper by dtype and of K4 by body,
    K4 among them (K4w at q = 11), and no capture."""
    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.ops.kernels import syev
    from mac_tpu_torch.ops.kernels.tridiag import reset_counts

    dtype = torch.float64 if "f64" in route else torch.float32
    q = 11 if route.endswith("q11") else 4
    op, ws, X0, xprev0 = _solve_inputs(dev, route, dtype, q)
    if route.startswith("banded"):
        rt = graphs.banded_route(op, banded.PRECOND_KIND)
        branches = ("cold", "ns", "carried")
    else:
        rt = graphs.twogrid_route(op)
        branches = ("cold", "cold")
    kw = dict(xprev0=xprev0, tol=1e-8, maxiter=6, inner_iters=4)
    paths = {"graph": graphs.graphed_solve, "eager": graphs.plain_solve,
             "inner": graphs.inner_replayed_solve}
    for rnd, order in enumerate((("graph", "inner"),
                                 ("eager", "graph", "inner", "graph",
                                  "eager"))):
        first, seen = None, set()
        for path in order:
            reset_counts(*graphs.WRAPPERS)
            c0 = rt.captures
            X, carried, outs = X0, None, []
            for step, branch in enumerate(branches):
                res, state = paths[path](
                    rt, ws[step % 2], X,
                    carried=carried if branch != "cold" else None,
                    branch=branch, **kw)
                outs.append((res, state))
                X, carried = res.X, state
            torch.cuda.synchronize()
            if rnd:
                assert rt.captures == c0, path
            counts = tuple((w.__name__, w.launches,
                            tuple(sorted(w.launches_by_dtype.items())),
                            tuple(sorted(w.launches_by_body.items())))
                           for w in graphs.WRAPPERS)
            assert syev.sym_eig.launches > 0
            assert (syev.sym_eig.launches_by_body.get("wide_shared", 0)
                    > 0) == (q == 11)
            seen.add(counts)
            if first is None:
                first = outs
            for (a, sa), (b, sb) in zip(outs, first):
                assert a.iters == b.iters > 0
                assert torch.equal(a.X, b.X) and torch.equal(a.lam, b.lam)
                assert all(torch.equal(sa[n], sb[n]) for n in sa)
        assert len(seen) == 1 or not rnd, seen
    assert rt.redos == 0


def test_fiedler_pair_op_on_cuda_replays_one_graph_per_step_count(dev):
    """A banded TRACEMIN solve on the card replays its graphs: a cold
    solve captures the set-up and the outer iteration and replays the
    set-up once and the outer iteration once an outer iteration; a second
    solve at other weights captures nothing and gives bitwise what the
    eager path gives (graphs.plain_solve on the card)."""
    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.utils.fiedler import fiedler_pair_op

    idx, w_np, n = _graph(1500, 1200, 25, 3)
    bop = banded.build_banded_rcm(idx, n)[0].to(dev)
    X = torch.as_tensor(np.random.RandomState(1).normal(size=(n, 4)),
                        dtype=torch.float32, device=dev)
    kw = dict(maxiter=6, inner_iters=5)
    res = fiedler_pair_op(bop, torch.as_tensor(w_np, dtype=torch.float32,
                                               device=dev), X, **kw)
    rt, = bop.graph_routes.values()
    assert res.iters > 0
    assert (rt.captures, rt.replays) == (2, 1 + res.iters)
    w2 = torch.as_tensor(w_np * (0.5 + np.random.RandomState(2).rand(
        len(w_np))), dtype=torch.float32, device=dev)
    res2 = fiedler_pair_op(bop, w2, X, **kw)
    replays = 2 + res.iters + res2.iters
    assert (rt.captures, rt.replays) == (2, replays)
    real = graphs.graphed_solve
    graphs.graphed_solve = graphs.plain_solve
    try:
        eager = fiedler_pair_op(bop, w2, X, **kw)
    finally:
        graphs.graphed_solve = real
    assert rt.replays == replays
    assert eager.iters == res2.iters
    assert torch.equal(res2.X, eager.X) and torch.equal(res2.lam, eager.lam)


def test_failed_capture_raises(dev):
    """A route whose product reads the host cannot be captured: the solve
    raises and keeps no graph (nothing falls back to the eager loop)."""
    from mac_tpu_torch.ops import graphs

    def prepare(s, branch, guards):
        return {"d": s["w"] * 1.0}, s["w"].abs().amax()

    def build(state):
        return ((lambda V: V * float(V.abs().sum()) + state["d"][:, None]),
                (lambda R: R))

    rt = graphs.Route(prepare, build, tuple, ("d",))
    w = torch.ones(64, device=dev)
    X = torch.as_tensor(np.random.RandomState(0).normal(size=(64, 4)),
                        dtype=torch.float32, device=dev)
    with pytest.raises(RuntimeError, match="capturing the solve's graph"):
        graphs.graphed_solve(rt, w, X, xprev0=X, maxiter=2, inner_iters=2)
    assert rt.captures == 0 and not rt.graphs
    torch.cuda.synchronize()


# K4's shapes: TRACEMIN's, a batch that leaves the last block of four
# matrices partial (67), and a batch of three at every k from 1 to 32: the
# warp body's every instantiation (even m = 2 ... 32) and the odd k padded
# beside each; K4w's: TRACEMIN's 33 x 33 (q = 11) and the lanes' (2, 36,
# 36) (q = 12), odd and even orders in shared memory, and 170 / 180 (float32)
# and 120 / 130 (float64) past it, on the workspace.
_K4_SHAPES = ([(4, 4), (12, 12), (5, 12, 12), (67, 12, 12), (32, 32),
               (2, 31, 31)] + [(3, k, k) for k in range(1, 33)]
              + [(33, 33), (3, 33, 33), (2, 36, 36), (5, 47, 47), (64, 64),
                 (96, 96), (118, 118), (2, 120, 120), (130, 130),
                 (170, 170), (180, 180)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", _K4_SHAPES)
def test_sym_eig_kernel_matches_plain_and_eigh(dev, shape, dtype):
    """K4 against its plain version on the card and torch.linalg.eigh
    (random symmetric matrices): eigenvalues within 2 k eps ||H|| of both,
    ascending; residual within 2 k eps ||H|| and V^T V within 2 k eps of
    I; each column's largest entry positive; one launch a call, counted
    with the batch as lanes and under the body body_for names."""
    from mac_tpu_torch.ops.kernels import syev

    k = shape[-1]
    rng = np.random.RandomState(k)
    A = rng.normal(size=shape)
    H = torch.as_tensor(A + np.swapaxes(A, -1, -2), dtype=dtype, device=dev)
    before = syev.sym_eig.launches
    lanes = syev.sym_eig.launches_by_lanes.get(H.numel() // k ** 2, 0)
    body = syev.body_for(k, dtype)
    by_body = syev.sym_eig.launches_by_body.get(body, 0)
    e, V = syev.sym_eig(H)
    torch.cuda.synchronize()
    assert syev.sym_eig.launches == before + 1
    assert syev.sym_eig.launches_by_lanes[H.numel() // k ** 2] == lanes + 1
    assert syev.sym_eig.launches_by_body[body] == by_body + 1
    ep, _ = syev.sym_eig_plain(H)
    el, _ = torch.linalg.eigh(H)
    eps = torch.finfo(dtype).eps
    hn = torch.linalg.matrix_norm(H).amax()
    tol = 2 * k * eps * float(hn)
    assert float((e - ep).abs().max()) <= tol
    assert float((e - el).abs().max()) <= tol
    assert bool((e[..., 1:] >= e[..., :-1]).all())
    resid = torch.linalg.matrix_norm(H @ V - V * e[..., None, :])
    assert float(resid.max()) <= tol
    eye = torch.eye(k, dtype=dtype, device=dev)
    assert float((V.mT @ V - eye).abs().max()) <= 2 * k * eps
    top = V.gather(-2, V.abs().argmax(dim=-2, keepdim=True))
    assert bool((top > 0).all())


def test_sym_eig_kernel_refuses_what_it_does_not_take(dev):
    """A dtype other than float32 / float64, a non-contiguous or
    non-square tensor, the warp body forced past 32, K4w forced into
    shared memory past its limit and an unknown body raise on the card:
    no fallback to eigh. Any order runs (33 included)."""
    from mac_tpu_torch.ops.kernels import syev

    for H, err, body in (
            (torch.zeros(4, 4, device=dev, dtype=torch.float16), TypeError,
             None),
            (torch.zeros(8, 8, device=dev)[:4, :4], ValueError, None),
            (torch.zeros(4, 5, device=dev), ValueError, None),
            (torch.zeros(33, 33, device=dev), ValueError, "warp"),
            (torch.zeros(130, 130, device=dev, dtype=torch.float64),
             RuntimeError, "wide_shared"),
            (torch.zeros(4, 4, device=dev), ValueError, "rows")):
        with pytest.raises(err):
            syev.sym_eig(H, body=body)
    e, V = syev.sym_eig(torch.eye(33, device=dev))
    torch.cuda.synchronize()
    assert torch.equal(e, torch.ones(33, device=dev))
    assert torch.equal(V, torch.eye(33, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33, 33), (3, 34, 34), (2, 47, 47),
                                   (64, 64), (96, 96), (118, 118)])
def test_k4w_storage_forms_are_bitwise_equal(dev, shape, dtype):
    """K4w with A and V in shared memory and on the workspace (forced by
    body="wide_workspace"): one body over one layout, so bitwise the same
    eigenvalues and vectors; each form counted under its own body."""
    from mac_tpu_torch.ops.kernels import syev

    k = shape[-1]
    rng = np.random.RandomState(k + 1)
    A = rng.normal(size=shape)
    H = torch.as_tensor(A + np.swapaxes(A, -1, -2), dtype=dtype, device=dev)
    assert syev.body_for(k, dtype) == "wide_shared"
    before = dict(syev.sym_eig.launches_by_body)
    e1, V1 = syev.sym_eig(H)
    e2, V2 = syev.sym_eig(H, body="wide_workspace")
    torch.cuda.synchronize()
    assert torch.equal(e1, e2) and torch.equal(V1, V2)
    for body in ("wide_shared", "wide_workspace"):
        assert syev.sym_eig.launches_by_body[body] == before.get(body, 0) + 1


@pytest.mark.parametrize("k, dtype", [(168, torch.float32),
                                      (169, torch.float32),
                                      (118, torch.float64),
                                      (119, torch.float64)])
def test_k4w_sizing_at_the_shared_memory_edge(dev, k, dtype):
    """K4w's shared-memory form at the largest order whose blocks fit (168
    float32, 118 float64, as before) and just past it: syev.cu's
    shared bytes a block, workspace bytes and threads against the
    wrapper's, the body body_for picks; at the edge both forms run the
    cluster and agree bit for bit, past it the shared form is refused and
    the workspace form runs."""
    import ctypes

    from mac_tpu_torch.ops.kernels import _build, syev

    lib = _build.load("syev", syev._SIGNATURES)
    suffix = "f32" if dtype == torch.float32 else "f64"
    itemsize = 4 if dtype == torch.float32 else 8
    for what, py in (("smem", syev.wide_smem_bytes),
                     ("scratch", syev.wide_scratch_bytes)):
        fn = getattr(lib, f"sym_eig_wide_{what}_bytes_{suffix}")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        assert fn(k) == py(k, itemsize)
    lib.sym_eig_wide_threads.argtypes = [ctypes.c_int]
    assert lib.sym_eig_wide_threads(k) == 896
    fits = syev.wide_smem_bytes(k, itemsize) <= syev.SMEM_LIMIT
    assert fits == (k in (168, 118))
    assert syev.body_for(k, dtype) == ("wide_shared" if fits
                                       else "wide_workspace")
    rng = np.random.RandomState(k)
    A = rng.normal(size=(k, k))
    H = torch.as_tensor(A + A.T, dtype=dtype, device=dev)
    e2, V2 = syev.sym_eig(H, body="wide_workspace")
    if fits:
        e1, V1 = syev.sym_eig(H, body="wide_shared")
        torch.cuda.synchronize()
        assert torch.equal(e1, e2) and torch.equal(V1, V2)
    else:
        with pytest.raises(RuntimeError):
            syev.sym_eig(H, body="wide_shared")
    el = torch.linalg.eigvalsh(H)
    tol = 2 * k * torch.finfo(dtype).eps * float(torch.linalg.matrix_norm(H))
    assert float((e2 - el).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(33, 33), (2, 36, 36), (96, 96),
                                   (180, 180)])
def test_k4w_phase_stamps_run_the_kernels_arithmetic(dev, shape, dtype):
    """sym_eig_wide_phases_* (chip_smoke.k4w_phases reads it): the stamped
    build's eigenpairs are bitwise the kernel's, in either storage form,
    and its clock lists body 2's ten phases, the sweeps and rounds this H
    takes (rounds = sweeps (m - 1)), a positive span; no launch counted."""
    from chip_smoke import K4W_PHASES, k4w_phases
    from mac_tpu_torch.ops.kernels import syev

    k = shape[-1]
    rng = np.random.RandomState(k + 7)
    A = rng.normal(size=shape)
    H = torch.as_tensor(A + np.swapaxes(A, -1, -2), dtype=dtype, device=dev)
    for body in ("wide_shared", "wide_workspace"):
        if syev.body_for(k, dtype) != "wide_shared" and body == "wide_shared":
            continue
        e, V = syev.sym_eig(H, body=body)
        before = syev.sym_eig.launches
        e_s, V_s, clk = syev.wide_phases(H, body)
        torch.cuda.synchronize()
        assert syev.sym_eig.launches == before
        assert torch.equal(e, e_s) and torch.equal(V, V_s)
        clk = clk.cpu().tolist()
        m = k + k % 2
        assert clk[0] == 10 and clk[13] == 2
        assert 1 <= clk[11] < syev.MAX_SWEEPS
        assert clk[12] == clk[11] * (m - 1)
        assert clk[14] > 0 and clk[15] > 0
    rows, info = k4w_phases(H)
    assert [name for name, *_ in rows] == [
        name for name, _ in K4W_PHASES[2]] + ["whole"]
    first = H.reshape(-1, k, k)[:1]
    assert info["rounds"] == syev.jacobi_sweeps(first) * (m - 1)


def _k4_lane_counts(run):
    """run() with torch.linalg.eigh counted (chip_smoke.EighCalls): its
    return value, the eigh calls, and K4's launches in it by lane count."""
    from chip_smoke import EighCalls
    from mac_tpu_torch.ops.kernels import syev

    before = dict(syev.sym_eig.launches_by_lanes)
    with EighCalls() as eigh:
        out = run()
    torch.cuda.synchronize()
    return out, eigh.calls, {
        r: c - before.get(r, 0)
        for r, c in syev.sym_eig.launches_by_lanes.items()
        if c > before.get(r, 0)}


def test_tracemin_lanes_on_cuda_launch_k4_once_per_batch(dev):
    """GreedyEig's trial chunk on the card (64 lanes, float32, ELL, float64
    coefficients): every Rayleigh-Ritz eigensolve of TRACEMIN's lanes is one
    K4 launch on the whole batch, at the entry and once an outer
    iteration (no launch on fewer lanes), and torch.linalg.eigh is never
    called; the lanes' lambda_2 stay at or above the incumbent's."""
    from chip_smoke import chain_instance
    from mac_tpu_torch.solvers import GreedyEig

    fixed, cands = chain_instance(1200, 600, 3)
    g = GreedyEig(fixed, cands, 1200)
    x = np.zeros(len(cands))
    x[:400] = 1.0
    lam, X = g._eval(x, g._X0)
    (lams, Xs), calls, by_lanes = _k4_lane_counts(
        lambda: g._eval_chunk(x, np.arange(400, 464), X))
    assert calls == 0
    assert set(by_lanes) == {64} and by_lanes[64] >= 2
    assert np.all(np.isfinite(lams))
    assert np.all(lams >= float(lam) * (1 - 5e-4))


def test_sweep_lanes_on_cuda_launch_k4_per_lane_batch(dev):
    """A banded float32 sweep of 3 budgets on the card sends TRACEMIN's
    Rayleigh-Ritz eigensolves to K4 with 3 lanes and never to
    torch.linalg.eigh; each lane rounds to exactly k."""
    from mac_tpu_torch.solvers import MAC

    idx, w, n = _graph(1500, 1200, 25, 3)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    m = len(cands[1])
    ks = [m // 4, m // 2, 3 * m // 4]
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              device="cuda")
    (rounded, unrounded, _), calls, by_lanes = _k4_lane_counts(
        lambda: mac.solve_sweep(ks))
    assert calls == 0
    assert by_lanes.get(3, 0) >= 2
    assert [int(r.sum()) for r in rounded] == ks
    assert np.all(np.isfinite(unrounded))


# TRACEMIN's inner CG step on the card: K5 (the banded product), K6 (the
# PCG update with fixed-order column sums), K1p (K1's permuted entry) and K7
# (the coarse correction), each against its plain version (float32 1e-5,
# float64 1e-12 relative in norm; K1p at K1's own tolerance, and bitwise K1
# on the gathered input), two calls bitwise equal.
_CG_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel(got, ref):
    return float(torch.linalg.vector_norm((got - ref).double())
                 / torch.linalg.vector_norm(ref.double()))


def _banded_case(dev, dtype, wide=False, lanes=None):
    """(operator, BD, w) of a banded graph on the card: n 1500 after RCM
    (half 1, the overflow split), or n 1000 in the original order (half
    2); with lanes, a weight vector per lane."""
    idx, w_np, n = _graph(1000, 400, 200, 3) if wide else _graph(
        1500, 1200, 25, 3)
    op = (banded.build_banded(idx, n) if wide
          else banded.build_banded_rcm(idx, n)[0]).to(dev)
    assert op.half == (2 if wide else 1)
    rng = np.random.RandomState(5)
    if lanes:
        w_np = w_np * (0.5 + rng.rand(lanes, len(w_np)))
    w = torch.as_tensor(w_np, dtype=dtype, device=dev)
    return op, banded.assemble_bd(op, w), w


def _twice(fn):
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wide,q,lanes", [
    (False, 4, None), (False, 12, None), (False, 1, None), (False, 40, None),
    (False, "nc", None), (True, 4, None), (True, 33, None), (False, 4, 2),
    (False, 11, None), (True, 11, None), (False, 33, None),
    (False, "rmat", None), (True, "rmat", None)])
@pytest.mark.parametrize("form", ["plain", "residual", "inner"])
def test_k5_matches_plain_and_repeats(dev, dtype, wide, q, lanes, form):
    """K5 in each form (with the column dots in the inner one) on the
    narrow and wide bodies, half 1 and 2, lanes, against its plain
    version; V random, or ("rmat") the coarse assembly's input, the
    aggregates' indicator."""
    from mac_tpu_torch.ops.kernels import banded as kb
    from mac_tpu_torch.ops.kernels import pcg as kp

    op, BD, _ = _banded_case(dev, dtype, wide, lanes)
    rng = np.random.RandomState(6)
    lead = (lanes,) if lanes else ()
    if q == "rmat":
        agg = op.agg[:op.n].long()
        V = (agg[:, None] == torch.arange(op.coarse_nc, device=dev)[None, :]
             ).to(dtype)
        q = op.coarse_nc
    else:
        q = op.coarse_nc if q == "nc" else q
        V = torch.as_tensor(rng.normal(size=lead + (op.n, q)), dtype=dtype,
                            device=dev)
    kw = {}
    if form == "residual":
        B = torch.as_tensor(rng.normal(size=V.shape), dtype=dtype, device=dev)
        kw = dict(B=B, bsum=kp.col_sums(B))
    elif form == "inner":
        c = (2.0 * BD.deg.amax(dim=(-2, -1))).to(dtype)
        kw = dict(vsum=kp.col_sums(V), c=c, sigma=1e-3 * c, dot=True)
    before = kb.banded_product.launches
    got = _twice(lambda: kb.banded_product(BD.ut, BD.deg, V, op.n, **kw))
    assert kb.banded_product.launches == before + 2
    ref = kb.banded_product_plain(BD.ut, BD.deg, V, op.n, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for x, y in zip(got, ref):
        assert _rel(x, y) <= _CG_TOL[dtype], (_rel(x, y), form)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10000, 4), (3, 2500, 12), (257, 1),
                                   (600, 300)])
def test_k6_passes_match_plain_and_repeat(dev, dtype, shape):
    """K6's column sums (of A; of A M with M centred; bitwise their order's
    numpy model, block_sum_model), first pass (alpha, X, R and R's sums)
    and second with the dots (rz_new, beta, P, rz and P's sums; and the
    first step's P = Z) against their plain versions."""
    from mac_tpu_torch.ops.kernels import pcg as kp

    rng = np.random.RandomState(7)

    def rand(*s, dt=dtype):
        return torch.as_tensor(rng.normal(size=s), dtype=dt, device=dev)

    A, M, X0, R0, P0, AP, Z = (rand(*shape) for _ in range(7))
    qs = shape[:-2] + shape[-1:]
    rz0, pap = rand(*qs), rand(*qs, dt=torch.float64)
    msum = kp.col_sums(M)
    tol = _CG_TOL[dtype]
    for kern, plain in ((lambda: kp.col_sums(A),
                         lambda: kp.col_sums_plain(A)),
                        (lambda: kp.col_sums(A, M, msum),
                         lambda: kp.col_sums_plain(A, M, msum))):
        got = _twice(kern)[0]
        assert _rel(got, plain()) <= tol
    if len(shape) == 2 and shape[0] * shape[1] <= 40000:
        Mc = M - (msum / shape[0]).to(dtype)
        rows = kp.rows_of(*shape)
        for got, vals in ((kp.col_sums(A), A), (kp.col_sums(A, M, msum),
                                                 A * Mc)):
            want = kp.block_sum_model(vals.cpu().numpy(), rows=rows)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
    for init in (False, True):
        outs = []
        for fn in ((kp.cg_update, kp.cg_direction_dots),
                   (kp.cg_update_plain, kp.cg_direction_dots_plain)):
            X, R, P, rz = X0.clone(), R0.clone(), P0.clone(), rz0.clone()
            rs = fn[0](X, R, P, AP, rz, pap, sums=True)
            ps, rz_new = fn[1](P, R, Z, msum, rz, init=init, sums=True)
            outs.append((X, R, rs, P, rz, ps, rz_new))
        for x, y in zip(*outs):
            assert _rel(x, y) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(10000, 4), (8, 10000, 4), (10000, 11),
                                   (257, 1), (3, 2500, 12), (64, 10000, 4),
                                   (100000, 4)])
@pytest.mark.parametrize("centred", [False, True])
def test_k6_direction_dots_matches_plain_and_repeats(dev, dtype, shape,
                                                     centred):
    """K6's second pass with the dots (one cooperative launch: the dots R .
    Z, Z centred by zsum / n, then beta, P, rz and P's sums) against
    col_sums_plain followed by cg_direction_plain, at the first step and
    after it, with and without P's sums: two calls bitwise, rz_new bitwise col_sums(R, Z, zsum) (the
    same items in the same order), counted under its own wrapper; (64,
    10000, 4) has more items than the card holds blocks, so its blocks
    loop over items."""
    from mac_tpu_torch.ops.kernels import pcg as kp

    rng = np.random.RandomState(8)
    P0, R, Z, M = (torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                                   device=dev) for _ in range(4))
    rz0 = torch.as_tensor(rng.normal(size=shape[:-2] + shape[-1:]),
                          dtype=dtype, device=dev)
    # Z less the means of another block, so that P's sums stay clear of 0
    # (a relative error of sums that cancel to rounding says nothing).
    zsum = kp.col_sums(M) if centred else None
    tol = _CG_TOL[dtype]
    for init in (False, True):
        for sums in (True, False):
            P, rz = P0.clone(), rz0.clone()

            def run(P=P, rz=rz, init=init, sums=sums):
                P.copy_(P0)
                rz.copy_(rz0)
                psum, rz_new = kp.cg_direction_dots(P, R, Z, zsum, rz,
                                                    init=init, sums=sums)
                assert (psum is None) == (not sums)
                return (P, rz, rz_new) + ((psum,) if sums else ())

            before = kp.cg_direction_dots.launches
            got = _twice(run)
            assert kp.cg_direction_dots.launches == before + 2
            assert torch.equal(got[2], kp.col_sums(R, Z, zsum))
            Pp, rzp = P0.clone(), rz0.clone()
            psum, rz_new = kp.cg_direction_dots_plain(Pp, R, Z, zsum, rzp,
                                                      init=init, sums=sums)
            want = (Pp, rzp, rz_new) + ((psum,) if sums else ())
            for x, y in zip(got, want):
                assert _rel(x, y) <= tol, (init, sums)


def test_k6_direction_dots_replays_in_a_graph(dev):
    """The cooperative launch of K6's second pass, captured in a CUDA graph
    with K6's first pass and replayed, gives the eager bits, step after
    step (its generation word moves on at each replay)."""
    from mac_tpu_torch.ops.kernels import pcg as kp

    rng = np.random.RandomState(12)
    X0, R0, P0, AP, Z = (torch.as_tensor(rng.normal(size=(10000, 4)),
                                         dtype=torch.float32, device=dev)
                         for _ in range(5))
    rz0 = torch.as_tensor(rng.rand(4) + 0.5, dtype=torch.float32, device=dev)
    pap = torch.as_tensor(rng.rand(4) + 0.5, dtype=torch.float64, device=dev)
    zsum = kp.col_sums(Z)
    X, R, P, rz = X0.clone(), R0.clone(), P0.clone(), rz0.clone()

    def reset():
        for a, b in ((X, X0), (R, R0), (P, P0), (rz, rz0)):
            a.copy_(b)

    def step():
        kp.cg_update(X, R, P, AP, rz, pap)
        return kp.cg_direction_dots(P, R, Z, zsum, rz, sums=True)

    reset()
    eager = []
    for _ in range(3):
        psum, rz_new = step()
        eager.append(tuple(t.clone() for t in (X, R, P, rz, psum, rz_new)))
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        reset()
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    reset()
    with torch.cuda.graph(graph):
        outs = step()
    reset()
    for want in eager:
        graph.replay()
        torch.cuda.synchronize(dev)
        got = (X, R, P, rz, *outs)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,q,lanes", [(1500, 4, None), (1500, 4, 3),
                                       (33000, 40, None), (1500, 130, None),
                                       (10000, 4, None)])
@pytest.mark.parametrize("body", ["cluster", "segment"])
def test_k1p_is_k1_on_the_gathered_input(dev, dtype, n, q, lanes, body):
    """K1p, centring by B's sums, storing through the permutation, then
    adding into X with its column sums, in both bodies: the cluster body
    (an exact factor) bitwise K1 on the gathered, centred input scattered
    back, the segment body (a factor decoupled every 128 rows, seg 128)
    bitwise K1b at block 128 on it; each within 1e-5 (float32) or 1e-12
    (float64) of the plain version (the cluster body's tiled branch at
    (33000, 40), column groups at q 130, lanes with a factor each); the
    segment body's column sums bitwise its order's numpy model
    (k1p_segment_sum_model) on the X it wrote."""
    from mac_tpu_torch.ops.kernels import pcg as kp
    from mac_tpu_torch.ops.kernels.tridiag import (
        k1p_segment_sum_model, tridiag_solve_permuted_plain)

    seg = None if body == "cluster" else 128
    d, e, rng = _chain(n, 21, dev)
    d, e = d.to(dtype), e.to(dtype)
    if lanes:
        d = d * torch.as_tensor(1.0 + rng.rand(lanes, 1), dtype=dtype,
                                device=dev)
        e = e.expand(lanes, -1).contiguous()
    f = tridiag_ldl(d, e) if seg is None else tridiag_ldl_blocked(d, e, seg)
    lead = (lanes,) if lanes else ()
    perm = torch.as_tensor(rng.permutation(n), dtype=torch.int32,
                           device=dev)
    iperm = torch.empty_like(perm)
    iperm[perm.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    B = torch.as_tensor(rng.normal(size=lead + (n, q)), dtype=dtype,
                        device=dev)
    X0 = torch.as_tensor(rng.normal(size=B.shape), dtype=dtype, device=dev)
    bsum = kp.col_sums(B)
    counts = dict(tridiag_solve_permuted.launches_by_body)
    x = _twice(lambda: tridiag_solve_permuted(f.dp, f.l, B, iperm, perm,
                                              bsum=bsum, seg=seg))[0]
    assert tridiag_solve_permuted.launches_by_body[body] == \
        counts.get(body, 0) + 2
    m = (bsum / torch.full_like(bsum, n)).to(dtype).unsqueeze(-2)
    Bn = (B[..., iperm.long(), :] - m).contiguous()
    solved = (tridiag_solve(f.dp, f.l, Bn) if seg is None
              else tridiag_solve_blocked(f.dp, f.l, Bn, block=seg))
    assert torch.equal(x, solved[..., perm.long(), :])
    tol = _CG_TOL[dtype]
    ref = tridiag_solve_permuted_plain(f.dp, f.l, B, iperm, perm, bsum=bsum,
                                       seg=seg)
    assert _rel(x, ref) <= tol
    X = X0.clone()
    got, s = tridiag_solve_permuted(f.dp, f.l, B, iperm, perm, X=X,
                                    sums=True, seg=seg)
    assert got is X
    want, s_ref = tridiag_solve_permuted_plain(f.dp, f.l, B, iperm, perm,
                                               X=X0, sums=True, seg=seg)
    assert _rel(got, want) <= tol and _rel(s, s_ref) <= tol
    if seg is not None:
        # X's rows in chain order (row j at iperm[j]), as the body sums them.
        vals = got.cpu().numpy().reshape((-1, n, q))[:, iperm.cpu().long()]
        model = np.stack([k1p_segment_sum_model(v, seg) for v in vals])
        np.testing.assert_array_equal(s.cpu().numpy().reshape(model.shape),
                                      model)
    X = X0.clone()
    again = tridiag_solve_permuted(f.dp, f.l, B, iperm, perm, X=X, sums=True,
                                   seg=seg)
    assert torch.equal(again[0], got) and torch.equal(again[1], s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes,q,shared", [
    (None, 4, False), (2, 4, False), (2, 4, True), (None, 40, False),
    (None, 11, False), (None, 12, False), (2, 11, False), (2, 12, True)])
def test_k7_matches_plain_and_repeats(dev, dtype, lanes, q, shared):
    """K7 (restrict, then the coarse product and the prolong-add into x)
    on a banded operator's aggregates against its plain version,
    with a coarse inverse per lane or one shared by the lanes (shared), at
    the CG step's q 4, 11 and 12 and past a cluster's column tile (40)."""
    from mac_tpu_torch.ops.kernels import banded as kb

    op, BD, w = _banded_case(dev, dtype, lanes=lanes)
    M = banded.make_banded_precond(op, BD, w=w)
    Lc_inv = M.Lc_inv[0].contiguous() if shared else M.Lc_inv
    lead = (lanes,) if lanes else ()
    rng = np.random.RandomState(9)
    r = torch.as_tensor(rng.normal(size=lead + (op.n, q)), dtype=dtype,
                        device=dev)
    x0 = torch.as_tensor(rng.normal(size=r.shape), dtype=dtype, device=dev)
    before = kb.coarse_correct.launches
    got = _twice(lambda: kb.coarse_correct(r, x0.clone(), op.iperm, op.perm,
                                           Lc_inv, op.coarse_s))[0]
    assert kb.coarse_correct.launches == before + 2
    ref = kb.coarse_correct_plain(r, x0, op.iperm, op.perm, Lc_inv,
                                  op.coarse_s)
    assert _rel(got, ref) <= _CG_TOL[dtype]


def test_cg_kernels_refuse_what_they_do_not_take(dev):
    """A wrong dtype, a non-contiguous block or mixed devices raise; none
    falls back to a plain version."""
    from mac_tpu_torch.ops.kernels import banded as kb
    from mac_tpu_torch.ops.kernels import pcg as kp

    op, BD, _ = _banded_case(dev, torch.float32)
    V = torch.zeros(op.n, 4, device=dev)
    with pytest.raises(TypeError):
        kb.banded_product(BD.ut, BD.deg, V.double(), op.n)
    with pytest.raises(ValueError):
        kb.banded_product(BD.ut, BD.deg, V.cpu(), op.n)
    with pytest.raises(ValueError):
        kp.col_sums(torch.zeros(4, op.n, device=dev).T)
    with pytest.raises(TypeError):
        kp.col_sums(V.half())
    with pytest.raises(ValueError):
        tridiag_solve_permuted(V[:, 0], V[:, 0], V, op.iperm.long(), op.perm)


def test_city_shaped_inner_solve_replays_in_few_kernels(dev):
    """A replayed inner solve (graphs.inner_replay) on city10000's banded
    operator at its start weights: bitwise the eager kernel loop (K5's
    inner form, K6, the V-cycle's K1p, K5 and K7), within 1e-4 relative of
    the plain PyTorch loop (pcg_fixed_plain over the plain cycle), and one
    CG step of chip_smoke.STEP_KERNELS device kernels (6 steps less 5,
    profiled)."""
    from chip_smoke import STEP_KERNELS, dataset_inputs, device_items
    from mac_tpu_torch.ops import graphs
    from mac_tpu_torch.ops.cg import pcg_fixed, pcg_fixed_plain

    _, n, _, _, _, _, bop, w, _, _, _ = dataset_inputs(dev)
    route = graphs.banded_route(bop, banded.PRECOND_KIND)
    BD = banded.assemble_bd(bop, w)
    M, st = banded.make_banded_precond(bop, BD, w=w, return_state=True)
    c = 2.0 * BD.deg.amax()
    sigma = 32 * torch.finfo(torch.float32).eps * c
    state = dict(graphs.banded_state(BD, st), c=c, sigma=sigma)
    rng = np.random.RandomState(13)
    B = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32,
                        device=dev)
    X0 = 0.1 * B
    inner = banded.BandedProduct(bop, BD).shifted(c, sigma)
    eager = pcg_fixed(inner, B, M, iters=5, X0=X0)
    got = graphs.inner_replay(route, state, B, X0, 5)
    assert torch.equal(got, eager)
    from mac_tpu_torch.ops.kernels.banded import banded_product_plain

    plain = pcg_fixed_plain(
        lambda V: banded_product_plain(BD.ut, BD.deg, V, n, c=c,
                                       sigma=sigma), B, M.plain, iters=5,
        X0=X0)
    assert _rel(got, plain) <= 1e-4
    got = []
    for iters in (5, 6):
        graphs.inner_replay(route, state, B, X0, iters)
        torch.cuda.synchronize()
        got.append(device_items(
            lambda: graphs.inner_replay(route, state, B, X0, iters)))
    step = {}  # the device items one more step adds, by name
    for sign, (_, _, items) in zip((-1, 1), got):
        for _, cnt, name in items:
            step[name[:70]] = step.get(name[:70], 0) + sign * cnt
    assert got[1][1] - got[0][1] == STEP_KERNELS, {
        name: cnt for name, cnt in step.items() if cnt}


# The matrix-free route's CG step on the card: K8 (the ELL product in its
# forms) and its V-cycle's K1p and K7 through the identity permutation
# (ops.twogrid.EllVCycle), each against its plain version (float32 1e-5,
# float64 1e-12 relative in norm), two calls bitwise equal.
def _ell_graph(n, kind):
    """(edge index, weights) of a test graph for K8: "full", a chain whose
    nodes 0 mod 32 each join 16 nodes 5 mod 32 (n a multiple of 32; each
    of those joined by 16, so that every warp of 32 rows walks to dmax,
    18), or "chain", the chain alone (dmax 2)."""
    rng = np.random.RandomState(21)
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    if kind == "full":
        hubs = np.arange(0, n, 32)
        far = (hubs[:, None] + 5 + 64 * np.arange(16)[None, :]) % n
        idx = np.concatenate([idx, np.stack(
            [np.repeat(hubs, 16), far.reshape(-1)], 1)])
    return idx, 0.5 + rng.rand(len(idx))


def _ell_case(dev, dtype, n, lanes=None, shared=False, kind="expander"):
    """(operator, weights) of chip_smoke.synthetic(n) on the card: the
    expander-like graph of the n = 100000 route at its full weights; with
    lanes and not shared, a weight vector per lane; kind "full" or "chain"
    one of _ell_graph's instead."""
    from chip_smoke import synthetic
    from mac_tpu_torch.ops import laplacian

    if kind == "expander":
        fi, wf, ci, wc = synthetic(n)
        idx, w_np = np.concatenate([fi, ci]), np.concatenate([wf, wc])
    else:
        idx, w_np = _ell_graph(n, kind)
    op = laplacian.build_operator(idx, n, mode="ell").to(dev)
    if lanes and not shared:
        w_np = w_np * (0.5 + np.random.RandomState(5).rand(lanes, len(w_np)))
    return op, torch.as_tensor(w_np, dtype=dtype, device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,q,lanes,shared,kind", [
    (40000, 4, None, False, "expander"), (40000, 12, None, False, "expander"),
    (40000, 1, None, False, "expander"), (40000, 3, None, False, "expander"),
    (40000, 4, 2, False, "expander"), (40000, 4, 2, True, "expander"),
    (1728, 256, None, False, "expander"), (1000, 600, None, False, "expander"),
    (40000, 4, None, False, "full"), (40000, 4, None, False, "chain"),
    (1728, 256, None, False, "chain")])
@pytest.mark.parametrize("form", ["plain", "residual", "inner"])
def test_k8_matches_plain_and_repeats(dev, dtype, n, q, lanes, shared, kind,
                                      form):
    """K8 in each form (with the column dots in the inner one) against its
    plain version: q 4 (16-byte rows), 12, 1 and 3 (element loads), lanes
    with a table each or one shared, GreedyEig's (1728, 256) flat block
    and 600 columns (two column tiles); a graph whose every warp walks to
    dmax (_ell_graph "full") and a chain (dmax 2); the dots bitwise their
    order's numpy model (ell.dot_model) up to 16 columns."""
    from mac_tpu_torch.ops import laplacian
    from mac_tpu_torch.ops.kernels import ell as k8
    from mac_tpu_torch.ops.kernels import pcg as kp

    op, w = _ell_case(dev, dtype, n, lanes, shared, kind)
    cnt = op.slot_count.cpu()
    dmax = op.slot_nbr.shape[0]
    if kind == "full":  # every warp's largest count is dmax
        assert (cnt.reshape(-1, 32).amax(1) == dmax).all()
    elif kind == "chain":
        assert dmax == 2
    w_tbl = laplacian.lap_weight_table(op, w)
    rng = np.random.RandomState(6)
    lead = (lanes,) if lanes else ()
    V = torch.as_tensor(rng.normal(size=lead + (n, q)), dtype=dtype,
                        device=dev)
    kw = {}
    if form == "residual":
        B = torch.as_tensor(rng.normal(size=V.shape), dtype=dtype, device=dev)
        kw = dict(B=B, bsum=kp.col_sums(B))
    elif form == "inner":
        c = laplacian.lap_inf_norm(op, w).to(dtype)
        kw = dict(vsum=kp.col_sums(V), c=c, sigma=1e-3 * c, dot=True)
    before = k8.ell_product.launches
    tables = (op.slot_nbr, op.slot_count, w_tbl)
    got = _twice(lambda: k8.ell_product(*tables, V, **kw))
    assert k8.ell_product.launches == before + 2
    ref = k8.ell_product_plain(*tables, V, **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for x, y in zip(got, ref):
        assert _rel(x, y) <= _CG_TOL[dtype], (_rel(x, y), form)
    if form == "inner" and q <= 16:
        prod = (V * got[0]).cpu().numpy().reshape(-1, n, q)
        want = np.stack([k8.dot_model(p) for p in prod])
        np.testing.assert_array_equal(got[1].cpu().numpy().reshape(
            want.shape), want)


def test_k8_refuses_what_it_does_not_take(dev):
    """An int64 neighbour or count table, a row-major weight table,
    float16, mixed dtypes or devices, a non-contiguous block and an inner
    form without V's sums raise; none falls back to the plain version."""
    from mac_tpu_torch.ops import laplacian
    from mac_tpu_torch.ops.kernels import ell as k8

    op, w = _ell_case(dev, torch.float32, 6000)
    w_tbl = laplacian.lap_weight_table(op, w)
    V = torch.zeros(op.n, 4, device=dev)
    nbr, cnt = op.slot_nbr, op.slot_count
    for bad in ((nbr.long(), cnt, w_tbl), (nbr, cnt.long(), w_tbl),
                (nbr, cnt, w_tbl.T.contiguous()), (nbr, cnt.cpu(), w_tbl)):
        with pytest.raises(ValueError):
            k8.ell_product(*bad, V)
    with pytest.raises(TypeError):
        k8.ell_product(nbr, cnt, w_tbl.half(), V.half())
    with pytest.raises(TypeError):
        k8.ell_product(nbr, cnt, w_tbl, V.double())
    with pytest.raises(ValueError):
        k8.ell_product(nbr, cnt, w_tbl.cpu(), V)
    with pytest.raises(ValueError):
        k8.ell_product(nbr, cnt, w_tbl, torch.zeros(4, op.n, device=dev).T)
    with pytest.raises(ValueError):
        k8.ell_product(nbr, cnt, w_tbl, V, c=torch.ones((), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_replayed_graph_is_bitwise_the_eager_call(dev, dtype):
    """K8's inner form with its dots and its residual form captured in a
    CUDA graph (two launches): each replay, at new inputs copied into the
    captured ones, is bitwise the eager call on those inputs (the dots'
    ticket left at 0 by every launch)."""
    from mac_tpu_torch.ops import laplacian
    from mac_tpu_torch.ops.kernels import ell as k8
    from mac_tpu_torch.ops.kernels import pcg as kp

    op, w = _ell_case(dev, dtype, 40000)
    w_tbl = laplacian.lap_weight_table(op, w)
    c = laplacian.lap_inf_norm(op, w).to(dtype)
    tables = (op.slot_nbr, op.slot_count, w_tbl)
    rng = np.random.RandomState(19)

    def rand():
        return torch.as_tensor(rng.normal(size=(op.n, 4)), dtype=dtype,
                               device=dev)

    V, B = rand(), rand()

    def both():
        inner = k8.ell_product(*tables, V, vsum=kp.col_sums(V), c=c,
                               sigma=1e-3 * c, dot=True)
        return inner + (k8.ell_product(*tables, V, B=B,
                                       bsum=kp.col_sums(B)),)

    both()  # the ticket and the library before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = k8.ell_product.launches
    with torch.cuda.graph(g):
        outs = both()
    captured = k8.ell_product.launches - before
    assert captured == 2
    for _ in range(3):
        V.copy_(rand())
        B.copy_(rand())
        g.replay()
        torch.cuda.synchronize()
        want = both()
        for x, y in zip(outs, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,q,lanes", [(40000, 4, None), (6000, 4, None),
                                       (1728, 256, None), (40000, 4, 2)])
def test_ell_cycle_kernels_match_plain(dev, dtype, n, q, lanes):
    """The ELL V-cycle on the card (EllVCycle: K6's sums, K1p, K8's
    residual, K7, K8, K1p adding, centred) against its PyTorch form on the
    same card (EllVCycle.plain: the chain solve by K1b or K1, the products
    by K8's plain form through EllProduct): past 32768 nodes K1p's segment
    body (seg 1024), below it its cluster body, GreedyEig's (1728, 256)
    block and 2 lanes with a factor and coarse inverse each; two calls
    bitwise; each call two K1p, one K7 and two K8 launches."""
    from mac_tpu_torch.ops import laplacian, twogrid
    from mac_tpu_torch.ops.kernels import banded as kb
    from mac_tpu_torch.ops.kernels import ell as k8

    op, w = _ell_case(dev, dtype, n, lanes)
    cyc = twogrid.make_twogrid_precond(op, w, laplacian.lap_applier(op, w))
    assert isinstance(cyc, twogrid.EllVCycle)
    assert cyc.fac.seg == (1024 if n > 32768 else None)
    rng = np.random.RandomState(8)
    lead = (lanes,) if lanes else ()
    B = torch.as_tensor(rng.normal(size=lead + (n, q)), dtype=dtype,
                        device=dev)
    before = (tridiag_solve_permuted.launches, kb.coarse_correct.launches,
              k8.ell_product.launches)
    got = _twice(lambda: cyc(B))[0]
    assert (tridiag_solve_permuted.launches - before[0],
            kb.coarse_correct.launches - before[1],
            k8.ell_product.launches - before[2]) == (4, 2, 4)
    body = "segment" if n > 32768 else "cluster"
    assert tridiag_solve_permuted.launches_by_body.get(body, 0) >= 4
    ref = cyc.plain(B)
    assert _rel(got, ref) <= _CG_TOL[dtype], _rel(got, ref)


def test_ell_inner_solve_replays_in_few_kernels(dev):
    """The n = 100000 expander's graphed solve on the card (a few outer
    iterations), then its inner CG solve replayed (graphs.inner_replay)
    bitwise the eager kernel loop (K8's inner form, K6, the V-cycle's K1p,
    K8 and K7), within 1e-4 relative of the plain PyTorch loop
    (pcg_fixed_plain over the plain cycle and product), and one CG step of
    chip_smoke.ELL_STEP_KERNELS device kernels (chip_smoke.step_kernels)."""
    from chip_smoke import ELL_STEP_KERNELS, SCALE_N, step_kernels
    from mac_tpu_torch.ops import graphs, laplacian, twogrid
    from mac_tpu_torch.ops.cg import pcg_fixed, pcg_fixed_plain
    from mac_tpu_torch.ops.kernels.ell import ell_product_plain

    op, w = _ell_case(dev, torch.float32, SCALE_N)
    route = graphs.twogrid_route(op)
    rng = np.random.RandomState(14)
    X = torch.as_tensor(rng.normal(size=(SCALE_N, 4)), dtype=torch.float32,
                        device=dev)
    graphs.graphed_solve(route, w, X, xprev0=X.flip(0).contiguous(),
                         tol=1e-8, maxiter=2, inner_iters=4)
    state, lnorm = route.prepare({"w": w}, "cold", None)
    apply_L, M = route.build(state)
    assert isinstance(M, twogrid.EllVCycle)
    c = lnorm.to(torch.float32)
    sigma = 32 * torch.finfo(torch.float32).eps * c
    B = torch.as_tensor(rng.normal(size=(SCALE_N, 4)), dtype=torch.float32,
                        device=dev)
    X0 = 0.1 * B
    inner = apply_L.shifted(c, sigma)
    eager = pcg_fixed(inner, B, M, iters=5, X0=X0)
    got = graphs.inner_replay(route, dict(state, c=c, sigma=sigma), B, X0,
                              5)
    assert torch.equal(got, eager)
    plain = pcg_fixed_plain(
        lambda V: ell_product_plain(op.slot_nbr, op.slot_count,
                                    state["w_tbl"], V,
                                    vsum=V.sum(0), c=c, sigma=sigma),
        B, M.plain, iters=5, X0=X0)
    assert _rel(got, plain) <= 1e-4
    kernels, ms = step_kernels(op)
    assert kernels == ELL_STEP_KERNELS, (kernels, ms)


# K9 (fw_oracle) and K10 (fw_update): the Frank-Wolfe step's bookkeeping.
def _fw_inputs(dev, dtype, n, m, seed, ties=False):
    rng = np.random.RandomState(seed)
    V = rng.normal(size=(n, 4))
    if ties:
        V[: n // 2, 0] = 0.25
    return (torch.as_tensor(V, dtype=dtype, device=dev),
            torch.as_tensor(rng.randint(0, n, size=(m, 2)), dtype=torch.int32,
                            device=dev),
            torch.as_tensor(0.5 + rng.rand(m), dtype=dtype, device=dev),
            torch.as_tensor(rng.rand(m), dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,ties", [(10000, 10688, False),
                                      (10000, 10688, True),
                                      (100000, 50000, False), (50, 3, False)])
def test_fw_kernels_match_plain_and_repeat(dev, dtype, n, m, ties):
    """K9 at k = m / 2, 1 and m - 1 (and with half the nodes at one value
    of v, the g = 0 ties across the threshold) and K10 on its g and s,
    the tail average on: g, s, x, xavg, w, the counters and the stop flag
    bitwise the plain version's, u and ||g|| within 1e-6 (float32) or
    1e-14 (float64) relative, two calls bitwise."""
    from mac_tpu_torch.ops.kernels import fw

    V, ends, wc, x0 = _fw_inputs(dev, dtype, n, m, 7, ties)
    for k in sorted({max(1, m // 2), 1, m - 1}):
        g, s = fw.fw_oracle(V, ends, wc, k)
        g2, s2 = fw.fw_oracle(V, ends, wc, k)
        gp, sp = fw.fw_oracle_plain(V, ends, wc, k)
        assert torch.equal(g, gp) and torch.equal(s, sp)
        assert torch.equal(g, g2) and torch.equal(s, s2)
        assert int(s.sum()) == k
    k = max(1, m // 2)
    g, s = fw.fw_oracle(V, ends, wc, k)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    got = []
    for fn in (fw.fw_update, fw.fw_update, fw.fw_update_plain):
        st = dict(x=x0.clone(),
                  u=torch.tensor(float("inf"), dtype=dtype, device=dev),
                  xavg=x0.flip(0).contiguous(),
                  ctr=torch.tensor([20, 4], dtype=torch.int32, device=dev),
                  done=torch.zeros((), dtype=torch.bool, device=dev),
                  w=torch.empty_like(x0),
                  norm=torch.zeros((), dtype=dtype, device=dev))
        fn(torch.tensor(0.07, dtype=dtype, device=dev), g, s, st["x"],
           st["u"], st["xavg"], st["ctr"], st["done"], st["w"], wc,
           grad_norm_tol=1e-8, gap_tol=0.0, tail_from=16, mask_tol=1e-10,
           norm=st["norm"])
        got.append(st)
    a, b, p = got
    for name in ("x", "xavg", "w", "ctr", "done"):
        assert torch.equal(a[name], p[name]), name
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for name in ("u", "norm"):
        assert abs(float(a[name]) - float(p[name])) <= tol * abs(
            float(p[name])), name


def test_fw_oracle_orders_nan_first(dev):
    """K9 with NaN entries of g (NaN nodes of v) against the plain version
    on a CPU copy: NaN selected first, lower index first."""
    from mac_tpu_torch.ops.kernels import fw

    V, ends, wc, _ = _fw_inputs(dev, torch.float32, 4000, 6000, 9)
    V[torch.arange(0, 4000, 97, device=dev), 0] = float("nan")
    for k in (10, 3000):
        g, s = fw.fw_oracle(V, ends, wc, k)
        gp, sp = fw.fw_oracle_plain(V.cpu(), ends.cpu(), wc.cpu(), k)
        assert torch.equal(s.cpu(), sp)
        assert torch.equal(g.isnan().cpu(), gp.isnan())


def test_fw_pair_replays_in_a_graph(dev):
    """K9 then K10 captured in a CUDA graph, replayed from the same state,
    bitwise the eager pair."""
    from mac_tpu_torch.ops.kernels import fw

    V, ends, wc, x0 = _fw_inputs(dev, torch.float32, 10000, 10688, 3)
    k = 5344
    out = {}
    for way in ("eager", "graph"):
        st = dict(x=x0.clone(), u=torch.tensor(1.0, device=dev),
                  xavg=torch.zeros_like(x0),
                  ctr=torch.tensor([17, 1], dtype=torch.int32, device=dev),
                  done=torch.zeros((), dtype=torch.bool, device=dev),
                  w=torch.empty_like(x0))
        f = torch.tensor(0.07, device=dev)

        def pair():
            g, s = fw.fw_oracle(V, ends, wc, k)
            fw.fw_update(f, g, s, st["x"], st["u"], st["xavg"], st["ctr"],
                         st["done"], st["w"], wc, grad_norm_tol=1e-8,
                         gap_tol=0.0, tail_from=16, mask_tol=1e-10)
            return g, s

        if way == "eager":
            g, s = pair()
        else:
            saved = {n: t.clone() for n, t in st.items()}
            pair()  # loads the kernels before the capture
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                g, s = pair()
            for n, t in saved.items():
                st[n].copy_(t)
            graph.replay()
        torch.cuda.synchronize()
        out[way] = dict(st, g=g.clone(), s=s.clone())
    for name in out["eager"]:
        assert torch.equal(out["eager"][name], out["graph"][name]), name


def test_fw_kernels_refuse_what_they_do_not_take(dev):
    """int64 endpoints, k outside 1..m, float16 and mixed types, tensors
    on two devices."""
    from mac_tpu_torch.ops.kernels import fw

    V, ends, wc, x0 = _fw_inputs(dev, torch.float32, 100, 60, 1)
    with pytest.raises(TypeError):
        fw.fw_oracle(V, ends.long(), wc, 5)
    for k in (0, 61):
        with pytest.raises(ValueError):
            fw.fw_oracle(V, ends, wc, k)
    with pytest.raises(TypeError):
        fw.fw_oracle(V.half(), ends, wc.half(), 5)
    with pytest.raises(TypeError):
        fw.fw_oracle(V.double(), ends, wc, 5)
    with pytest.raises(ValueError):
        fw.fw_oracle(V.cpu(), ends, wc, 5)
    g, s = fw.fw_oracle(V, ends, wc, 5)
    with pytest.raises(TypeError):
        fw.fw_update(torch.tensor(0.5, device=dev), g, s, x0.clone(),
                     torch.tensor(1.0, device=dev), x0.clone(),
                     torch.zeros(2, dtype=torch.int64, device=dev),
                     torch.zeros((), dtype=torch.bool, device=dev),
                     x0.clone(), wc, grad_norm_tol=1e-8, gap_tol=0.0,
                     mask_tol=0.0)


def _fw_instances():
    """A banded pose graph (n 1500) and an expander-like graph on the
    matrix-free route (n 3000), each with its solver's knobs."""
    from scripts.bench_scale import synthetic

    idx, w, n = _graph(1500, 500, 40, 3)
    chain, loops = idx[:n - 1], idx[n - 1:]
    banded = ((chain, w[:n - 1]), (loops, w[n - 1:]), n,
              dict(use_banded=True, dtype=torch.float32))
    fi, wf, ci, wc = synthetic(3000, seed=0, local=False)
    ell = ((fi, wf), (ci, wc), 3000, dict(fiedler_inner_iters=10,
                                          fiedler_maxiter=60,
                                          fiedler_tol=6e-4))
    return {"banded": banded, "ell": ell}


@pytest.mark.parametrize("route", ["banded", "ell"])
@pytest.mark.parametrize("stop", [False, True])
def test_device_loop_replayed_is_bitwise_the_host_loop(dev, route, stop):
    """A replayed warm solve with the Frank-Wolfe loop on the device (K9,
    K10, the stop flag read with the next set-up) against the same solve
    with the loop on the host: rounded selection, x, upper bound and
    iteration counts bitwise, K9 and K10 launched once a step; with a loose
    gap tolerance the loop stops early, at the same step, and the device
    loop discards exactly one set-up."""
    from mac_tpu_torch.ops.kernels import fw
    from mac_tpu_torch.solvers import MAC

    fixed, cands, n, knobs = _fw_instances()[route]
    m = len(cands[1])
    k = m // 2 if route == "banded" else m // 4
    x0 = np.full(m, k / m)
    kw = (dict(max_iters=12, relative_duality_gap_tol=0.3) if stop
          else dict(max_iters=8))
    mac = MAC(fixed, cands, n, device="cuda", **knobs)
    mac.solve(k, x0, **kw)  # captures the graphs
    op = mac._banded if mac._banded is not None else mac.op
    disc0 = sum(r.discards for r in op.graph_routes.values())
    launches0 = fw.fw_oracle.launches
    dev_out = mac.solve(k, x0, **kw)
    dev_stats = dict(mac.last_solve_stats)
    discards = sum(r.discards for r in op.graph_routes.values()) - disc0
    assert fw.fw_oracle.launches - launches0 == dev_stats["fw_iterations"]
    mac._fw_device = mac._fw_host
    host_out = mac.solve(k, x0, **kw)
    host_stats = dict(mac.last_solve_stats)
    for a, b in zip(dev_out, host_out):
        np.testing.assert_array_equal(a, b)
    for key in ("fw_iterations", "fiedler_iterations"):
        assert dev_stats[key] == host_stats[key], key
    steps = dev_stats["fw_iterations"]
    if stop:
        assert steps < kw["max_iters"] and discards == 1
    else:
        assert steps == kw["max_iters"] and discards == 0

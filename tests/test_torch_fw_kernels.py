"""Kernels K9 and K10 (mac_tpu_torch.ops.kernels.fw) and the Frank-Wolfe
loop that runs them (optimization.frankwolfe._frank_wolfe_on_device) on the
CPU, where the wrappers run their plain versions: K9's plain version against
the JAX package's supergradient and top-k oracle; a numpy model of K9's
radix select and tie rule (the kernel's order of work) against the plain
version; K10's plain version against one step of the JAX package's
frank_wolfe_with_state body; the device loop against
frank_wolfe_with_state (the port's, bitwise, and the JAX package's) on a
small problem whose gradient or gap stop fires at a chosen step; and
MAC.solve through the device loop bitwise the host loop on the banded float32,
banded float64 and matrix-free routes. The kernels themselves need the
card (tests/test_torch_cuda.py). Inputs come from numpy seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.optimization.constraints import solve_subset_box_lp as jax_lp
from mac_tpu.optimization.frankwolfe import frank_wolfe_with_state as jax_fw
from mac_tpu_torch.ops.kernels import fw
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.optimization.frankwolfe import (_frank_wolfe_on_device,
                                                   frank_wolfe_with_state)
from mac_tpu_torch.solvers import MAC
from scripts.bench_scale import synthetic

torch.set_num_threads(1)

TDT = {"f32": torch.float32, "f64": torch.float64}
NDT = {"f32": np.float32, "f64": np.float64}


def oracle_inputs(prec, n=300, m=400, seed=0, ties=False):
    """V (n, 4), ends (m, 2) int32, w_cand (m,): with ties, the first half
    of the nodes share one value of v, so that many g are exactly 0."""
    rng = np.random.RandomState(seed)
    V = rng.normal(size=(n, 4)).astype(NDT[prec])
    if ties:
        V[: n // 2, 0] = 0.25
    ends = rng.randint(0, n, size=(m, 2)).astype(np.int32)
    wc = (0.5 + rng.rand(m)).astype(NDT[prec])
    return V, ends, wc


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("case", ["half", "k1", "m-1", "ties"])
def test_oracle_plain_matches_jax(prec, case):
    """K9's plain version: g = (w d) d bitwise the JAX package's w_cand * d
    * d (mac_tpu/solvers/mac.py:1465-1468), and s bitwise its top-k
    indicator (lax.top_k, ties to the lower index), at k = m / 2, 1 and
    m - 1 and with a quarter of the gradient exactly 0 and the threshold
    among those zeros (ties across it)."""
    V, ends, wc = oracle_inputs(prec, ties=case == "ties")
    m = len(wc)
    zeros = int((V[ends[:, 0], 0] == V[ends[:, 1], 0]).sum())
    k = {"half": m // 2, "k1": 1, "m-1": m - 1,
         "ties": m - zeros // 2}[case]
    g, s = fw.fw_oracle(torch.as_tensor(V), torch.as_tensor(ends),
                        torch.as_tensor(wc), k)
    v = jnp.asarray(V)[:, 0]
    d = v[ends[:, 0]] - v[ends[:, 1]]
    jg = jnp.asarray(wc) * d * d
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax_lp(jg, k)))
    if case == "ties":
        assert (g.numpy() == 0).sum() > m // 8
        assert 0 < s.numpy()[g.numpy() == 0].sum() < (g.numpy() == 0).sum()


def radix_key(g: np.ndarray) -> np.ndarray:
    """csrc/fw.cu's radix keys (uint32 or uint64): unsigned order = the
    plain version's descending order, -0.0 as +0.0, every NaN the
    largest."""
    bits, ut = {4: (32, np.uint32), 8: (64, np.uint64)}[g.itemsize]
    b = g.view(ut).copy()
    sign = ut(1) << ut(bits - 1)
    b[b == sign] = 0
    neg = (b & sign) != 0
    key = np.where(neg, ~b, b | sign).astype(ut)
    key[np.isnan(g)] = ~ut(0)
    return key


def radix_select_model(g: np.ndarray, k: int) -> np.ndarray:
    """K9's selection as the kernel works it, in numpy: 8-bit digits from
    the top, each pass a histogram of the keys matching the digits chosen
    so far and the digit where the count from the top reaches `need`; then
    every key above the threshold and the `need` lowest indices among the
    keys equal to it."""
    key = radix_key(g)
    bits = 8 * g.itemsize
    ut = key.dtype.type
    prefix, need = 0, k
    for p in range(bits // 8):
        shift = bits - 8 * (p + 1)
        match = (np.ones(len(key), bool) if p == 0 else
                 (key >> ut(shift + 8)) == ut(prefix >> (shift + 8)))
        hist = np.bincount(((key[match] >> ut(shift)) & ut(255)).astype(
            np.int64), minlength=256)
        cum = 0
        for digit in range(255, -1, -1):
            if cum + hist[digit] >= need:
                prefix |= digit << shift
                need -= cum
                break
            cum += hist[digit]
    above = key > ut(prefix)
    equal = key == ut(prefix)
    rank = np.cumsum(equal) - 1  # among the equal keys, by index
    return (above | (equal & (rank < need))).astype(g.dtype)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("case", ["random", "ties", "runs", "nan", "zeros",
                                  "negative"])
def test_radix_select_model_is_bitwise_the_plain_oracle(prec, case):
    """The numpy model of K9's radix select and tie rule against
    solve_subset_box_lp (a stable descending sort) on random g, g with
    half its entries 0, g with few distinct values (the threshold inside a
    run of equal values), NaN entries (first, lower index first), +0.0 and
    -0.0 mixed (equal ties) and negative entries; at k = 1, m / 3, m - 1
    and m."""
    rng = np.random.RandomState(11)
    m = 700
    g = rng.normal(size=m)
    if case == "ties":
        g[rng.rand(m) < 0.5] = 0.0
        g = np.abs(g)
    elif case == "runs":
        g = rng.randint(0, 4, size=m).astype(np.float64)
    elif case == "nan":
        g = np.abs(g)
        g[rng.randint(0, m, 40)] = np.nan
    elif case == "zeros":
        g = np.where(rng.rand(m) < 0.5, 0.0, -0.0)
        g[rng.randint(0, m, 30)] = 1.0
    elif case == "negative":
        g = -np.abs(g)
    elif case == "random":
        g = np.abs(g)
    g = g.astype(NDT[prec])
    for k in (1, m // 3, m - 1, m):
        want = solve_subset_box_lp(torch.as_tensor(g), k).numpy()
        np.testing.assert_array_equal(radix_select_model(g, k), want,
                                      err_msg=f"k = {k}")


def one_jax_step(f, g, s, x, u, xavg, it, cnt, gap_tol, tail_from):
    """One pass of the JAX package's frank_wolfe_with_state body from the
    carry (x, u, it, xavg, cnt): problem returns (f, g) and the oracle s."""
    carry0 = (jnp.asarray(x), jnp.asarray(u), jnp.asarray(0),
              jnp.asarray(it), jnp.asarray(False), jnp.asarray(xavg),
              jnp.asarray(cnt))
    return jax_fw(jnp.asarray(x), jnp.asarray(0),
                  lambda x_, st: (jnp.asarray(f), jnp.asarray(g), st),
                  lambda g_: jnp.asarray(s), maxiter=it + 1,
                  relative_duality_gap_tol=gap_tol, grad_norm_tol=1e-8,
                  tail_average_from=tail_from, carry0=carry0,
                  return_carry=True)


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("case", ["step", "stop", "tail", "tail-stop"])
def test_update_plain_matches_one_jax_step(prec, case):
    """K10's plain version against one step of the JAX package's loop body
    (mac_tpu/optimization/frankwolfe.py:97-133): the step count and the
    stop flag equal, x and the tail average to an ulp (XLA contracts) and
    bitwise a numpy model of their separate roundings (gamma = 2/(it + 2)
    rounded to the type: it = 5 gives 2/7, inexact in float32), u within
    1e-6 relative in float32 and 1e-14 in float64; the stop test off (no
    gap test) and on (a loose gap tolerance), before the tail average
    starts and on it (a count of 3); and the next weights where(x > tol,
    x, 0) w_cand, bitwise."""
    dt, nd = TDT[prec], NDT[prec]
    rng = np.random.RandomState(4)
    m = 500
    g = (1e-2 * rng.rand(m)).astype(nd)
    s = (rng.rand(m) < 0.3).astype(nd)
    x = rng.rand(m).astype(nd)
    x[:20] = 0.0
    xavg = rng.rand(m).astype(nd)
    wc = (0.5 + rng.rand(m)).astype(nd)
    f, u = nd(0.07), nd(0.2)
    gap_tol = 10.0 if case.endswith("stop") else 0.0
    tail_from = 3 if case.startswith("tail") else None
    it, cnt = 5, 2
    jx, ju, _, jit_, jdone, jxavg, jcnt = one_jax_step(
        f, g, s, x, u, xavg, it, cnt, gap_tol, tail_from)
    tx, txavg = torch.as_tensor(x.copy()), torch.as_tensor(xavg.copy())
    tu = torch.tensor(u)
    ctr = torch.tensor([it, cnt], dtype=torch.int32)
    done = torch.zeros((), dtype=torch.bool)
    w = torch.empty(m, dtype=dt)
    fw.fw_update(torch.tensor(f), torch.as_tensor(g), torch.as_tensor(s), tx,
                 tu, txavg, ctr, done, w, torch.as_tensor(wc),
                 grad_norm_tol=1e-8, gap_tol=gap_tol, tail_from=tail_from,
                 mask_tol=1e-10)
    # XLA may contract x + gamma (s - x) into an fma: the JAX step agrees
    # to an ulp; a numpy model of the separate roundings, bitwise.
    ulp = 2.5e-7 if prec == "f32" else 5e-16
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=ulp,
                               atol=1e-30)
    np.testing.assert_allclose(txavg.numpy(), np.asarray(jxavg), rtol=ulp,
                               atol=1e-30)
    assert ctr.tolist() == [int(jit_), int(jcnt)]
    assert bool(done) == bool(jdone) == case.endswith("stop")
    rtol = 1e-6 if prec == "f32" else 1e-14
    np.testing.assert_allclose(float(tu), float(ju), rtol=rtol)
    xn = tx.numpy()
    gamma = nd(2.0 / (it + 2.0))
    want = x if case.endswith("stop") else x + gamma * (s - x)
    np.testing.assert_array_equal(xn, want)
    want_avg = xavg + (x - xavg) / nd(cnt + 1) if tail_from else xavg
    np.testing.assert_array_equal(txavg.numpy(), want_avg)
    np.testing.assert_array_equal(w.numpy(),
                                  np.where(xn > 1e-10, xn, 0).astype(nd) * wc)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """int64 endpoints, k outside 1..m, float16 blocks, mixed types and
    counters that are not int32 are refused before any dispatch."""
    V, ends, wc = oracle_inputs("f32", n=20, m=30)
    V, ends, wc = torch.as_tensor(V), torch.as_tensor(ends), \
        torch.as_tensor(wc)
    with pytest.raises(TypeError):
        fw.fw_oracle(V, ends.long(), wc, 3)
    for k in (0, 31):
        with pytest.raises(ValueError):
            fw.fw_oracle(V, ends, wc, k)
    with pytest.raises(TypeError):
        fw.fw_oracle(V.half(), ends, wc.half(), 3)
    with pytest.raises(TypeError):
        fw.fw_oracle(V.double(), ends, wc, 3)
    x = torch.rand(30)
    args = (torch.tensor(0.5), x.clone(), x.clone(), x.clone(),
            torch.tensor(1.0), x.clone())
    with pytest.raises(TypeError):
        fw.fw_update(*args, torch.zeros(2, dtype=torch.int64),
                     torch.zeros((), dtype=torch.bool), x.clone(), x.clone(),
                     grad_norm_tol=1e-8, gap_tol=0.0, mask_tol=0.0)


# A small concave problem of the device loop's form: f(x) = lambda_2 of the
# Laplacian of a fixed path plus the candidates at weights x w_cand, by a
# dense eigh, and its supergradient w_cand (v_i - v_j)^2.
N_NODES = 14


def path_problem(seed=1, m=30):
    rng = np.random.RandomState(seed)
    fixed = np.stack([np.arange(N_NODES - 1), np.arange(1, N_NODES)], 1)
    cands = []
    while len(cands) < m:
        i, j = sorted(rng.randint(0, N_NODES, 2))
        if j - i > 1 and (i, j) not in cands:
            cands.append((i, j))
    ends = np.array(cands, dtype=np.int32)
    return (fixed, 0.5 + rng.rand(N_NODES - 1), ends,
            0.5 + rng.rand(m))


def lap_eig(xp, idx, w):
    """(lambda_2, its eigenvector as an (n, 1) block) of L(w) in the
    package xp (numpy-like: jnp, or torch through a shim)."""
    if xp is torch:
        L = torch.zeros((N_NODES, N_NODES), dtype=w.dtype)
        i, j = torch.as_tensor(idx[:, 0]).long(), torch.as_tensor(
            idx[:, 1]).long()
        L.index_put_((i, j), -w, accumulate=True)
        L.index_put_((j, i), -w, accumulate=True)
        L = L - torch.diag(L.sum(dim=1))
        lam, vec = torch.linalg.eigh(L)
        return lam[1], vec[:, 1:2].contiguous()
    L = jnp.zeros((N_NODES, N_NODES)).at[idx[:, 0], idx[:, 1]].add(-w)
    L = L.at[idx[:, 1], idx[:, 0]].add(-w)
    L = L - jnp.diag(L.sum(axis=1))
    lam, vec = jnp.linalg.eigh(L)
    return lam[1], vec[:, 1:2]


def stop_tolerances(kind, k, seed=1, maxiter=12):
    """(gap tolerance, gradient tolerance) under which the port's host
    loop stops at a step in the middle of `maxiter`: a tolerance between
    the test's value at that step and at every earlier one."""
    fixed, wf, ends, wc = path_problem(seed)
    idx = np.concatenate([fixed, ends])
    vals = []

    def problem(x, st):
        w = torch.cat([torch.as_tensor(wf), x * torch.as_tensor(wc)])
        lam, V = lap_eig(torch, idx, w)
        d = V[ends[:, 0], 0] - V[ends[:, 1], 0]
        g = torch.as_tensor(wc) * d * d
        s = solve_subset_box_lp(g, k)
        vals.append((lam, g, s, x))
        return lam, g, st

    frank_wolfe_with_state(torch.full((len(wc),), k / len(wc),
                                      dtype=torch.float64), 0, problem,
                           lambda g: solve_subset_box_lp(g, k),
                           maxiter=maxiter, relative_duality_gap_tol=0.0)
    u, tests = float("inf"), []
    for lam, g, s, x in vals:
        u = min(u, float(lam + g @ (s - x)))
        tests.append(((u - float(lam)) / abs(float(lam)),
                      float(torch.linalg.vector_norm(g))
                      / min(abs(float(lam)), 1.0)))
    col = 0 if kind == "gap" else 1
    seq = [t[col] for t in tests]
    for j in range(3, len(seq) - 2):
        if seq[j] < 0.99 * min(seq[:j]):
            tol = 0.5 * (seq[j] + min(seq[:j]))
            return (tol, 1e-12) if kind == "gap" else (0.0, tol), j
    raise AssertionError(f"no {kind} stop point in {seq}")


@pytest.mark.parametrize("kind", ["gap", "grad"])
@pytest.mark.parametrize("tail", [None, 2])
def test_device_loop_matches_frank_wolfe_with_state(kind, tail):
    """_frank_wolfe_on_device on the path problem against the port's
    frank_wolfe_with_state (bitwise: x, u, the step count, the state) and
    the JAX package's (x and u to 1e-9, the same step count), with a gap
    or a gradient stop that fires at a chosen step, with and without the
    tail average. The problem is called once more than the host loop
    calls it: that call finds the stop flag set, has run its own work
    (here a scratch buffer overwritten) and leaves no trace."""
    fixed, wf, ends, wc = path_problem()
    k = 9
    (gap_tol, grad_tol), j = stop_tolerances(kind, k)
    idx = np.concatenate([fixed, ends])
    m = len(wc)
    x0 = np.full(m, k / m)
    wct = torch.as_tensor(wc)

    def host_problem(x, st):
        w = torch.cat([torch.as_tensor(wf), x * wct])
        lam, V = lap_eig(torch, idx, w)
        d = V[ends[:, 0], 0] - V[ends[:, 1], 0]
        return lam, wct * d * d, st + 1

    hx, hu, hst, hit = frank_wolfe_with_state(
        torch.as_tensor(x0), 0, host_problem,
        lambda g: solve_subset_box_lp(g, k), maxiter=12,
        relative_duality_gap_tol=gap_tol, grad_norm_tol=grad_tol,
        tail_average_from=tail)
    assert hit == j + 1 and hst == hit

    w_out = torch.empty(N_NODES - 1 + m, dtype=torch.float64)
    w_out[:N_NODES - 1] = torch.as_tensor(wf)
    done = torch.zeros((), dtype=torch.bool)
    scratch = torch.zeros(N_NODES, 1, dtype=torch.float64)
    calls = []

    def dev_problem(x, st):
        lam, V = lap_eig(torch, idx, w_out.clone())
        scratch.copy_(V)  # the step's own work, in a shared buffer
        calls.append(int(st))
        if bool(done):
            return None, None, st
        return lam, scratch, st + 1

    dx, du, dst, dit = _frank_wolfe_on_device(
        torch.as_tensor(x0), 0, dev_problem, torch.as_tensor(ends), wct, k,
        w_out, done, maxiter=12, relative_duality_gap_tol=gap_tol,
        grad_norm_tol=grad_tol, mask_tol=0.0, tail_average_from=tail)
    assert torch.equal(dx, hx) and torch.equal(du, hu)
    assert (dit, dst) == (hit, hst) and calls == list(range(hit + 1))

    def jax_problem(x, st):
        w = jnp.concatenate([jnp.asarray(wf), x * jnp.asarray(wc)])
        lam, V = lap_eig(jnp, idx, w)
        d = V[ends[:, 0], 0] - V[ends[:, 1], 0]
        return lam, jnp.asarray(wc) * d * d, st + 1

    jx, ju, jst, jit_ = jax_fw(
        jnp.asarray(x0), jnp.asarray(0), jax_problem,
        lambda g: jax_lp(g, k), maxiter=12,
        relative_duality_gap_tol=gap_tol, grad_norm_tol=grad_tol,
        tail_average_from=tail)
    assert int(jit_) == hit and int(jst) == hst
    np.testing.assert_allclose(dx.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(du), float(ju), rtol=1e-9)


def _pose_instance(n=900, loops=300, seed=3):
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    pairs = set()
    while len(pairs) < loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(40))
        if j - i > 1:
            pairs.add((i, j))
    cands = np.array(sorted(pairs))
    return ((chain, 0.5 + rng.rand(n - 1)), (cands, 0.5 + rng.rand(loops)),
            n)


def _small_pose_instance():
    return _pose_instance(n=400, loops=130)


F64_KNOBS = dict(use_banded=True, dtype=torch.float64, fiedler_maxiter=20,
                 fiedler_inner_iters=8)


def _ell_instance(n=2100):
    fi, wf, ci, wc = synthetic(n, seed=0, local=False)
    return (fi, wf), (ci, wc), n


ROUTES = {
    # (instance, MAC knobs, solve knobs): the banded float32 route's own
    # policy (32 steps, warm caps, the tail average, the gap stop off) and
    # a forced stop; the banded float64 route's 5 steps (at n = 400, its
    # eigensolves capped at 20 outer iterations of 8 CG steps) and a
    # forced stop; the matrix-free route at the scale benchmark's knobs and a
    # forced stop.
    "banded-f32": (_pose_instance, dict(use_banded=True,
                                        dtype=torch.float32), {}),
    "banded-f32-stop": (_pose_instance, dict(use_banded=True,
                                             dtype=torch.float32),
                        dict(max_iters=12, relative_duality_gap_tol=0.1)),
    "banded-f64": (_small_pose_instance, F64_KNOBS, {}),
    "banded-f64-stop": (_small_pose_instance, F64_KNOBS,
                        dict(max_iters=12, relative_duality_gap_tol=0.1)),
    "ell": (_ell_instance, dict(fiedler_inner_iters=10, fiedler_maxiter=60,
                                fiedler_tol=6e-4), dict(max_iters=2)),
    "ell-stop": (_ell_instance, dict(fiedler_inner_iters=10,
                                     fiedler_maxiter=60, fiedler_tol=6e-4),
                 dict(max_iters=6, relative_duality_gap_tol=0.6)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_mac_device_loop_is_bitwise_the_host_loop(route):
    """MAC.solve on the CPU with its Frank-Wolfe loop through the device
    device loop (MAC._fw_device: per-step solves over the route's static state,
    K9's and K10's plain versions) against the same solve through the
    host loop (_fw_host): the loop's results (x, u, the Ritz block, the
    step and Fiedler iteration counts, the rounding) and the solve's
    (rounded, unrounded, upper bound) bitwise; where a stop fires, the
    device loop's discarded set-up leaves no trace and the loop stops at the
    same step."""
    make, knobs, solve_kw = ROUTES[route]
    fixed, cands, n = make()
    m = len(cands[1])
    k = m // 2
    x_init = np.full(m, k / m)
    got = {}
    for loop in ("host", "device"):
        mac = MAC(fixed, cands, n, device="cpu", **knobs)
        if loop == "host":
            mac._fw_device = mac._fw_host
        loops, real = [], mac._fw_impl

        def recorded(*a, _real=real, _out=loops, **kw):
            _out.append(_real(*a, **kw))
            return _out[-1]

        mac._fw_impl = recorded
        got[loop] = (mac.solve(k, x_init, **solve_kw), loops[0],
                     dict(mac.last_solve_stats))
    (hsol, hloop, hstats), (dsol, dloop, dstats) = got["host"], got["device"]
    for a, b in zip(dloop, hloop):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    for a, b in zip(dsol, hsol):
        np.testing.assert_array_equal(a, b)
    for key in ("fw_iterations", "fiedler_iterations"):
        assert dstats[key] == hstats[key], key
    if route.endswith("stop"):
        assert hstats["fw_iterations"] < solve_kw["max_iters"]

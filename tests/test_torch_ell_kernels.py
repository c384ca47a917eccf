"""The matrix-free route's CG step as the card runs it (kernel K8, the ELL
product, with K6, and the two-grid V-cycle through K1p and K7), through the
kernels' plain versions on the CPU, against the JAX package.

At a reduced copy of the n = 100000 expander (scripts/bench_scale.py's
generator at n = 6000, its start weights: the top quarter of the candidates
by weight), with every weight rounded to a multiple of 2^-8: the JAX
package accumulates the coarse operator Lc in float32 (the port in
float64; tests/test_torch_ell_parity.py holds that difference, 1e-6
relative), and on these weights that float32 sum is exact, so that the two
packages' cycles meet at float64's rounding. Held, float32 within 1e-5 and
float64 within 1e-12 relative in norm:
  * K8's plain version (mac_tpu_torch.ops.kernels.ell.ell_product) in its
    plain, inner (with mac_tpu.ops.lobpcg._shift_term's shift) and
    residual forms, against mac_tpu.ops.laplacian._ell_apply; its column
    dots against the float64 sum, and its fixed order (dot_model) against
    a second formulation of that order and an exact sum;
  * its lanes: the budget sweep's (a weight table per lane) and
    GreedyEig's (one table shared by the lanes), against single calls;
  * the V-cycle (ops.twogrid.EllVCycle): its PyTorch form and its kernel
    form (K1p, K8's residual, K7, K8, K1p adding, centred by the sums)
    against mac_tpu.ops.twogrid.make_twogrid_precond, on the exact chain
    factor and on the factor decoupled every 1024 rows (the exact-factor
    limit lowered to 4096 in both packages, so that both take the blocked
    factor of the n = 100000 route);
  * pcg_fixed_steps over EllProduct's inner form and EllVCycle against
    mac_tpu.ops.cg.pcg_fixed over the JAX product and V-cycle;
  * which kernels one CG step of the route calls, and with what;
  * one small matrix-free MAC solve with the card's CG step (the kernels'
    plain versions through pcg_fixed_steps) against the JAX package's.
Inputs come from numpy seeds and go to both packages as arrays."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mac_tpu.ops.tridiag as jtri
import mac_tpu_torch.ops.tridiag as ttri
from mac_tpu.ops import cg as jcg
from mac_tpu.ops import laplacian as jl
from mac_tpu.ops.lobpcg import _shift_term as jax_shift_term
from mac_tpu.ops.twogrid import make_twogrid_precond as jax_twogrid
from mac_tpu_torch.ops import cg as tcg
from mac_tpu_torch.ops import graphs
from mac_tpu_torch.ops import laplacian as tl
from mac_tpu_torch.ops import twogrid as ttg
from mac_tpu_torch.ops.kernels import banded as kb
from mac_tpu_torch.ops.kernels import ell as k8
from mac_tpu_torch.ops.kernels import pcg as kp
from mac_tpu_torch.ops.kernels import tridiag as k1
from scripts.bench_scale import synthetic

torch.set_num_threads(1)

N = 6000
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "float64": (np.float64, jnp.float64, torch.float64, 1e-12)}

_cache = {}


def expander(n=N):
    """(edge index (m, 2), start weights (m,) float64, n): the expander's
    chain and candidates, the top quarter of the candidates by weight
    selected, every weight a multiple of 2^-8."""
    if n not in _cache:
        fi, wf, ci, wc = synthetic(n, seed=0, local=False)
        k = len(wc) // 4
        x = np.zeros(len(wc))
        x[np.argpartition(wc, -k)[-k:]] = 1.0
        w = np.round(np.concatenate([wf, x * wc]) * 256) / 256
        idx = np.concatenate([fi, ci]).astype(np.int64)
        _cache[n] = (idx, w, jl.build_operator(idx, n),
                     tl.build_operator(idx, n))
    return _cache[n]


def _k8(op, *args, **kw):
    """K8's wrapper over op's slot-major neighbour and count tables."""
    return k8.ell_product(op.slot_nbr, op.slot_count, *args, **kw)


def rel_err(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.fixture
def blocked_factor(monkeypatch):
    monkeypatch.setattr(jtri, "TRIDIAG_SCAN_MAX_N", 4096)
    monkeypatch.setattr(ttri, "TRIDIAG_SCAN_MAX_N", 4096)
    monkeypatch.setattr(graphs, "TRIDIAG_SCAN_MAX_N", 4096)


def test_operator_carries_the_kernels_int32_tables():
    """slot_nbr is nbr_tbl transposed as int32, slot_count each row's
    filled slots (int32), slot_eid eid_tbl transposed and ident32 the
    identity permutation, made with the operator and again by to()."""
    idx, w, jop, top = expander()
    for t in (top.slot_nbr, top.slot_count, top.ident32):
        assert t.dtype == torch.int32 and t.is_contiguous()
    assert top.slot_eid.is_contiguous()
    assert torch.equal(top.slot_nbr.long(), top.nbr_tbl.T)
    assert torch.equal(top.slot_eid, top.eid_tbl.T)
    assert torch.equal(top.ident32.long(), torch.arange(N))
    moved = top.to("cpu")
    assert moved.slot_nbr is not top.slot_nbr
    for name in ("slot_nbr", "slot_eid", "slot_count", "ident32"):
        assert torch.equal(getattr(moved, name), getattr(top, name))
    np.testing.assert_array_equal(np.asarray(jop.nbr_tbl),
                                  top.slot_nbr.numpy().T)
    np.testing.assert_array_equal(
        (np.asarray(jop.eid_tbl) != len(idx)).sum(axis=1),
        top.slot_count.numpy())


def _random_graph(kind):
    """(edge index (m, 2), n) of a small test graph: a chain with random
    extra edges (some duplicated), a perfect matching (dmax 1), a chain
    with one node joined to many (a single row at dmax), or a star."""
    rng = np.random.RandomState(len(kind))
    if kind == "matching":
        n = 64
        return np.stack([np.arange(0, n, 2), np.arange(1, n, 2)], 1), n
    n = 300
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    if kind == "chain_random":
        extra = rng.randint(0, n, size=(400, 2))
        extra = extra[extra[:, 0] != extra[:, 1]]
        return np.concatenate([chain, extra, extra[:20]]), n
    if kind == "one_wide_row":
        hub = 137
        others = np.setdiff1d(rng.choice(n, 40, replace=False),
                              [hub, hub - 1, hub + 1])
        return np.concatenate([chain, np.stack(
            [np.full_like(others, hub), others], 1)]), n
    return np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], 1), n


@pytest.mark.parametrize("kind", ["chain_random", "matching", "one_wide_row",
                                  "star"])
def test_operator_slot_tables_are_the_row_tables_transposed(kind):
    """The kernel's slot-major tables against the row-major ones: each
    row's count is its non-sentinel slots of eid_tbl; the padding (the
    sentinel edge m, neighbour 0) lies only at a row's tail; slot_nbr and
    slot_eid are nbr_tbl and eid_tbl transposed, and lap_weight_table the
    (n, dmax) gather transposed, lane by lane for a weight vector a
    lane."""
    idx, n = _random_graph(kind)
    op = tl.build_operator(idx, n, mode="ell")
    m = idx.shape[0]
    eid, nbr = op.eid_tbl.numpy(), op.nbr_tbl.numpy()
    cnt = op.slot_count.numpy()
    dmax = nbr.shape[1]
    assert dmax == {"matching": 1, "star": n - 1}.get(kind, dmax)
    if kind == "one_wide_row":
        assert (cnt == dmax).sum() == 1 and np.sort(cnt)[-2] <= 4
    np.testing.assert_array_equal(cnt, (eid != m).sum(axis=1))
    filled = np.arange(dmax)[None, :] < cnt[:, None]
    np.testing.assert_array_equal(eid != m, filled)  # padding at the tail
    assert (nbr[~filled] == 0).all()
    assert cnt.sum() == 2 * m
    np.testing.assert_array_equal(op.slot_nbr.numpy(), nbr.T)
    np.testing.assert_array_equal(op.slot_eid.numpy(), eid.T)
    rng = np.random.RandomState(9)
    for dtype in (torch.float32, torch.float64):
        w = torch.as_tensor(rng.rand(3, m) + 0.5, dtype=dtype)
        w[:, ::7] = 0.0  # edges at zero weight stay filled slots
        rows = torch.cat([w, w.new_zeros(3, 1)], dim=1)[:, op.eid_tbl]
        lanes = tl.lap_weight_table(op, w)
        assert lanes.shape == (3, dmax, n) and lanes.is_contiguous()
        for r in range(3):
            assert torch.equal(lanes[r], rows[r].T)
            assert torch.equal(tl.lap_weight_table(op, w[r]), rows[r].T)


def _walk_model(nbr, cnt, w_tbl, V, to_count=True):
    """The kernel's walk in numpy, in V's type: each row's slots in slot
    order, w (V_i - V_nbr) added one rounding at a time (no fma), up to
    the row's count (to_count=False: every slot, the padding too, as the
    walk to dmax adds it). nbr, w_tbl (dmax, n) slot-major; V (n, q)."""
    dmax, n = nbr.shape
    acc = np.zeros_like(V)
    for k in range(dmax):
        rows = np.flatnonzero(k < cnt) if to_count else np.arange(n)
        d = V[rows] - V[nbr[k, rows]]
        acc[rows] = acc[rows] + w_tbl[k, rows, None] * d
    return acc


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k8_walk_to_each_rows_count_is_bitwise_the_full_walk(dtype):
    """On finite V the walk to each row's count equals the walk over all
    dmax slots bit for bit (padding adds 0 x a finite difference, a +-0,
    to a sum that is nonzero or +0), here with rows of equal values (zero
    differences) and edges at zero weight, on the expander's tables and on
    a graph whose padding is most of its slots; and both are within
    rounding of the plain version. An Inf at node 0 is the one case where
    they differ: the full walk's padding makes the padded rows NaN."""
    npt = DTYPES[dtype][0]
    rng = np.random.RandomState(12)
    star_idx, star_n = _random_graph("one_wide_row")
    _, _, _, top = expander()
    for op in (top, tl.build_operator(star_idx, star_n, mode="ell")):
        n = op.n
        nbr, cnt = op.slot_nbr.numpy(), op.slot_count.numpy()
        w = rng.rand(op.m).astype(npt)
        w[::5] = 0.0
        w_tbl = tl.lap_weight_table(op, torch.as_tensor(w)).numpy()
        V = rng.normal(size=(n, 4)).astype(npt)
        V[::3] = V[0]  # equal neighbours: exact zero differences
        V[1::7] = -V[1::7]
        got = _walk_model(nbr, cnt, w_tbl, V)
        full = _walk_model(nbr, cnt, w_tbl, V, to_count=False)
        assert got.dtype == npt
        uint = np.uint32 if dtype == "float32" else np.uint64
        np.testing.assert_array_equal(got.view(uint), full.view(uint))
        plain = k8.ell_product_plain(op.slot_nbr, op.slot_count,
                                     torch.as_tensor(w_tbl),
                                     torch.as_tensor(V)).numpy()
        assert rel_err(plain, got) < DTYPES[dtype][3]
        V[0] = np.inf
        padded = cnt < nbr.shape[0]
        with np.errstate(invalid="ignore"):
            inf_got = _walk_model(nbr, cnt, w_tbl, V)
            inf_full = _walk_model(nbr, cnt, w_tbl, V, to_count=False)
        assert np.isnan(inf_full[padded]).all()
        assert not np.isnan(inf_got[padded]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q", [4, 11])
def test_k8_forms_match_jax_ell_apply(q, dtype):
    """K8's plain version: L V, B - L V (B centred), the inner form with
    _shift_term's shift and sigma V, and the column dots, against the JAX
    package's _ell_apply; EllProduct and ell_applier reach the same
    wrapper."""
    idx, w, jop, top = expander()
    npt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(7)
    V = rng.normal(size=(N, q)).astype(npt)
    B = rng.normal(size=(N, q)).astype(npt)
    wt = torch.as_tensor(w.astype(npt))
    wj = jnp.asarray(w.astype(npt))
    ref = np.asarray(jl._ell_apply(jop, wj, jnp.asarray(V)))
    w_tbl = tl.lap_weight_table(top, wt)
    tV, tB = torch.as_tensor(V), torch.as_tensor(B)
    y, dots = _k8(top, w_tbl, tV, dot=True)
    assert rel_err(y.numpy(), ref) < tol
    # The dots: each product in the block's type, summed in float64.
    np.testing.assert_allclose(
        dots.numpy(), (V * y.numpy()).astype(np.float64).sum(axis=0),
        rtol=1e-12, atol=1e-12 * np.abs(V * ref).sum(axis=0).max())
    apply_L = tl.ell_applier(top, w_tbl)
    assert isinstance(apply_L, tl.EllProduct)
    assert isinstance(tl.lap_applier(top, wt), tl.EllProduct)
    assert torch.equal(apply_L(tV), y)
    r = _k8(top, w_tbl, tV, B=tB,
                       bsum=kp.col_sums(tB)).numpy()
    assert rel_err(r, (B - B.mean(axis=0)) - ref) < tol
    c = np.asarray(2.0 * np.asarray(jl.lap_degrees(jop, wj)).max(), npt)
    sigma = np.asarray(32 * np.finfo(npt).eps * c, npt)
    want = np.asarray(jl._ell_apply(jop, wj, jnp.asarray(V))
                      + jax_shift_term(jnp.asarray(V), c)
                      + jnp.asarray(sigma) * jnp.asarray(V))
    inner = _k8(top, w_tbl, tV, vsum=kp.col_sums(tV),
                           c=torch.as_tensor(c), sigma=torch.as_tensor(sigma))
    assert rel_err(inner.numpy(), want) < tol
    shifted = apply_L.shifted(torch.as_tensor(c), torch.as_tensor(sigma))
    assert torch.equal(shifted(tV), inner)
    got, pap = shifted.product(tV.contiguous(), vsum=kp.col_sums(tV),
                               dot=True)
    assert torch.equal(got, inner)
    np.testing.assert_allclose(pap.numpy(), (V.astype(np.float64) * want)
                               .sum(axis=0), rtol=100 * tol)


def _warp_sum_cumsum(values):
    """The kernel's warp sum written another way: the values padded with
    zeros to whole rows of 32 lanes, each lane's column added in order
    (np.cumsum adds sequentially), then the xor butterfly on the 32
    lanes."""
    v = np.asarray(values, dtype=np.float64)
    rows = max(1, -(-len(v) // 32))
    pad = np.zeros(rows * 32)
    pad[:len(v)] = v
    lanes = np.cumsum(pad.reshape(rows, 32), axis=0)[-1]
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[idx ^ off]
    return lanes[0]


@pytest.mark.parametrize("q,rb", [(4, 128), (12, 42), (256, 2)])
def test_k8_dot_model_is_its_documented_order(q, rb):
    """dot_model, the kernel's order of the column dots (blocks of
    rows_per_block(q) rows summed a warp a column, then the blocks'
    partials the same way), equals a second formulation of that order bit
    for bit (on the first 8 columns), and an exact sum within the bound of
    a float64 sum of that many terms."""
    assert k8.rows_per_block(q) == rb
    rng = np.random.RandomState(q)
    n = 1000 + 3 * q
    P = rng.normal(size=(n, q)) * np.exp(rng.normal(size=(n, 1)))
    got = k8.dot_model(P)
    for col in range(min(q, 8)):
        parts = [_warp_sum_cumsum(P[r0:r0 + rb, col])
                 for r0 in range(0, n, rb)]
        assert got[col] == _warp_sum_cumsum(parts)
        exact = math.fsum(P[:, col])
        bound = n * np.finfo(np.float64).eps * np.abs(P[:, col]).sum()
        assert abs(got[col] - exact) <= bound
    assert k8.dot_partials(n, q, 3) == 3 * q * -(-n // rb)


def test_k8_lanes_match_single_calls():
    """K8's plain version on lanes: a weight table per lane (the budget
    sweep's) and one table shared by the lanes (GreedyEig's), in one call,
    equal a call per lane, and the sweep's lanes the JAX product of each
    lane's weights (float64); GreedyEig's flat (n, R k) block equals its
    lanes side by side."""
    idx, w, jop, top = expander()
    rng = np.random.RandomState(2)
    ws = np.stack([w, w * np.round((0.5 + rng.rand(len(w))) * 256) / 256])
    V = torch.as_tensor(rng.normal(size=(2, N, 4)))
    w_tbl = tl.lap_weight_table(top, torch.as_tensor(ws))
    assert w_tbl.shape == (2, top.nbr_tbl.shape[1], N)
    got, dots = _k8(top, w_tbl, V, dot=True)
    for r in range(2):
        one, d1 = _k8(top, w_tbl[r], V[r], dot=True)
        assert torch.equal(got[r], one) and torch.equal(dots[r], d1)
        ref = np.asarray(jl._ell_apply(jop, jnp.asarray(ws[r]),
                                       jnp.asarray(V[r].numpy())))
        assert rel_err(got[r].numpy(), ref) < 1e-12
    shared = w_tbl[0]
    lanes = _k8(top, shared, V)
    for r in range(2):
        assert torch.equal(lanes[r], _k8(top, shared, V[r]))
    flat = V.permute(1, 0, 2).reshape(N, 8)
    out = tl.ell_applier(top, shared)(flat).reshape(N, 2, 4).permute(1, 0, 2)
    assert rel_err(out.numpy(), lanes.numpy()) < 1e-12


def _jax_cycle(jop, w, B):
    return jax_twogrid(jop, w, lambda U: jl.lap_apply(jop, w, U))(B)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("factor", ["exact", "blocked"])
def test_ell_vcycle_matches_jax_twogrid(factor, dtype, request):
    """One V-cycle: EllVCycle's PyTorch form and its kernel form (cycle,
    then centred by its column sums; and the same through
    _ell_vcycle_kernels) against the JAX package's make_twogrid_precond,
    on the exact chain factor (K1p's cluster body on the card) and on the
    factor decoupled every 1024 rows (its segment body)."""
    if factor == "blocked":
        request.getfixturevalue("blocked_factor")
    idx, w, jop, top = expander()
    npt, jdt, tdt, tol = DTYPES[dtype]
    B = np.random.RandomState(5).normal(size=(N, 4)).astype(npt)
    ref = np.asarray(jax.jit(lambda w_, B_: _jax_cycle(jop, w_, B_))(
        jnp.asarray(w.astype(npt)), jnp.asarray(B)))
    wt = torch.as_tensor(w.astype(npt))
    cyc = ttg.make_twogrid_precond(top, wt, tl.lap_applier(top, wt))
    assert isinstance(cyc, ttg.EllVCycle)
    assert cyc.fac.seg == (1024 if factor == "blocked" else None)
    tB = torch.as_tensor(B)
    assert rel_err(cyc.plain(tB).numpy(), ref) < tol
    assert torch.equal(cyc(tB), cyc.plain(tB))  # CPU tensors: plain
    x, xsum = cyc.cycle(tB, kp.col_sums(tB))
    np.testing.assert_allclose(xsum.numpy(), x.double().sum(0).numpy(),
                               rtol=1e-12, atol=1e-12 * float(x.abs().sum()))
    got = x - (xsum / N).to(tdt)
    assert rel_err(got.numpy(), ref) < tol
    assert torch.equal(ttg._ell_vcycle_kernels(cyc, tB), got)


def test_ell_vcycle_lanes_match_single_cycles():
    """The cycle's kernel forms on two lanes (a factor and a coarse inverse
    per lane, the budget sweep's) equal two single cycles (float64)."""
    idx, w, jop, top = expander()
    rng = np.random.RandomState(3)
    ws = torch.as_tensor(
        np.stack([w, w * np.round((0.5 + rng.rand(len(w))) * 256) / 256]))
    cyc = ttg.make_twogrid_precond(top, ws, tl.lap_applier(top, ws))
    assert isinstance(cyc, ttg.EllVCycle)
    B = torch.as_tensor(rng.normal(size=(2, N, 3)))
    x, xsum = cyc.cycle(B, kp.col_sums(B))
    for r in range(2):
        one = ttg.make_twogrid_precond(top, ws[r],
                                       tl.lap_applier(top, ws[r]))
        xr, xsr = one.cycle(B[r], kp.col_sums(B[r]))
        np.testing.assert_allclose(x[r].numpy(), xr.numpy(), rtol=1e-12,
                                   atol=1e-12 * xr.abs().max().item())
        np.testing.assert_allclose(xsum[r].numpy(), xsr.numpy(), rtol=1e-10)


def test_twogrid_cycle_keeps_the_pytorch_cycle_off_the_ell_product():
    """Over any product but the operator's own unshifted EllProduct (the
    mesh's sharded product, a shifted operator, a plain function) the
    cycle stays the PyTorch closure, which has no kernel form."""
    idx, w, jop, top = expander()
    wt = torch.as_tensor(w)
    apply_L = tl.lap_applier(top, wt)
    fac, Lc_inv = ttg.twogrid_level(top, wt)
    for other in (lambda V: apply_L(V),
                  apply_L.shifted(torch.tensor(1.0, dtype=wt.dtype))):
        cyc = ttg.twogrid_cycle(top, fac, Lc_inv, other)
        assert not isinstance(cyc, ttg.EllVCycle)
        assert not hasattr(cyc, "cycle")
    assert isinstance(ttg.twogrid_cycle(top, fac, Lc_inv, apply_L),
                      ttg.EllVCycle)


def _jax_inner_solve(jop, w, B, X0, c, sigma, iters):
    Minv = jax_twogrid(jop, w, lambda U: jl.lap_apply(jop, w, U))

    def apply_inner(V):
        return (jl.lap_apply(jop, w, V) + jax_shift_term(V, c)
                + jnp.asarray(sigma, V.dtype) * V)

    return jcg.pcg_fixed(apply_inner, B, Minv, iters=iters, X0=X0)


@pytest.mark.parametrize("dtype,iters", [("float64", 1), ("float64", 3),
                                         ("float32", 3)])
def test_ell_pcg_steps_match_jax_pcg_fixed(dtype, iters, blocked_factor):
    """pcg_fixed through K6's plain passes, K8's inner form with its dots
    and the V-cycle's kernel forms (K1p at seg 1024, K8's residual, K7),
    against the JAX package's pcg_fixed on its ELL product and V-cycle
    (and the port's plain loop against both)."""
    idx, w, jop, top = expander()
    npt, jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(11)
    B = rng.normal(size=(N, 4)).astype(npt)
    X0 = (0.1 * rng.normal(size=(N, 4))).astype(npt)
    wj = jnp.asarray(w.astype(npt))
    c = float(np.asarray(jl.lap_inf_norm(jop, wj)))
    sigma = float(np.asarray(32 * np.finfo(npt).eps * c, npt))
    ref = np.asarray(jax.jit(
        lambda w_, B_, X_: _jax_inner_solve(jop, w_, B_, X_, c, sigma,
                                            iters))(wj, jnp.asarray(B),
                                                    jnp.asarray(X0)))
    wt = torch.as_tensor(w.astype(npt))
    apply_L = tl.lap_applier(top, wt)
    Minv = ttg.make_twogrid_precond(top, wt, apply_L)
    assert isinstance(Minv, ttg.EllVCycle) and Minv.fac.seg == 1024
    apply_inner = apply_L.shifted(torch.tensor(c, dtype=tdt),
                                  torch.tensor(sigma, dtype=tdt))
    tX0 = torch.as_tensor(X0)
    got = tcg.pcg_fixed_steps(apply_inner, torch.as_tensor(B), Minv,
                              iters=iters, X0=tX0).numpy()
    assert rel_err(got, ref) < tol
    np.testing.assert_array_equal(tX0.numpy(), X0)  # X0 is not changed
    plain = tcg.pcg_fixed(apply_inner, torch.as_tensor(B), Minv, iters=iters,
                          X0=tX0).numpy()
    assert rel_err(plain, ref) < tol


def test_ell_cg_step_calls_the_route_kernels(monkeypatch, blocked_factor):
    """One CG step of the matrix-free route's graphed solve (the route's
    build over its state: EllProduct and EllVCycle) calls K8 three times
    (A P with the dots, the cycle's two residuals), K1p twice at the
    factor's seg 1024 through the identity permutation, K7 once with
    s = coarse_s, and K6's update and fused pass once each; the PyTorch
    cycle and K1, K1b never."""
    idx, w, _, _ = expander()
    top = tl.build_operator(idx, N)  # its own routes, built at 4096
    wt = torch.as_tensor(w.astype(np.float32))
    route = graphs.twogrid_route(top)
    state, lnorm = route.prepare({"w": wt}, "cold", None)
    apply_L, Minv = route.build(state)
    assert isinstance(apply_L, tl.EllProduct)
    assert isinstance(Minv, ttg.EllVCycle) and Minv.fac.seg == 1024
    assert any(t is top.slot_nbr for t in route.tables())
    assert any(t is top.slot_count for t in route.tables())
    assert any(t is top.ident32 for t in route.tables())
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*args, **kw):
            calls.append((name, kw))
            return real(*args, **kw)

        monkeypatch.setattr(mod, name, call)

    for mod, name in ((k8, "ell_product"), (k1, "tridiag_solve_permuted"),
                      (kb, "coarse_correct"), (kp, "cg_update"),
                      (kp, "cg_direction_dots"), (kp, "col_sums")):
        spy(mod, name)

    def refused(*args, **kw):
        raise AssertionError("a chain solve or cycle outside the kernels")

    monkeypatch.setattr(Minv, "_plain", refused)
    monkeypatch.setattr(k1, "tridiag_solve", refused)
    monkeypatch.setattr(k1, "tridiag_solve_blocked", refused)
    c = lnorm.to(torch.float32)
    inner = apply_L.shifted(c, 32 * torch.finfo(torch.float32).eps * c)
    B = torch.as_tensor(np.random.RandomState(1).normal(size=(N, 4)),
                        dtype=torch.float32)
    tcg.pcg_fixed_steps(inner, B, Minv, iters=1, X0=B)
    start = [name for name, _ in calls]
    calls.clear()
    tcg.pcg_fixed_steps(inner, B, Minv, iters=2, X0=B)
    step = [name for name, _ in calls][len(start):]
    assert step == ["ell_product", "cg_update", "tridiag_solve_permuted",
                    "ell_product", "coarse_correct", "ell_product",
                    "tridiag_solve_permuted", "cg_direction_dots"]
    kws = [kw for _, kw in calls][len(start):]
    assert kws[0]["dot"] and kws[0]["vsum"] is not None
    assert kws[2]["seg"] == 1024 and kws[6]["seg"] == 1024
    assert kws[6]["sums"] and kws[3]["B"] is not None


def test_mac_ell_solve_with_the_card_step_matches_jax(monkeypatch):
    """MAC's matrix-free solve (synthetic(3000), float32, the scale
    benchmark's knobs, three Frank-Wolfe steps) with TRACEMIN's inner
    solve through pcg_fixed_steps (K8, K6, K1p and K7 in their plain
    versions, as the card's step runs them) against the JAX package's:
    the same step count, relaxed lambda_2 (scipy float64 referee) within
    1e-3 relative, as tests/test_torch_mac_ell.py holds the plain loop."""
    from mac_tpu.solvers import MAC as JMAC
    from mac_tpu_torch.ops import lobpcg
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    knobs = dict(fiedler_inner_iters=10, fiedler_maxiter=60,
                 fiedler_tol=6e-4)
    n = 3000
    fi, wf, ci, wc = synthetic(n, seed=0, local=False)
    k = len(wc) // 4
    x_init = np.zeros(len(wc))
    x_init[np.argpartition(wc, -k)[-k:]] = 1.0
    steps = []

    def card_step(apply_A, B, Minv=None, iters=16, X0=None):
        assert isinstance(apply_A, tl.EllProduct)
        assert isinstance(Minv, ttg.EllVCycle)
        steps.append(iters)
        return tcg.pcg_fixed_steps(apply_A, B, Minv, iters, X0)

    monkeypatch.setattr(lobpcg, "pcg_fixed", card_step)
    tm = MAC((fi, wf), (ci, wc), n, device="cpu", **knobs)
    assert tm.dtype == torch.float32 and tm.op.mode == "ell"
    jm = JMAC((fi, wf), (ci, wc), n, dtype=jnp.float32, use_banded=False,
              **knobs)
    tm.xprev0 = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(7), (n, tm._q), dtype=jnp.float32)))
    jr, ju, jup = jm.solve(k, x_init, max_iters=3, use_cache=True)
    tr, tu, tup = tm.solve(k, x_init, max_iters=3, use_cache=True)
    assert steps and set(steps) == {10}
    assert (tm.last_solve_stats["fw_iterations"]
            == jm.last_solve_stats["fw_iterations"] == 3)
    lam_j = scipy_lam2(jm.laplacian(ju))
    lam_t = scipy_lam2(tm.laplacian(tu))
    print(f"n {n}: relaxed lambda_2 port (card step) {lam_t:.12g}, JAX "
          f"{lam_j:.12g}, relative {(lam_t - lam_j) / lam_j:+.3e}")
    assert abs(lam_t - lam_j) <= 1e-3 * abs(lam_j), (lam_t, lam_j)
    assert tr.sum() == k and jr.sum() == k
    assert tup >= lam_t * (1 - 1e-9)


def test_k8_wrapper_passes_its_c_signature(monkeypatch):
    """With a card standing in (the wrapper's checks run on CPU tensors and
    the launch records the exported function and its arguments), K8's
    wrapper calls ell_product_{f32,f64} with one argument for each of its
    C signature's (the stream added by the launch), the lane strides of
    the weight table, V and B (0 for one shared by the lanes), c's and
    sigma's lane flags, n, q, dmax and the lanes, a partial for each
    column and block of rows with the dots; it counts each launch by lanes
    and dtype, and refuses an int64 neighbour or count table, a count
    table of another length, a row-major weight table, float16, mixed
    dtypes and an inner form without V's sums."""
    from mac_tpu_torch.ops.kernels import _build

    launched = []

    def function(src, fn, sigs):
        assert src == "ell" and fn in sigs
        return fn

    def launch(fn, device, *args):
        launched.append((fn, args))
        return 0

    monkeypatch.setattr(k8, "_on_card", lambda nbr, cnt, w_tbl, V: True)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(k8, "ticket", lambda dev: torch.zeros(1))
    k8.reset_counts(k8.ell_product)
    idx, w, jop, top = expander()
    n, dmax = top.nbr_tbl.shape
    rng = np.random.RandomState(4)
    V = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    w_tbl = tl.lap_weight_table(top, torch.as_tensor(w, dtype=torch.float32))
    c = torch.tensor(2.0)
    out, dots = _k8(top, w_tbl, V, vsum=kp.col_sums(V), c=c,
                               sigma=1e-3 * c, dot=True)
    assert out.shape == (n, 4) and dots.shape == (4,)
    V2 = torch.as_tensor(rng.normal(size=(2, n, 12)))
    W2 = torch.stack([w_tbl.double(), 2 * w_tbl.double()])
    _k8(top, W2, V2, B=V2, bsum=kp.col_sums(V2))
    _k8(top, w_tbl.double(), V2)  # one table, 2 lanes
    sig = k8._SIGNATURES["ell_product_f32"]
    (f1, a1), (f2, a2), (f3, a3) = launched
    assert (f1, f2, f3) == ("ell_product_f32", "ell_product_f64",
                            "ell_product_f64")
    assert len(a1) == len(a2) == len(a3) == len(sig) - 1
    # nbr, cnt; w_lane, v_lane; b_lane; c_lane, s_lane; n, q, dmax, lanes
    assert (a1[0], a1[1]) == (top.slot_nbr.data_ptr(),
                              top.slot_count.data_ptr())
    assert (a1[3], a1[5], a1[8], a1[12], a1[14]) == (0, 0, 0, 0, 0)
    assert a1[-4:] == (n, 4, dmax, 1)
    assert a1[15] != 0 and a1[16] != 0 and a1[17] != 0  # part, dot, ticket
    assert (a2[3], a2[5], a2[8]) == (n * dmax, n * 12, n * 12)
    assert a2[-4:] == (n, 12, dmax, 2) and a2[15] == 0
    assert (a3[3], a3[5]) == (0, n * 12) and a3[-4:] == (n, 12, dmax, 2)
    assert k8.ell_product.launches == 3
    assert k8.ell_product.launches_by_lanes == {1: 1, 2: 2}
    assert k8.ell_product.launches_by_dtype == {"float32": 1, "float64": 2}
    assert k8.dot_partials(n, 4, 1) == 4 * -(-n // 128)
    for bad in ((top.slot_nbr.long(), top.slot_count, w_tbl),
                (top.slot_nbr, top.slot_count.long(), w_tbl),
                (top.slot_nbr, top.slot_count[1:], w_tbl),
                (top.slot_nbr, top.slot_count, w_tbl.T.contiguous())):
        with pytest.raises(ValueError):
            k8.ell_product(*bad, V)
    with pytest.raises(TypeError):
        _k8(top, w_tbl.half(), V.half())
    with pytest.raises(TypeError):
        _k8(top, w_tbl.double(), V)
    with pytest.raises(ValueError):
        _k8(top, w_tbl, V, c=c)

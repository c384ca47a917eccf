"""TRACEMIN's inner CG step as the card runs it (kernels K5, K6, K1p, K7),
through the kernels' plain versions on the CPU, against the JAX package.

K5 (the banded product, mac_tpu_torch.ops.kernels.banded.banded_product)
in its plain, inner and residual forms and with its column dots, against
mac_tpu.ops.banded.banded_apply; the CG steps through K6's wrappers
(mac_tpu_torch.ops.cg.pcg_fixed_steps) with the V-cycle's kernel forms
(ops.banded.VCycle.cycle: K1p, K5's residual, K7) against
mac_tpu.ops.cg.pcg_fixed over the JAX operator and V-cycle; one cycle
against make_banded_precond's, on exact factors and on the segment-
decoupled factors of graphs past 4096 nodes; which body of K1p the cycle
sends each factor to; K6's and K1p's segment body's fixed orders of a
column sum (numpy models, block_sum_model and k1p_segment_sum_model)
against an exact float64 sum. Inputs come from numpy seeds and go to both
packages as arrays."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu.ops import cg as jcg
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.ops import cg as tcg
from mac_tpu_torch.ops.kernels import banded as kb
from mac_tpu_torch.ops.kernels import pcg as kp
from mac_tpu_torch.ops.kernels import tridiag as k1

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32, 1e-5),
          "float64": (np.float64, jnp.float64, torch.float64, 1e-12)}


def pose_graph(n, n_loops, span, seed=3):
    """Odometry chain plus short-range loop closures."""
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


# half 1 after RCM (with the overflow split at 1500), and half 2 in the
# original order (spans up to 200 > one block); past 4096 nodes (rcm5000)
# the chain factor is decoupled every CHAIN_LDL_BLOCK rows.
GRAPHS = {"rcm600": ((600, 200, 40), True, 1),
          "rcm1500": ((1500, 1200, 25), True, 1),
          "wide1000": ((1000, 400, 200), False, 2),
          "rcm5000": ((5000, 3000, 25), True, 1)}

_cache = {}


def operators(name, dtype):
    """(JAX operator, its BD, port operator, its BD, w, n) of a graph at
    dtype ("float32" or "float64")."""
    key = (name, dtype)
    if key not in _cache:
        (n_, loops, span), rcm, half = GRAPHS[name]
        idx, w, n = pose_graph(n_, loops, span)
        jbop = (jb.build_banded_rcm(idx, n)[0] if rcm
                else jb.build_banded(idx, n))
        assert jbop.half == half
        npt, jdt, tdt, _ = DTYPES[dtype]
        w = w.astype(npt)
        jBD = jb.assemble_bd(jbop, jnp.asarray(w, jdt), fused=False)
        tbop = convert.banded_operator(jbop)
        tBD = tb.assemble_bd(tbop, torch.as_tensor(w, dtype=tdt))
        _cache[key] = (jbop, jBD, tbop, tBD, w, n)
    return _cache[key]


def rel_err(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def coarse_indicator(agg, n, nc, npt):
    """The coarse assembly's input (mac_tpu/ops/banded.py:549): the (n, nc)
    indicator of each RCM row's aggregate."""
    return (np.asarray(agg)[:n, None] == np.arange(nc)[None, :]).astype(npt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,q", [("rcm600", 4), ("rcm1500", 12),
                                    ("wide1000", 4), ("wide1000", 12),
                                    ("rcm600", "nc"), ("rcm1500", 11),
                                    ("wide1000", 11), ("rcm1500", 33),
                                    ("wide1000", 33), ("rcm600", "rmat"),
                                    ("wide1000", "rmat")])
def test_k5_plain_forms_match_jax_banded_apply(name, q, dtype):
    """K5's plain version: L V, B - L V (B centred) and the inner form,
    with the column dots summed, against banded_apply of the JAX package
    (and the same arithmetic in numpy around it); float64 to 1e-12,
    float32 to 1e-5 relative in norm. V random, or ("rmat") the coarse
    assembly's own input, the aggregates' indicator."""
    jbop, jBD, tbop, tBD, w, n = operators(name, dtype)
    npt, _, tdt, tol = DTYPES[dtype]
    rng = np.random.RandomState(7)
    if q == "rmat":
        V = coarse_indicator(jbop.agg, n, jbop.coarse_nc, npt)
        q = V.shape[1]
    else:
        q = jbop.coarse_nc if q == "nc" else q
        V = rng.normal(size=(n, q)).astype(npt)
    B = rng.normal(size=(n, q)).astype(npt)
    ref = np.asarray(jb.banded_apply(jbop, jBD, jnp.asarray(V)))
    tV, tB = torch.as_tensor(V), torch.as_tensor(B)
    y, dots = kb.banded_product(tBD.ut, tBD.deg, tV, n, dot=True)
    assert rel_err(y.numpy(), ref) < tol
    np.testing.assert_allclose(dots.numpy(), (V.astype(np.float64) * ref)
                               .sum(axis=0), rtol=100 * tol,
                               atol=tol * np.abs(V * ref).sum(axis=0).max())
    r = kb.banded_product(tBD.ut, tBD.deg, tV, n, B=tB,
                          bsum=kp.col_sums(tB)).numpy()
    assert rel_err(r, (B - B.mean(axis=0)) - ref) < tol
    c, sigma = np.asarray(3.5, npt), np.asarray(1e-4, npt)
    inner = kb.banded_product(
        tBD.ut, tBD.deg, tV, n, vsum=kp.col_sums(tV), c=torch.as_tensor(c),
        sigma=torch.as_tensor(sigma)).numpy()
    want = ref + float(c) * V.astype(np.float64).mean(axis=0) + sigma * V
    assert rel_err(inner, want) < tol


def test_k5_split_product_model_holds_the_coarse_assembly_to_1e_5():
    """The wide body's float32 arithmetic (kb.split_product_model: each
    operand split into two TF32 parts, three products a 32-column chunk,
    the chunks added in float32) at the coarse assembly's shape: a
    10000-node banded graph (half 2, 79 block rows), nc = 500 aggregates,
    V the aggregates' indicator centred by each block row's window means;
    every block row's 2 half + 2 terms as one product of K = 768, against
    the float64 product of the same float32 operands, within the 1e-5
    relative in norm that the card holds the kernel to. One TF32 product
    (hi hi alone, 10 bits of ut) misses it."""
    idx, w, n = pose_graph(10000, 3000, 230, seed=5)
    bop = tb.build_banded_rcm(idx, n)[0]
    assert bop.half == 2 and bop.nb == 79 and bop.coarse_nc == 500
    BD = tb.assemble_bd(bop, torch.as_tensor(w, dtype=torch.float32))
    ut = BD.ut.numpy()
    nb, half, nc, BS = bop.nb, bop.half, bop.coarse_nc, kb.BS
    V = np.zeros((nb * BS, nc), dtype=np.float32)
    V[:n] = coarse_indicator(bop.agg.numpy(), n, nc, np.float32)
    num = den = num1 = 0.0
    for b in range(nb):
        lo, hi = max(0, b - half) * BS, min(nb, b + half + 1) * BS
        cb = (V[lo:hi].astype(np.float64).sum(0)
              / ((2 * half + 1) * BS)).astype(np.float32)
        blocks, pieces = [], []
        for t in range(half + 1):
            for bv, piece in ((b + t, ut[t, b].T), (b - t, ut[t, b - t])):
                if bv < 0:
                    continue
                Vb = (V[bv * BS:(bv + 1) * BS] if bv < nb
                      else np.zeros((BS, nc), np.float32))
                blocks.append(Vb - cb)
                pieces.append(piece)
        A, Bm = np.concatenate(pieces, 1), np.concatenate(blocks, 0)
        ref = A.astype(np.float64) @ Bm.astype(np.float64)
        got = kb.split_product_model(A, Bm)
        num += np.sum((got - ref) ** 2)
        num1 += np.sum((kb.tf32(A) @ kb.tf32(Bm) - ref) ** 2)
        den += np.sum(ref ** 2)
    assert math.sqrt(num / den) <= 1e-5
    assert math.sqrt(num1 / den) > 1e-5


def test_k5_plain_lanes_match_jax_per_lane():
    """Two lanes, each its own weights and block, in one call of K5's plain
    version, against the JAX apply per lane (float64)."""
    jbop, _, tbop, _, w, n = operators("rcm600", "float64")
    rng = np.random.RandomState(2)
    ws = np.stack([w, w * (0.5 + rng.rand(len(w)))])
    V = rng.normal(size=(2, n, 4))
    tBD = tb.assemble_bd(tbop, torch.as_tensor(ws))
    got, dots = kb.banded_product(tBD.ut, tBD.deg, torch.as_tensor(V), n,
                                  dot=True)
    for r in range(2):
        jBD = jb.assemble_bd(jbop, jnp.asarray(ws[r]), fused=False)
        ref = np.asarray(jb.banded_apply(jbop, jBD, jnp.asarray(V[r])))
        assert rel_err(got[r].numpy(), ref) < 1e-12
        np.testing.assert_allclose(dots[r].numpy(), (V[r] * ref).sum(0),
                                   rtol=1e-10)


def test_k5_window_branch_follows_the_reference_gate():
    """The window means come from the stacked window up to 64 Mi entries of
    one lane's stack, whatever the lanes, and from the cumsum past it."""
    V = torch.zeros(10, 500)
    assert kb.stacked_window(V, 79, 2)
    assert kb.stacked_window(V.expand(8, 10, 500), 79, 2)
    assert not kb.stacked_window(V, 236, 2)


@jax.jit
def _jax_inner_solve(jbop, w, B, X0, c, sigma, iters_arr):
    BD = jb.assemble_bd(jbop, w, fused=False)
    Minv = jb.make_banded_precond(jbop, BD, w=w)

    def apply_inner(V):
        return (jb.banded_apply(jbop, BD, V) + c * jnp.mean(V, axis=0)
                + sigma * V)

    return jcg.pcg_fixed(apply_inner, B, Minv, iters=iters_arr.shape[0],
                         X0=X0)


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5])
def test_pcg_steps_match_jax_pcg_fixed(iters):
    """pcg_fixed through K6's plain versions, K5's inner form and the
    V-cycle's kernel forms (K1p, K5's residual, K7), against the JAX
    package's pcg_fixed on its banded operator and V-cycle, in float64 at
    1e-10 relative."""
    jbop, jBD, tbop, tBD, w, n = operators("rcm600", "float64")
    rng = np.random.RandomState(11)
    B = rng.normal(size=(n, 4))
    X0 = 0.1 * rng.normal(size=(n, 4))
    c, sigma = 2.0 * float(np.asarray(jBD.deg).max()), 1e-3
    ref = np.asarray(_jax_inner_solve(jbop, jnp.asarray(w), jnp.asarray(B),
                                      jnp.asarray(X0), c, sigma,
                                      jnp.zeros(iters)))
    tw = torch.as_tensor(w)
    Minv = tb.make_banded_precond(tbop, tBD, w=tw)
    assert isinstance(Minv, tb.VCycle) and Minv.fac.seg is None
    apply_inner = tb.BandedProduct(tbop, tBD).shifted(
        torch.tensor(c, dtype=torch.float64),
        torch.tensor(sigma, dtype=torch.float64))
    tX0 = torch.as_tensor(X0)
    got = tcg.pcg_fixed_steps(apply_inner, torch.as_tensor(B), Minv,
                              iters=iters, X0=tX0).numpy()
    assert rel_err(got, ref) < 1e-10
    np.testing.assert_array_equal(tX0.numpy(), X0)  # X0 is not changed
    # ... and the plain loop (the CPU's pcg_fixed) agrees with both.
    plain = tcg.pcg_fixed(apply_inner, torch.as_tensor(B), Minv, iters=iters,
                          X0=tX0).numpy()
    assert rel_err(plain, ref) < 1e-10


@jax.jit
def _jax_precond_apply(jbop, w, B):
    BD = jb.assemble_bd(jbop, w, fused=False)
    return jb.make_banded_precond(jbop, BD, w=w)(B)


@pytest.mark.parametrize("name,dtype", [("rcm600", "float64"),
                                        ("rcm1500", "float32"),
                                        ("rcm5000", "float64"),
                                        ("rcm5000", "float32")])
def test_vcycle_kernel_forms_match_jax_precond(name, dtype):
    """One application of the V-cycle through K1p's and K7's plain forms
    (VCycle.cycle, centred by its column sums) against the JAX package's
    make_banded_precond(...)(B) and the port's plain cycle: float64 to
    1e-10, float32 to 1e-4 relative (the chain solve's scans). Past 4096
    nodes (rcm5000) the chain factor is decoupled every 128 rows, which
    the cycle hands K1p as its seg (the segment body on the card)."""
    jbop, jBD, tbop, tBD, w, n = operators(name, dtype)
    npt, jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-10 if dtype == "float64" else 1e-4
    rng = np.random.RandomState(5)
    B = rng.normal(size=(n, 4)).astype(npt)
    ref = np.asarray(_jax_precond_apply(jbop, jnp.asarray(w, jdt),
                                        jnp.asarray(B)))
    cyc = tb.make_banded_precond(tbop, tBD, w=torch.as_tensor(w, dtype=tdt))
    assert cyc.fac.seg == (tb.CHAIN_LDL_BLOCK if n > 4096 else None)
    tB = torch.as_tensor(B)
    x, xsum = cyc.cycle(tB, kp.col_sums(tB))
    got = (x - (xsum / n).to(tdt)).numpy()
    assert rel_err(got, ref) < tol
    assert rel_err(cyc.plain(tB).numpy(), ref) < tol
    assert rel_err(tb._vcycle_kernels(cyc, tB).numpy(), got) < 1e-12


def test_vcycle_lanes_match_single_cycles():
    """The cycle's kernel forms on two lanes (a factor and a coarse inverse
    per lane) equal two single cycles (float64)."""
    _, _, tbop, _, w, n = operators("rcm600", "float64")
    rng = np.random.RandomState(3)
    ws = torch.as_tensor(np.stack([w, w * (0.5 + rng.rand(len(w)))]))
    BD = tb.assemble_bd(tbop, ws)
    cyc = tb.make_banded_precond(tbop, BD, w=ws)
    B = torch.as_tensor(rng.normal(size=(2, n, 3)))
    x, xsum = cyc.cycle(B, kp.col_sums(B))
    for r in range(2):
        BDr = tb.BDRep(ut=BD.ut[r], deg=BD.deg[r])
        one = tb.make_banded_precond(tbop, BDr, w=ws[r])
        xr, xsr = one.cycle(B[r], kp.col_sums(B[r]))
        np.testing.assert_allclose(x[r].numpy(), xr.numpy(), rtol=1e-12,
                                   atol=1e-12 * xr.abs().max().item())
        np.testing.assert_allclose(xsum[r].numpy(), xsr.numpy(), rtol=1e-10)


def test_k1p_and_k7_plain_forms():
    """K1p's plain form is the gathers around K1's plain solve (centring,
    adding, column sums); K7's the cycle's restrict, product and prolong."""
    _, _, tbop, tBD, w, n = operators("rcm600", "float64")
    fac = tb.chain_factor(tbop, tBD, torch.as_tensor(w))
    rng = np.random.RandomState(8)
    B = torch.as_tensor(rng.normal(size=(n, 4)))
    X = torch.as_tensor(rng.normal(size=(n, 4)))
    iperm, perm = tbop.iperm, tbop.perm
    Bc = B - B.mean(dim=0, keepdim=True)
    want = X + k1.tridiag_solve_plain(fac.dp, fac.l, Bc[iperm])[perm]
    got, s = k1.tridiag_solve_permuted(fac.dp, fac.l, B, iperm, perm,
                                       bsum=kp.col_sums(B), X=X, sums=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(s.numpy(), want.sum(0).numpy(), rtol=1e-12)
    nc, sz = tbop.coarse_nc, tbop.coarse_s
    Lc_inv = torch.as_tensor(rng.normal(size=(nc, nc)))
    out = kb.coarse_correct(B, X, iperm, perm, Lc_inv, sz).numpy()
    agg = tbop.agg[:n].long().numpy()
    rc = np.zeros((nc, 4))
    np.add.at(rc, agg, B.numpy())
    np.testing.assert_allclose(out, X.numpy() + (Lc_inv.numpy() @ rc)[agg],
                               rtol=1e-12, atol=1e-12)


def test_segment_factor_whole_row_solve_is_the_blocked_solve():
    """On the chain factor of a graph past 4096 nodes (decoupled every 128
    rows, l = 0 at each segment start) the whole-row plain solve equals the
    blocked plain solve at block = seg within 1e-12 (float64): the identity
    K1p's segment body stands on. K1p's plain version with seg (l taken as
    0 at the segment starts) is bitwise its version without."""
    _, _, tbop, tBD, w, n = operators("rcm5000", "float64")
    fac = tb.chain_factor(tbop, tBD, torch.as_tensor(w))
    assert fac.seg == tb.CHAIN_LDL_BLOCK and n > 4096
    assert torch.all(fac.l[::fac.seg] == 0)
    rng = np.random.RandomState(4)
    B = torch.as_tensor(rng.normal(size=(n, 4)))
    whole = k1.tridiag_solve_plain(fac.dp, fac.l, B)
    blocked = k1.tridiag_solve_blocked_plain(fac.dp, fac.l, B,
                                             block=fac.seg)
    assert rel_err(whole.numpy(), blocked.numpy()) < 1e-12
    iperm, perm = tbop.iperm, tbop.perm
    with_seg = k1.tridiag_solve_permuted(fac.dp, fac.l, B, iperm, perm,
                                         bsum=kp.col_sums(B), seg=fac.seg)
    without = k1.tridiag_solve_permuted(fac.dp, fac.l, B, iperm, perm,
                                        bsum=kp.col_sums(B))
    assert torch.equal(with_seg, without)
    # A factor whose l is not zero at the segment starts: the plain version
    # with seg solves the decoupled segments, as the segment body does.
    l_coupled = fac.l.clone()
    l_coupled[fac.seg::fac.seg] = -0.25
    got = k1.tridiag_solve_permuted(fac.dp, l_coupled, B, iperm, perm,
                                    seg=fac.seg)
    want = k1.tridiag_solve_blocked_plain(fac.dp, l_coupled, B[iperm],
                                          block=fac.seg)[perm]
    assert rel_err(got.numpy(), want.numpy()) < 1e-12


def _record_k1p(monkeypatch):
    """The seg of every K1p call ops.banded makes, with K1 and K1b (the
    retired K1b-between-gathers smoothing) refused."""
    segs = []
    real = k1.tridiag_solve_permuted

    def k1p(*args, seg=None, **kw):
        segs.append(seg)
        return real(*args, seg=seg, **kw)

    def refused(*args, **kw):
        raise AssertionError("the cycle's kernels smoothed outside K1p")

    monkeypatch.setattr(tb._k1, "tridiag_solve_permuted", k1p)
    monkeypatch.setattr(tb._k1, "tridiag_solve_blocked", refused)
    monkeypatch.setattr(tb._k1, "tridiag_solve", refused)
    monkeypatch.setattr(tb, "tridiag_solve_factored_fast", refused)
    return segs


def test_vcycle_sends_each_factor_to_its_k1p_body(monkeypatch):
    """VCycle.cycle hands K1p the factor's seg: the segment body for every
    decoupled factor (a graph past 4096 nodes, its budget lanes, and a
    graph past TRIDIAG_SCAN_MAX_N = 32768 nodes, which earlier smoothed by
    K1b between PyTorch gathers), the cluster body for an exact one; no
    other chain solve runs in the cycle, and the cycle keeps no smoother of
    its own."""
    from mac_tpu_torch.ops.tridiag import TRIDIAG_SCAN_MAX_N

    cases = []
    for name in ("rcm600", "rcm5000"):
        _, _, tbop, tBD, w, n = operators(name, "float32")
        cases.append((tbop, tBD, torch.as_tensor(w), n))
    _, _, tbop, _, w, n = operators("rcm5000", "float32")
    rng = np.random.RandomState(6)
    ws = torch.as_tensor(np.stack([w, w * (0.5 + rng.rand(len(w)))]))
    cases.append((tbop, tb.assemble_bd(tbop, ws), ws, n))
    idx, wl, nl = pose_graph(TRIDIAG_SCAN_MAX_N + 300, 2000, 25, seed=9)
    bl = tb.build_banded_rcm(idx, nl)[0]
    wl = torch.as_tensor(wl, dtype=torch.float32)
    cases.append((bl, tb.assemble_bd(bl, wl), wl, nl))
    segs = _record_k1p(monkeypatch)
    for bop, BD, w, n in cases:
        cyc = tb.make_banded_precond(bop, BD, w=w)
        assert isinstance(cyc, tb.VCycle)
        assert not hasattr(cyc, "smooth") and not hasattr(cyc, "k1p")
        lead = w.shape[:-1]
        B = torch.as_tensor(rng.normal(size=(*lead, n, 3)), dtype=BD.ut.dtype)
        segs.clear()
        cyc.cycle(B, kp.col_sums(B))
        want = tb.CHAIN_LDL_BLOCK if n > 4096 else None
        assert segs == [want, want], (n, segs)
        assert k1.permuted_body(want) == ("segment" if n > 4096
                                          else "cluster")


def test_k1p_wrapper_launches_the_body_of_its_seg(monkeypatch):
    """With a card standing in (the wrapper's checks pass for CPU tensors
    and the launch records the exported function and its arguments), K1p
    calls tridiag_solve_perm_seg_* with seg and a partial a segment per
    column for a decoupled factor, tridiag_solve_perm_* for an exact one,
    and counts each launch by body."""
    from mac_tpu_torch.ops.kernels import _build

    launched = []
    real_on_card = k1._on_card

    def on_card(name, dp, l, B):
        real_on_card(name, dp, l, B)
        k1.check_kernel_args(name, dp, l, B)
        return True

    def function(src, fn, sigs):
        assert fn in sigs
        return fn

    def launch(fn, device, *args):
        launched.append((fn, args))
        return 0

    monkeypatch.setattr(k1, "_on_card", on_card)
    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(kp, "ticket", lambda dev: torch.zeros(1))
    k1.reset_counts(k1.tridiag_solve_permuted)
    n, q = 1000, 4
    rng = np.random.RandomState(2)
    dp = torch.as_tensor(1.0 + rng.rand(n))
    l = torch.as_tensor(-0.3 * rng.rand(n))
    B = torch.as_tensor(rng.normal(size=(2, n, q)))
    perm = torch.as_tensor(rng.permutation(n), dtype=torch.int32)
    iperm = torch.argsort(perm).to(torch.int32)
    k1.tridiag_solve_permuted(dp, l, B, iperm, perm, X=B.clone(), sums=True,
                              seg=128)
    k1.tridiag_solve_permuted(dp, l, B, iperm, perm, sums=True)
    (fn_s, args_s), (fn_c, args_c) = launched
    assert fn_s == "tridiag_solve_perm_seg_f64" and args_s[8] == 128
    assert args_s[11] == 1  # adding into X
    assert fn_c == "tridiag_solve_perm_f64"
    assert k1.tridiag_solve_permuted.launches_by_body == {"segment": 1,
                                                          "cluster": 1}
    assert k1.tridiag_solve_permuted.launches_by_lanes == {2: 2}
    with pytest.raises(ValueError):
        k1.tridiag_solve_permuted(dp, l, B, iperm, perm, seg=100)


@pytest.mark.parametrize("shape,seg", [((10000, 4), 128), ((1000, 3), 96),
                                       ((257, 1), 32), ((3000, 2), 1024)])
def test_k1p_segment_sum_order_model_against_exact_sum(shape, seg):
    """k1p_segment_sum_model, the segment body's order of X's column sums
    (a thread's four rows in order, a warp's xor butterfly, the warps in
    order, a block's segments in order, the blocks in order), is within
    1e-14 of the exactly rounded float64 sum."""
    rng = np.random.RandomState(1)
    A = rng.normal(size=shape).astype(np.float32)
    model = k1.k1p_segment_sum_model(A, seg)
    exact = np.array([math.fsum(A[:, j].astype(np.float64))
                      for j in range(shape[1])])
    scale = np.abs(A).sum(axis=0)
    assert np.all(np.abs(model - exact) <= 1e-14 * scale)


@pytest.mark.parametrize("shape,rows", [((1000, 4), 128), ((600, 300), 256),
                                        ((257, 1), 128), ((1000, 4), 256)])
def test_k6_sum_order_model_against_exact_sum(shape, rows):
    """block_sum_model, the kernels' fixed order of a column sum (in each
    item of ROWS rows each thread's rows in order, a warp's xor butterfly,
    the warps in order; then the items a warp a column), is within 1e-14 of
    the exactly rounded float64 sum, and the plain col_sums within 1e-13 of
    it."""
    rng = np.random.RandomState(0)
    A = rng.normal(size=shape).astype(np.float32)
    model = kp.block_sum_model(A, rows=rows)
    exact = np.array([math.fsum(A[:, j].astype(np.float64))
                      for j in range(shape[1])])
    scale = np.abs(A).sum(axis=0)
    assert np.all(np.abs(model - exact) <= 1e-14 * scale)
    plain = kp.col_sums(torch.as_tensor(A)).numpy()
    assert np.all(np.abs(plain - exact) <= 1e-13 * scale)


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("centred", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_k6_direction_dots_plain_is_the_sums_then_the_direction(lanes, centred,
                                                               init):
    """cg_direction_dots' plain form (what the CPU runs) is col_sums_plain's
    dots followed by cg_direction_plain, bitwise: P, rz, P's sums and rz_new,
    at the first step and after it, with Z centred by its sums or not, with
    and without lanes."""
    rng = np.random.RandomState(4)
    lead = (lanes,) if lanes else ()
    P0, R, Z = (torch.as_tensor(rng.normal(size=lead + (300, 5)),
                                dtype=torch.float32) for _ in range(3))
    rz0 = torch.as_tensor(rng.normal(size=lead + (5,)), dtype=torch.float32)
    zsum = kp.col_sums(Z) if centred else None
    P1, rz1 = P0.clone(), rz0.clone()
    psum, rz_new = kp.cg_direction_dots(P1, R, Z, zsum, rz1, init=init,
                                        sums=True)
    P2, rz2 = P0.clone(), rz0.clone()
    want_new = kp.col_sums_plain(R, Z, zsum)
    want_psum = kp.cg_direction_plain(P2, Z, zsum, rz2, want_new, init=init,
                                      sums=True)
    for got, want in ((P1, P2), (rz1, rz2), (psum, want_psum),
                      (rz_new, want_new)):
        assert torch.equal(got, want)
    P3, rz3 = P0.clone(), rz0.clone()
    none, again = kp.cg_direction_dots(P3, R, Z, zsum, rz3, init=init)
    assert none is None and torch.equal(again, rz_new)
    assert torch.equal(P3, P1) and torch.equal(rz3, rz1)


def test_k6_sum_model_sizes_are_the_kernels():
    """The item sizes the wrappers and block_sum_model assume (THREADS,
    R2_ITEMS, rows_of) are csrc/pcg.cu's (kThreads, kR2Items): city10000's
    (10000, 4) single block takes items of one row a thread, its 8 lanes
    and the n = 100000 route's (100000, 4) two."""
    src = (Path(kp.__file__).resolve().parents[2] / "csrc" /
           "pcg.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    r2 = int(re.search(r"constexpr int kR2Items = (\d+);", src)[1])
    assert (kp.THREADS, kp.R2_ITEMS, kp.ROWS) == (threads, r2, threads)
    assert kp.rows_of(10000, 4) == threads
    assert kp.rows_of(10000, 4, 8) == kp.rows_of(100000, 4) == 2 * threads


def test_k6_plain_passes():
    """K6's plain passes: alpha and beta by the reference's safe division
    (0 where the divisor is tiny), X, R, P and rz in place, the sums."""
    rng = np.random.RandomState(1)
    X, R, P, AP, Z = (torch.as_tensor(rng.normal(size=(2, 50, 3)))
                      for _ in range(5))
    X0, R0, P0 = X.clone(), R.clone(), P.clone()
    rz = torch.as_tensor(rng.normal(size=(2, 3)))
    pap = torch.as_tensor(rng.normal(size=(2, 3)))
    pap[1, 2] = 0.0
    rsum = kp.cg_update(X, R, P, AP, rz, pap, sums=True)
    alpha = (rz / pap).unsqueeze(-2)
    alpha[1, 0, 2] = 0.0
    np.testing.assert_allclose(X.numpy(), (X0 + alpha * P).numpy())
    np.testing.assert_allclose(R.numpy(), (R0 - alpha * AP).numpy())
    np.testing.assert_allclose(rsum.numpy(), R.sum(dim=1).numpy())
    zsum = Z.sum(dim=1)
    rz_new = kp.col_sums(R, Z, zsum)
    Zc = Z - Z.mean(dim=1, keepdim=True)
    np.testing.assert_allclose(rz_new.numpy(), (R * Zc).sum(dim=1).numpy(),
                               rtol=1e-12)
    rz_old = rz.clone()
    psum, got = kp.cg_direction_dots(P, R, Z, zsum, rz, sums=True)
    np.testing.assert_array_equal(got.numpy(), rz_new.numpy())
    want = Zc + (rz_new / rz_old).unsqueeze(-2) * P0
    np.testing.assert_allclose(P.numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(rz.numpy(), rz_new.numpy())
    np.testing.assert_allclose(psum.numpy(), P.sum(dim=1).numpy())
    kp.cg_direction_dots(P, R, Z, None, rz, init=True)
    np.testing.assert_array_equal(P.numpy(), Z.numpy())


def test_wrappers_refuse_bad_arguments_and_count_nothing_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; mismatched shapes and sums raise."""
    wrappers = (kb.banded_product, kb.coarse_correct,
                k1.tridiag_solve_permuted, kp.col_sums, kp.cg_update,
                kp.cg_direction_dots)
    k1.reset_counts(*wrappers)
    _, _, tbop, tBD, w, n = operators("rcm600", "float32")
    V = torch.zeros(n, 4)
    kb.banded_product(tBD.ut, tBD.deg, V, n)
    kp.col_sums(V)
    assert all(f.launches == 0 for f in wrappers)
    with pytest.raises(ValueError):
        kp.col_sums(V, torch.zeros(n, 3))
    with pytest.raises(ValueError):
        kp.cg_update(V, V, V, V, torch.zeros(4), torch.zeros(4))  # pap f32
    with pytest.raises(ValueError):
        kp.cg_direction_dots(V, V, torch.zeros(n, 3), None, torch.zeros(4))
    with pytest.raises(ValueError):  # rz of the wrong type
        kp.cg_direction_dots(V, V, V, None, torch.zeros(4).double())
    with pytest.raises(ValueError):
        kb.banded_product(tBD.ut, tBD.deg, torch.zeros(n + 1, 4), n)
    with pytest.raises(ValueError):
        kb.coarse_correct(V, torch.zeros(n, 3), tbop.iperm, tbop.perm,
                          torch.zeros(3, 3), 2)

"""Kernel K4's plain version (mac_tpu_torch.ops.kernels.syev.sym_eig_plain,
the round-robin cyclic Jacobi that a CPU tensor takes) against
numpy.linalg.eigh and the JAX package's jnp.linalg.eigh, and the port's
TRACEMIN, whose Rayleigh-Ritz eigensolves run through it, against the JAX
package's, single and over lanes (the lanes' batches go to sym_eig, never
to torch.linalg.eigh), at the default block of q = 4 columns and at q =
11 and 12, whose 3q x 3q Rayleigh-Ritz matrices take K4w on the card; the
choice of the kernel's body; MAC built for any block on a CUDA device.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
Inputs are made from numpy seeds.

Tolerances, with eps the dtype's and ||H|| the Frobenius norm: eigenvalues
within 2 k eps ||H|| of numpy's float64 ones (of the same H rounded to the
dtype); the residual ||H V - V diag(evals)|| within 2 k eps ||H|| and
||V^T V - I|| within 2 k eps; a cluster of equal eigenvalues by its
invariant subspace, its projector within 2 k eps ||H|| / gap of numpy's
(the clusters 1 apart); against JAX's eigenvectors, each |cosine| within
2 k eps / (gap / ||H||)^2 of 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu_torch.ops.kernels.syev import (MAX_SWEEPS, RING, SMEM_LIMIT,
                                            WARP_MAX_K, body_for, sym_eig,
                                            sym_eig_plain, wide_scratch_bytes,
                                            wide_smem_bytes)

torch.set_num_threads(1)

# Orders of the warp body (up to 32) and of K4w: 33, the Rayleigh-Ritz
# matrix of q = 11, 36 (q = 12) and 96 (q = 32).
KS = (1, 2, 3, 4, 12, 31, 32, 33, 36, 96)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _matrices(kind, k, batch=3, seed=0):
    """(batch, k, k) float64 symmetric matrices of a kind, and the sizes of
    the clusters of equal eigenvalues they were built with (None: no
    planted cluster)."""
    rng = np.random.RandomState(seed + 97 * k)
    if kind == "random":
        A = rng.normal(size=(batch, k, k))
        return A + A.transpose(0, 2, 1), None
    if kind == "diagonal":
        return np.stack([np.diag(rng.normal(size=k))
                         for _ in range(batch)]), None
    if kind == "zero":
        return np.zeros((batch, k, k)), None
    # clustered: Q diag(lam) Q^T with lam in blocks of equal values.
    sizes = [min(3, k - i) for i in range(0, k, 3)]
    out = []
    for _ in range(batch):
        lam = np.repeat(np.arange(len(sizes)) * 1.0 - 1.5, sizes)
        Q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        out.append((Q * lam) @ Q.T)
    A = np.stack(out)
    return (A + A.transpose(0, 2, 1)) / 2, sizes


def _check(H64, evals, V, dtype, sizes):
    """The tolerances of the module docstring, per matrix."""
    k = H64.shape[-1]
    eps = torch.finfo(dtype).eps
    evals = evals.double().numpy()
    V = V.double().numpy()
    for h, e, v in zip(H64, evals, V):
        hn = max(np.linalg.norm(h), np.finfo(np.float64).tiny)
        ref, vref = np.linalg.eigh(h)
        tol = 2 * k * eps
        assert np.all(np.diff(e) >= 0), e  # ascending
        np.testing.assert_allclose(e, ref, rtol=0, atol=tol * hn)
        resid = np.linalg.norm(h @ v - v * e[None, :])
        assert resid <= tol * hn, (resid, tol * hn)
        assert np.abs(v.T @ v - np.eye(k)).max() <= tol
        # The sign convention: each column's largest entry (the first on
        # ties) is positive.
        top = v[np.argmax(np.abs(v), axis=0), np.arange(k)]
        assert np.all(top > 0), top
        if sizes is not None:  # clusters 1 apart
            start = 0
            for size in sizes:
                P = v[:, start:start + size] @ v[:, start:start + size].T
                Pref = (vref[:, start:start + size]
                        @ vref[:, start:start + size].T)
                assert np.abs(P - Pref).max() <= tol * hn  # gap 1
                start += size


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "diagonal", "zero", "clustered"])
@pytest.mark.parametrize("k", KS)
def test_plain_jacobi_matches_numpy_eigh(k, kind, dtype):
    """A batch of three matrices (k from 1 to 96, float32 and float64):
    eigenvalues, residual, orthogonality, order, the sign convention and
    clusters by subspace, against numpy.linalg.eigh in float64."""
    dt = DTYPES[dtype]
    A, sizes = _matrices(kind, k)
    H = torch.as_tensor(A, dtype=dt)
    evals, V = sym_eig(H)  # a CPU tensor: the plain version
    assert evals.dtype == V.dtype == dt
    assert evals.shape == (3, k) and V.shape == (3, k, k)
    _check(H.double().numpy(), evals, V, dt, sizes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", KS)
def test_plain_jacobi_matches_jax_eigh(k, dtype):
    """The eigenvalues of the JAX package's jnp.linalg.eigh (the call K4
    stands for) on the same random matrices in the same dtype, within
    2 k eps ||H||, and its eigenvectors up to sign (random matrices:
    simple eigenvalues)."""
    dt = DTYPES[dtype]
    A, _ = _matrices("random", k, seed=5)
    H = torch.as_tensor(A, dtype=dt)
    evals, V = sym_eig(H)
    jw, jv = jnp.linalg.eigh(jnp.asarray(H.numpy()))
    jw, jv = np.asarray(jw, np.float64), np.asarray(jv, np.float64)
    eps = torch.finfo(dt).eps
    for h, e, v, je, jvv in zip(H.double().numpy(), evals.double().numpy(),
                                V.double().numpy(), jw, jv):
        hn = np.linalg.norm(h)
        np.testing.assert_allclose(e, je, rtol=0, atol=2 * k * eps * hn)
        if k == 1:
            continue
        gap = np.min(np.diff(je)) / hn
        cos = np.abs(np.sum(v * jvv, axis=0))
        assert np.all(cos >= 1 - 2 * k * eps / gap ** 2), (cos, gap)


def test_plain_jacobi_stays_in_the_dtype_and_the_batch_shape():
    """Leading batch dimensions pass through; float32 computes in float32
    (its result differs from the float64 run's by more than float64
    rounding); a single matrix is a batch of none."""
    A, _ = _matrices("random", 12, batch=6, seed=2)
    H = torch.as_tensor(A.reshape(2, 3, 12, 12))
    e64, V64 = sym_eig_plain(H)
    e32, V32 = sym_eig_plain(H.float())
    assert e64.shape == (2, 3, 12) and V64.shape == (2, 3, 12, 12)
    assert e32.dtype == torch.float32
    assert (e32.double() - e64).abs().max() > 1e-10
    e1, V1 = sym_eig(H[1, 2])
    assert torch.equal(e1, e64[1, 2]) and torch.equal(V1, V64[1, 2])


def test_sym_eig_refuses_what_it_does_not_take():
    """A non-square or 1-D tensor raises on the CPU; the kernel's own
    limits (float32/float64, contiguous; any order) are checked on the
    card (tests/test_torch_cuda.py). The warp body ends at order 32."""
    with pytest.raises(ValueError):
        sym_eig(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        sym_eig(torch.zeros(4, dtype=torch.float64))
    assert WARP_MAX_K == 32


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_tracemin_on_sym_eig_matches_jax(prec, monkeypatch):
    """The port's TRACEMIN, whose Rayleigh-Ritz eigensolves go through
    sym_eig (the plain Jacobi here), against the JAX package's on the same
    banded operator, start block and injected previous-iterate block, at
    the parity tolerances of tests/test_torch_eigen.py (lambda_2 rtol 1e-4,
    |<v, v'>| >= 1 - 1e-4), with sym_eig called at the entry and once an
    outer iteration."""
    import mac_tpu_torch.ops.kernels.syev as syev_mod
    from tests.test_torch_eigen import test_tracemin_matches_jax

    calls = []
    real = syev_mod.sym_eig

    def counted(H):
        calls.append(tuple(H.shape))
        return real(H)

    monkeypatch.setattr(syev_mod, "sym_eig", counted)
    test_tracemin_matches_jax(prec)
    assert calls[0] == (4, 4) and set(calls[1:]) == {(12, 12)}
    assert len(calls) >= 2


def _lane_calls(monkeypatch):
    """Count sym_eig's calls by shape and make torch.linalg.eigh raise:
    TRACEMIN's lanes must send every Rayleigh-Ritz eigensolve to K4."""
    import mac_tpu_torch.ops.kernels.syev as syev_mod

    calls = []
    real = syev_mod.sym_eig

    def counted(H):
        calls.append(tuple(H.shape))
        return real(H)

    def refused(*args, **kw):
        raise AssertionError("torch.linalg.eigh called inside TRACEMIN's "
                             "lanes")

    monkeypatch.setattr(syev_mod, "sym_eig", counted)
    monkeypatch.setattr(torch.linalg, "eigh", refused)
    return calls


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_tracemin_lanes_run_rayleigh_ritz_on_sym_eig(prec, monkeypatch):
    """tracemin_fiedler_lanes on three lanes (the n = 700 banded operator
    at three weight vectors, each lane its own preconditioner) sends its
    Rayleigh-Ritz eigensolves to sym_eig as one (R, k, k) batch, at the
    entry and once an outer iteration, and never calls torch.linalg.eigh;
    each lane agrees with the port's single tracemin_fiedler and with the
    JAX package's tracemin_fiedler under vmap, at the parity tolerances of
    test_tracemin_on_sym_eig_matches_jax (lambda_2 rtol 1e-4, |<v, v'>| >=
    1 - 1e-4)."""
    import jax

    from mac_tpu.ops import banded as jb
    from mac_tpu.ops.lobpcg import tracemin_fiedler as jax_tracemin
    from mac_tpu_torch import convert
    from mac_tpu_torch.ops import banded as tb
    from mac_tpu_torch.ops.lobpcg import (tracemin_fiedler,
                                          tracemin_fiedler_lanes)
    from tests.test_torch_banded import GRAPHS, pose_graph
    from tests.test_torch_eigen import JDT, TDT, jax_xprev

    jdt, tdt = JDT[prec], TDT[prec]
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jdt)
    tbop = convert.banded_operator(jbop)
    rng = np.random.RandomState(11)
    W = w[None, :] * rng.uniform(0.5, 1.5, size=(3, len(w)))
    X0 = rng.normal(size=(n, 4))
    kw = dict(tol=1e-12, maxiter=6, inner_iters=5, rel_tol=1e-12)
    xprev = torch.tensor(jax_xprev(n, 4, jdt))

    @jax.jit
    @jax.vmap
    def run_jax(w):
        BD = jb.assemble_bd(jbop, w, fused=False)
        M = jb.make_banded_precond(jbop, BD, w=w)
        return jax_tracemin(lambda V: jb.banded_apply(jbop, BD, V),
                            jnp.asarray(X0, jdt), 2.0 * jnp.max(BD.deg), M,
                            coeff_dtype=None if prec == "f64" else jdt, **kw)

    jres = run_jax(jnp.asarray(W, jdt))
    tW = torch.as_tensor(W, dtype=tdt)
    BDs = [tb.assemble_bd(tbop, tw) for tw in tW]
    Ms = [tb.make_banded_precond(tbop, BD, w=tw) for BD, tw in zip(BDs, tW)]
    lnorm = torch.stack([2.0 * BD.deg.max() for BD in BDs])
    coeff = None if prec == "f64" else tdt

    def apply_lanes(V):
        return torch.stack([tb.banded_apply(tbop, BD, v)
                            for BD, v in zip(BDs, V)])

    def minv_lanes(V):
        return torch.stack([M(v) for M, v in zip(Ms, V)])

    singles = [tracemin_fiedler(
        lambda V, BD=BD: tb.banded_apply(tbop, BD, V),
        torch.as_tensor(X0, dtype=tdt), c, M, xprev0=xprev,
        coeff_dtype=coeff, **kw) for BD, M, c in zip(BDs, Ms, lnorm)]
    calls = _lane_calls(monkeypatch)
    res = tracemin_fiedler_lanes(
        apply_lanes, torch.as_tensor(X0, dtype=tdt), lnorm, minv_lanes,
        xprev0=xprev, coeff_dtype=coeff, **kw)
    monkeypatch.undo()
    assert calls[0] == (3, 4, 4)
    assert len(calls) == int(res.iters.max()) + 1
    assert set(calls[1:]) == {(3, 12, 12)}
    for r in range(3):
        v = res.X[r, :, 0].double().numpy()
        for lam, x in ((singles[r].lam[0], singles[r].X[:, 0]),
                       (jres.lam[r, 0], jres.X[r, :, 0])):
            np.testing.assert_allclose(float(res.lam[r, 0]), float(lam),
                                       rtol=1e-4)
            x = np.asarray(x, np.float64)
            cos = abs(v @ x) / (np.linalg.norm(v) * np.linalg.norm(x))
            assert cos >= 1 - 1e-4, (r, cos)
    if prec == "f64":  # f32 may stop earlier, at its own floor
        assert res.iters.tolist() == [6, 6, 6]
        assert [int(i) for i in jres.iters] == [6, 6, 6]


def test_fiedler_pair_lanes_batches_its_eigensolves(monkeypatch):
    """GreedyEig's trial chunk (utils.fiedler.fiedler_pair_lanes: R graphs
    that each add one edge, as one TRACEMIN over lanes) hands sym_eig one
    (R, 4, 4) batch at the entry and one (R, 12, 12) batch an outer
    iteration, and no matrix to torch.linalg.eigh."""
    from chip_smoke import chain_instance
    from mac_tpu_torch.solvers import GreedyEig

    fixed, cands = chain_instance(600, 300, 5)
    g = GreedyEig(fixed, cands, 600, device="cpu")
    x = np.zeros(len(cands))
    x[:100] = 1.0
    _, X = g._eval(x, g._X0)
    calls = _lane_calls(monkeypatch)
    lams, Xs = g._eval_chunk(x, np.arange(100, 108), X)
    monkeypatch.undo()
    assert lams.shape == (8,) and np.all(np.isfinite(lams))
    assert calls[0] == (8, 4, 4) and len(calls) >= 2
    assert set(calls[1:]) == {(8, 12, 12)}


@pytest.mark.parametrize("k, dtype, body", [
    (1, torch.float32, "warp"), (32, torch.float64, "warp"),
    (33, torch.float32, "wide_shared"), (33, torch.float64, "wide_shared"),
    (168, torch.float32, "wide_shared"), (169, torch.float32,
                                          "wide_workspace"),
    (180, torch.float32, "wide_workspace"),
    (118, torch.float64, "wide_shared"), (119, torch.float64,
                                          "wide_workspace"),
    (130, torch.float64, "wide_workspace")])
def test_sym_eig_dispatch_picks_the_body(k, dtype, body):
    """The body sym_eig runs on the card for order k: the warp body up to
    32, K4w in shared memory while each block of its cluster (the ring of
    at least one slot, A twice by slots and the round's parameters;
    syev.cu's wide_smem_bytes) fits the 232,448 bytes a block may opt
    into, K4w on a workspace past it (the A block's region and V^T,
    wide_scratch_bytes a matrix, more than the three-pass K4w's): the edges
    at k 168 / 169 (float32) and 118 / 119 (float64), as before."""
    assert body_for(k, dtype) == body
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = wide_scratch_bytes(k, itemsize)
    smem = wide_smem_bytes(k, itemsize)
    m = k + k % 2
    assert nbytes % 16 == 0 and nbytes >= 2 * m * m * itemsize
    assert 2 * m * m * itemsize < smem <= nbytes - m * m * itemsize + 144 + (
        RING * m * 2 * itemsize)
    if k > WARP_MAX_K:
        assert (smem <= SMEM_LIMIT) == (body == "wide_shared")


def _k4w_pairs(m, r):
    """(P, Q), p < q, of the m / 2 pairs of round r (the kernel's
    round-robin order)."""
    slot = [0] + [((j - 1 + r) % (m - 1)) + 1 for j in range(1, m)]
    a = np.array([slot[i] for i in range(m // 2)])
    b = np.array([slot[m - 1 - i] for i in range(m // 2)])
    return np.minimum(a, b), np.maximum(a, b)


def _k4w_params(app, aqq, apq):
    """act, s, tau and the new a_pp, a_qq of each pair, in the operands'
    dtype, by the kernel's expressions (0 where a_pq = 0)."""
    dt = apq.dtype.type
    act = apq != 0
    one = dt(1)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        d = aqq - app
        a2 = apq + apq
        t = np.where(act, a2 / (d + np.copysign(np.hypot(d, a2), d)),
                     dt(0)).astype(apq.dtype)
        c = one / np.hypot(t, one)
        s = np.where(act, t * c, dt(0)).astype(apq.dtype)
        tau = np.where(act, s / (one + c), dt(0)).astype(apq.dtype)
    return act, s, tau, app - t * apq, aqq + t * apq


def _k4w_rot(x, y, s, tau):
    """Rows (or columns) p and q under (s, tau): x + sigma s (y - sigma tau
    x), sigma -1 at p and +1 at q, as the kernel writes it."""
    return x + (-s) * (y - (-tau) * x), y + s * (x - tau * y)


def k4w_model(H):
    """A numpy model of the three-pass K4w's rounds (commit 9f43cf3) on one
    matrix H (k, k) in H's dtype, each operation rounded to the dtype as
    numpy rounds it: (A, V^T, sweeps) after the stop rule. A round: the
    parameters, then rows p, q of A and of V^T for every pair, then
    columns p, q of A for every pair, then the new diagonal."""
    dt = H.dtype
    k = H.shape[0]
    m = k + (k & 1)
    A = np.zeros((m, m), dt)
    A[:k, :k] = H  # a zero row and column pad an odd k
    VT = np.eye(m, dtype=dt)
    off = ~np.eye(m, dtype=bool)
    tol = np.finfo(dt).eps * np.sqrt(np.sum(A * A, dtype=dt))
    for sweep in range(MAX_SWEEPS + 1):
        if (sweep == MAX_SWEEPS
                or np.sqrt(np.sum(A * A * off, dtype=dt)) <= tol):
            break
        for r in range(m - 1):
            P, Q = _k4w_pairs(m, r)
            act, s, tau, dp, dq = _k4w_params(A[P, P], A[Q, Q], A[P, Q])
            on = s != 0
            for M in (A, VT):
                nx, ny = _k4w_rot(M[P], M[Q], s[:, None], tau[:, None])
                M[P[on]], M[Q[on]] = nx[on], ny[on]
            nx, ny = _k4w_rot(A[:, P], A[:, Q], s, tau)
            A[:, P[on]], A[:, Q[on]] = nx[:, on], ny[:, on]
            A[P[act], P[act]], A[Q[act], Q[act]] = dp[act], dq[act]
            A[P[act], Q[act]] = A[Q[act], P[act]] = 0
    return A, VT, sweep


def _k4w_slot_home(s, m):
    """(pair, side) of slot s: slot s < m / 2 is side 0 of pair s, slot m -
    1 - a side 1 of pair a."""
    h = m // 2
    s = np.asarray(s)
    return np.where(s < h, s, m - 1 - s), (s >= h).astype(np.int64)


def k4w_slot_model(H):
    """The redesigned K4w's schedule on one matrix H (k, k), as numpy arrays
    in H's dtype: (A, V^T, sweeps). A lives by slots in two buffers of four
    planes (side of the row, side of the column) x (pair, pair); a round
    reads one buffer and writes the other at the next round's slots (slot
    j >= 2 to j - 1, 1 to m - 1, 0 stays); every 2 x 2 block of two pairs'
    sides is rotated by its row pair, then by its column pair, with side
    0's (sigma s, sigma tau) and side 1's their negatives (sigma -1 at p,
    +1 at q); a diagonal block takes its new diagonal and zeros where its
    pair acts. The next round's parameters come from this round's: the
    next pair's a_pq from its block read before this round's writes and
    rotated, its a_pp and a_qq from this round's new diagonal (or as they
    were), by the warp body's expressions; round 0's from the matrix as
    loaded. V^T takes each round's (p, q, s, tau) after A's last round
    (the V block trailing). The stop test sums A by index as k4w_model
    does."""
    dt = H.dtype
    k = H.shape[0]
    m = k + (k & 1)
    h = m // 2
    A = np.zeros((m, m), dt)
    A[:k, :k] = H
    pi, si = _k4w_slot_home(np.arange(m), m)  # round 0: slot i holds i
    buf = [np.zeros((2, 2, h, h), dt), np.zeros((2, 2, h, h), dt)]
    buf[0][si[:, None], si[None, :], pi[:, None], pi[None, :]] = A
    # Where the entry of (pair, side) goes next round.
    slot_of = np.stack([np.arange(h), m - 1 - np.arange(h)], 1)  # [a, side]
    nslot = np.where(slot_of == 0, 0, np.where(slot_of == 1, m - 1,
                                               slot_of - 1))
    npair, nside = _k4w_slot_home(nslot, m)
    off = ~np.eye(m, dtype=bool)
    tol = np.finfo(dt).eps * np.sqrt(np.sum(A * A, dtype=dt))
    zero, z = dt.type(0), np.zeros(h, dt)
    # Round 0's parameters come from a round that rotates and moves
    # nothing.
    ss0, tt0, d0, d1, act = z, z, z, z, np.zeros(h, bool)
    ab, rounds, sweep, r, recs = 0, -1, 0, m - 2, []
    ar = np.arange(h)
    while True:
        real = rounds >= 0
        rn = r + 1 if r + 1 < m - 1 else 0
        rl = r if real else 0
        A0 = buf[ab]
        # Every block rotated: x[sa][sb] (h, h) at pairs (a, b).
        x = [[A0[sa, sb].copy() for sb in (0, 1)] for sa in (0, 1)]
        ra, ta = ss0[:, None], tt0[:, None]
        on = ra != 0
        for sb in (0, 1):
            n0 = x[0][sb] + ra * (x[1][sb] - ta * x[0][sb])
            n1 = x[1][sb] + (-ra) * (x[0][sb] - (-ta) * x[1][sb])
            x[0][sb], x[1][sb] = np.where(on, n0, x[0][sb]), np.where(
                on, n1, x[1][sb])
        cb, tb = ss0[None, :], tt0[None, :]
        on = cb != 0
        for sa in (0, 1):
            n0 = x[sa][0] + cb * (x[sa][1] - tb * x[sa][0])
            n1 = x[sa][1] + (-cb) * (x[sa][0] - (-tb) * x[sa][1])
            x[sa][0], x[sa][1] = np.where(on, n0, x[sa][0]), np.where(
                on, n1, x[sa][1])
        # The next round's pairs: p at (u, su), q at (v, sv) of this round.
        P, Q = _k4w_pairs(m, rn)
        u, su = _k4w_slot_home(np.where(P == 0, 0, (P - 1 - rl) % (m - 1)
                                        + 1), m)
        v, sv = _k4w_slot_home(np.where(Q == 0, 0, (Q - 1 - rl) % (m - 1)
                                        + 1), m)
        rot = np.stack([np.stack([x[0][0], x[0][1]]),
                        np.stack([x[1][0], x[1][1]])])
        raw = A0[su, sv, u, u]
        apq = np.where(u != v, rot[su, sv, u, v],
                       np.where(act[u], zero, raw))
        dd = np.stack([d0, d1])
        app = np.where(act[u], dd[su, u], A0[su, su, u, u])
        aqq = np.where(act[v], dd[sv, v], A0[sv, sv, v, v])
        if real:
            A1 = buf[ab ^ 1]
            for sa in (0, 1):
                for sb in (0, 1):
                    val = x[sa][sb].copy()
                    val[ar, ar] = np.where(act, dd[sa] if sa == sb else zero,
                                           A0[sa, sb, ar, ar])
                    A1[nside[:, sa][:, None], nside[:, sb][None, :],
                       npair[:, sa][:, None], npair[:, sb][None, :]] = val
            Pr, Qr = _k4w_pairs(m, r)
            s0p = np.array([((j - 1 + r) % (m - 1)) + 1 if j else 0
                            for j in range(h)]) == Pr
            sgn = np.where(s0p, -1, 1).astype(dt)
            recs.append((Pr, Qr, ss0 * sgn, tt0 * sgn))
            ab ^= 1
        act, s, tau, dp, dq = _k4w_params(app, aqq, apq)
        s0p = np.array([((j - 1 + rn) % (m - 1)) + 1 if j else 0
                        for j in range(h)]) == P
        ss0, tt0 = np.where(s0p, -s, s), np.where(s0p, -tau, tau)
        d0, d1 = np.where(s0p, dp, dq), np.where(s0p, dq, dp)
        rounds, r = rounds + 1, rn
        if r == 0:
            if sweep == MAX_SWEEPS:
                break
            Ai = buf[ab][si[:, None], si[None, :], pi[:, None], pi[None, :]]
            if np.sqrt(np.sum(Ai * Ai * off, dtype=dt)) <= tol:
                break
            sweep += 1
    VT = np.eye(m, dtype=dt)
    for P, Q, s, tau in recs:
        on = s != 0
        nx, ny = _k4w_rot(VT[P], VT[Q], s[:, None], tau[:, None])
        VT[P[on]], VT[Q[on]] = nx[on], ny[on]
    return buf[ab][si[:, None], si[None, :], pi[:, None], pi[None, :]], VT, \
        sweep


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "clustered", "sparse"])
@pytest.mark.parametrize("k", [33, 34, 36, 64, 96])
def test_k4w_block_schedule_is_bitwise_the_three_pass_order(k, kind, dtype):
    """The reordering argument behind K4w's redesign, on the CPU: the
    redesigned schedule (k4w_slot_model: A by slots in two buffers, each
    2 x 2 block rotated by its rows, then its columns, with signs by side;
    the next round's parameters from blocks read before the writes; V^T
    from the rounds' records after A's rounds) gives bit for bit the A,
    V^T and sweeps of the three-pass order (k4w_model: rows of A and V^T, then
    columns of A), because each entry sees the same expressions on the same
    operands in the same order; odd k padded with a zero row and column,
    random, clustered and sparse matrices (a_pq = 0 skips rotations),
    float32 and float64. The model's eigenvalues stand within 2 k eps ||H||
    of numpy's float64 ones."""
    dt = np.dtype(dtype)
    if kind == "sparse":
        rng = np.random.RandomState(7 * k)
        X = rng.normal(size=(k, k)) * (rng.uniform(size=(k, k)) < 0.2)
        H64 = X + X.T
    else:
        H64 = _matrices(kind, k, batch=1, seed=11)[0][0]
    H = H64.astype(dt)
    A1, V1, sweeps1 = k4w_model(H)
    A2, V2, sweeps2 = k4w_slot_model(H)
    assert sweeps1 == sweeps2 and 1 <= sweeps1 < MAX_SWEEPS
    assert A1.tobytes() == A2.tobytes() and V1.tobytes() == V2.tobytes()
    evals = np.sort(np.diag(A1)[:k]).astype(np.float64)
    np.testing.assert_allclose(
        evals, np.linalg.eigvalsh(H.astype(np.float64)), rtol=0,
        atol=2 * k * np.finfo(dt).eps * np.linalg.norm(H64))


class _CudaOnCpu(torch.overrides.TorchFunctionMode):
    """While active, what asks for a CUDA device gets the CPU: a stand-in
    for a card in a process that has none."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.device:
            return func(*args, **(kwargs or {}))

        def host(a):
            if isinstance(a, torch.device) and a.type == "cuda":
                return torch.device("cpu")
            return "cpu" if isinstance(a, str) and a.startswith("cuda") else a

        return func(*(host(a) for a in args),
                    **{n: host(v) for n, v in (kwargs or {}).items()})


@pytest.mark.parametrize("q", [10, 11, 40])
def test_mac_builds_any_block_on_cuda(q, monkeypatch):
    """MAC(fiedler_block_q=q) builds for a CUDA device at q 10, 11 (the
    first block whose 3q x 3q Rayleigh-Ritz matrices pass the warp body)
    and 40, the device route's tensors placed on a stand-in card: nothing
    refuses a block width."""
    from chip_smoke import chain_instance
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.solvers import mac as mac_module

    fixed, cands = chain_instance(60, 30, 3)
    monkeypatch.setattr(mac_module, "resolve_device",
                        lambda device: torch.device("cuda"))
    with _CudaOnCpu():
        mac = MAC(fixed, cands, 60, fiedler_block_q=q, use_banded=True,
                  dtype=torch.float32)
    assert mac._q == q and mac.device.type == "cuda"
    assert mac.fiedler_backend == "device"


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("q", [11, 12])
def test_tracemin_wide_block_matches_jax(q, prec, monkeypatch):
    """TRACEMIN with a block of q = 11 and 12 columns, whose Rayleigh-Ritz
    eigensolves (q x q at the entry, 3q x 3q = 33 x 33 and 36 x 36 each
    outer iteration) go through sym_eig (the plain Jacobi here, K4w on the
    card), against the JAX package's on the same banded operator, start
    block and injected previous-iterate block, at the parity tolerances of
    tests/test_torch_eigen.py (lambda_2 rtol 1e-4, |<v, v'>| >= 1 -
    1e-4), the same outer iterations."""
    import jax

    import mac_tpu_torch.ops.kernels.syev as syev_mod
    from mac_tpu.ops import banded as jb
    from mac_tpu.ops.lobpcg import tracemin_fiedler as jax_tracemin
    from mac_tpu_torch import convert
    from mac_tpu_torch.ops import banded as tb
    from mac_tpu_torch.ops.lobpcg import tracemin_fiedler
    from tests.test_torch_banded import GRAPHS, pose_graph
    from tests.test_torch_eigen import JDT, TDT, jax_xprev

    jdt, tdt = JDT[prec], TDT[prec]
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jdt)
    tbop = convert.banded_operator(jbop)
    X0 = np.random.RandomState(3).normal(size=(n, q))
    kw = dict(tol=1e-12, maxiter=8, inner_iters=5, rel_tol=1e-12,
              coeff_dtype=None if prec == "f64" else jdt)

    @jax.jit
    def run_jax(w, X0):
        BD = jb.assemble_bd(jbop, w, fused=False)
        M = jb.make_banded_precond(jbop, BD, w=w)
        return jax_tracemin(lambda V: jb.banded_apply(jbop, BD, V), X0,
                            2.0 * jnp.max(BD.deg), M, **kw)

    jres = run_jax(jnp.asarray(w, jdt), jnp.asarray(X0, jdt))
    calls = []
    real = syev_mod.sym_eig

    def counted(H):
        calls.append(tuple(H.shape))
        return real(H)

    monkeypatch.setattr(syev_mod, "sym_eig", counted)
    tw = torch.as_tensor(w, dtype=tdt)
    BD = tb.assemble_bd(tbop, tw)
    M = tb.make_banded_precond(tbop, BD, w=tw)
    tres = tracemin_fiedler(
        lambda V: tb.banded_apply(tbop, BD, V),
        torch.as_tensor(X0, dtype=tdt), 2.0 * BD.deg.max(), M,
        xprev0=torch.tensor(jax_xprev(n, q, jdt)),
        **dict(kw, coeff_dtype=None if prec == "f64" else tdt))
    assert calls[0] == (q, q) and set(calls[1:]) == {(3 * q, 3 * q)}
    assert tres.iters == int(jres.iters) == len(calls) - 1 >= 1
    np.testing.assert_allclose(float(tres.lam[0]), float(jres.lam[0]),
                               rtol=1e-4)
    v = tres.X[:, 0].double().numpy()
    vj = np.asarray(jres.X[:, 0], np.float64)
    cos = abs(v @ vj) / (np.linalg.norm(v) * np.linalg.norm(vj))
    assert cos >= 1 - 1e-4, cos


def _fake_nvcc(tmp_path, report):
    """A stand-in for nvcc that writes an empty library to its -o argument,
    prints `report` on stderr as ptxas -v would, and logs each run."""
    import sys

    (tmp_path / "report.txt").write_text(report)
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys\n"
        "here = pathlib.Path(__file__).parent\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "pathlib.Path(out).write_bytes(b'')\n"
        "with open(here / 'runs.txt', 'a') as f:\n"
        "    f.write('run\\n')\n"
        "sys.stderr.write((here / 'report.txt').read_text())\n")
    script.chmod(0o755)
    return script


def _ptxas_report(frames):
    """A ptxas -v report of K4's instantiations {(type letter, m): (stack,
    spill stores, spill loads)}; m "shared" or "workspace" names a form of
    K4w, sym_eig_wide_kernel<T, shared>."""
    out = []
    for (t, m), (stack, st, ld) in frames.items():
        name = (f"_ZN12_GLOBAL__N_114sym_eig_kernelI{t}Li{m}EEEvPKT_PS1_S4_ii"
                if isinstance(m, int) else
                f"_ZN12_GLOBAL__N_119sym_eig_wide_kernelI{t}Lb"
                f"{int(m == 'shared')}EEEvPKT_PS1_S4_Phii")
        out += [f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    {stack} bytes stack frame, {st} bytes spill stores, "
                f"{ld} bytes spill loads",
                "ptxas info    : Used 40 registers, used 0 barriers"]
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("spill", [False, True])
def test_k4_frame_gate_reads_the_report_kept_beside_the_library(
        tmp_path, monkeypatch, spill):
    """chip_smoke.py's phase-2 gate on K4's stack frames and spills reads
    nvcc's report kept beside the library (_build.ptxas_log), so it judges
    a library built by an earlier process as it judged the build: nvcc runs
    once, the gate twice, the second time with an empty build_log, and a
    spill at m = 12 fails both times."""
    import chip_smoke
    from mac_tpu_torch.ops.kernels import _build

    frames = {(t, m): (0, 0, 0) for t in "fd" for m in (4, 12, 24)}
    frames[("d", 24)] = (512, 512, 512)
    if spill:
        frames[("f", 12)] = (8, 8, 8)
    nvcc = _fake_nvcc(tmp_path, _ptxas_report(frames))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_log", [])
    for turn in range(2):
        if turn:
            monkeypatch.setattr(_build, "build_log", [])  # a new process
        if spill:
            with pytest.raises(SystemExit):
                chip_smoke.k4_frame_gate(_build.ptxas_log("syev"))
        else:
            regs = chip_smoke.k4_frame_gate(_build.ptxas_log("syev"))
            assert regs[("float64", 24)] == (40, 512, 512, 512)
            assert regs[("float32", 12)] == (40, 0, 0, 0)
    assert (tmp_path / "runs.txt").read_text() == "run\n"
    assert _build.report_path("syev").exists()


@pytest.mark.parametrize("spill", [None, "workspace", "shared"])
def test_k4w_frame_gate_reads_its_own_instantiations(spill):
    """chip_smoke.py's phase-2 gate on K4w: its four instantiations (float32
    and float64, shared memory and workspace) are read apart from the warp
    body's (whose name pattern they must not match), and a spill fails the
    gate only in the shared-memory form."""
    import chip_smoke

    frames = {(t, m): (0, 0, 0) for t in "fd"
              for m in (4, 12, "shared", "workspace")}
    if spill is not None:
        frames[("d", spill)] = (16, 16, 16)
    report = _ptxas_report(frames)
    assert sorted(chip_smoke.k4_instances(report)) == [
        ("float32", 4), ("float32", 12), ("float64", 4), ("float64", 12)]
    if spill == "shared":
        with pytest.raises(SystemExit):
            chip_smoke.k4w_frame_gate(report)
        return
    regs = chip_smoke.k4w_frame_gate(report)
    assert sorted(regs) == [("float32", "shared"), ("float32", "workspace"),
                            ("float64", "shared"), ("float64", "workspace")]
    assert regs[("float64", "workspace")] == (
        (40, 16, 16, 16) if spill else (40, 0, 0, 0))

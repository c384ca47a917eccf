"""Whether the matrix-free route's single-solve pieces agree between the
PyTorch port and the JAX package on the CPU, at a reduced copy of the
n = 100000 expander graph (scripts/bench_scale.py's generator at n = 8000,
its start weights: the top quarter of the candidates by weight). The chain
factor is the segment-decoupled one of that route (the exact-factor size
limit is lowered to 4096 in both packages, so both take the blocked factor
and the n = 100000 route's segment solve). Held: the coarse operator Lc
(the port sums it in float64, the JAX package in float32 and widens it),
one two-grid V-cycle application in float32, and one TRACEMIN eigenpair
with the scale benchmark's knobs in float32 (port against JAX, both
against the port's float64 eigenpair; tests/test_torch_twogrid.py holds
the two packages' float64 solves on the ELL operator against each other).
The random block that seeds TRACEMIN's previous-iterate memory is drawn by
JAX."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mac_tpu.ops.tridiag as jtri
import mac_tpu_torch.ops.tridiag as ttri
from mac_tpu.ops import laplacian as jl
from mac_tpu.ops.twogrid import make_twogrid_precond as jax_twogrid
from mac_tpu.utils.fiedler import fiedler_pair_op as jax_fiedler
from mac_tpu_torch.ops import laplacian as tl
from mac_tpu_torch.ops.twogrid import coarse_laplacian, make_twogrid_precond
from mac_tpu_torch.utils.fiedler import fiedler_pair_op
from scripts.bench_scale import synthetic
from tests.test_torch_eigen import jax_xprev

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

N = 8000
KNOBS = dict(inner_iters=10, maxiter=60, tol=6e-4)


def jax_coarse_laplacian(op, w):
    """The JAX package's coarse operator (mac_tpu/ops/twogrid.py): chunked
    one-hot products accumulated in float32, then widened to float64."""
    ci, cj = op.coarse_idx[:, 0], op.coarse_idx[:, 1]
    nc, m, CH = op.coarse_nc, w.shape[0], 4096
    mp = -(-m // CH) * CH
    ci_p = jnp.concatenate([ci, jnp.full((mp - m,), nc, jnp.int32)])
    cj_p = jnp.concatenate([cj, jnp.full((mp - m,), nc, jnp.int32)])
    w_p = jnp.concatenate([w, jnp.zeros((mp - m,), w.dtype)]).astype(
        jnp.float32)
    iota = jax.lax.broadcasted_iota(jnp.int32, (CH, nc), 1)

    def chunk(Lc, args):
        c_i, c_j, w_c = args
        E = ((iota == c_i[:, None]).astype(jnp.float32)
             - (iota == c_j[:, None]).astype(jnp.float32))
        return Lc + jnp.matmul(E.T * w_c[None, :], E,
                               precision=jax.lax.Precision.HIGHEST), None

    Lc, _ = jax.lax.scan(chunk, jnp.zeros((nc, nc), jnp.float32),
                         (ci_p.reshape(-1, CH), cj_p.reshape(-1, CH),
                          w_p.reshape(-1, CH)))
    return Lc.astype(jnp.float64)


@pytest.fixture
def blocked_factor(monkeypatch):
    monkeypatch.setattr(jtri, "TRIDIAG_SCAN_MAX_N", 4096)
    monkeypatch.setattr(ttri, "TRIDIAG_SCAN_MAX_N", 4096)


def test_ell_pieces_match_jax(blocked_factor):
    fi, wf, ci, wc = synthetic(N, seed=0, local=False)
    k = len(wc) // 4
    x = np.zeros(len(wc))
    x[np.argpartition(wc, -k)[-k:]] = 1.0
    idx = np.concatenate([fi, ci]).astype(np.int64)
    w64 = np.concatenate([wf, x * wc])
    jop, top = jl.build_operator(idx, N), tl.build_operator(idx, N)
    assert top.mode == "ell"
    t_fac = ttri.tridiag_ldl_auto(*tl.lap_tridiagonal_part(
        top, torch.as_tensor(w64)))
    assert t_fac.seg == 1024

    # The coarse operator: float32 accumulation noise only.
    Lc_j = np.asarray(jax.jit(jax_coarse_laplacian)(jop, jnp.asarray(w64)))
    Lc_t = coarse_laplacian(top, torch.as_tensor(w64)).numpy()
    lc_err = np.abs(Lc_t - Lc_j).max() / np.abs(Lc_t).max()
    assert lc_err < 1e-6

    # One V-cycle application in float32, the route's dtype.
    B = np.random.RandomState(3).normal(size=(N, 4))
    w32, B32 = jnp.asarray(w64, jnp.float32), jnp.asarray(B, jnp.float32)
    v_j = np.asarray(jax.jit(lambda w, V: jax_twogrid(
        jop, w, lambda U: jl.lap_apply(jop, w, U))(V))(w32, B32))
    w_t = torch.as_tensor(w64, dtype=torch.float32)
    v_t = make_twogrid_precond(top, w_t, tl.lap_applier(top, w_t))(
        torch.as_tensor(B, dtype=torch.float32)).numpy()
    v_err = np.abs(v_t - v_j).max() / np.abs(v_j).max()
    assert v_err < 1e-4

    # One TRACEMIN eigenpair in float32 in both packages, and the port's
    # float64 one as the reference.
    X0 = np.random.RandomState(4).normal(size=(N, 4))
    jres = jax.jit(functools.partial(jax_fiedler, **KNOBS))(
        jop, w32, jnp.asarray(X0, jnp.float32))
    lam_j, it_j = float(jres.lam[0]), int(jres.iters)
    lam = {}
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                   jnp.float64)):
        tres = fiedler_pair_op(top, torch.as_tensor(w64, dtype=dt),
                               torch.as_tensor(X0, dtype=dt),
                               xprev0=torch.tensor(jax_xprev(N, 4, jdt)),
                               **KNOBS)
        lam[dt] = float(tres.lam[0])
    lam2 = lam[torch.float64]
    # The float32 eigenpairs: within the float32 solves' own distance from
    # the float64 one, and that distance the same in both packages.
    gap_t = (lam[torch.float32] - lam2) / lam2
    gap_j = (lam_j - lam2) / lam2
    assert abs(gap_t) < 1e-4 and abs(gap_j) < 1e-4
    assert abs(gap_t - gap_j) < 1e-5
    print(f"n {N}: Lc rel err {lc_err:.2e}; V-cycle rel err float32 "
          f"{v_err:.2e}; lambda_2 float64 {lam2:.12g}; float32 port "
          f"{gap_t:+.6e}, JAX {gap_j:+.6e} relative to it; float32 "
          f"iterations JAX {it_j}")

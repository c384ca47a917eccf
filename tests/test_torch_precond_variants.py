"""Parity of the banded preconditioner's variants (the block-Jacobi smoother
and the additive cycle) in the PyTorch port against the JAX package's
make_banded_precond, on the CPU, with the checks of the JAX package's own
test (tests/ops/test_banded.py::test_banded_precond_symmetric_and_effective).
Inputs are made from seeds with numpy and handed to both as arrays; the
port runs its kernels' plain versions here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

PAIRS = [("chain", "mult"), ("chain", "additive"), ("bjacobi", "mult"),
         ("bjacobi", "additive")]
# M(B) against the JAX package's, relative to max |M(B)|.
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _pose_graph(n=700, n_loops=260, span=40, seed=3):
    """Chain + short-range loop closures: banded after RCM (the JAX
    package's test graph, tests/ops/test_banded.py)."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    w = 0.5 + rng.rand(len(idx))
    return idx, w, n


@functools.lru_cache(maxsize=None)
def _operators():
    idx, w, n = _pose_graph()
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jnp.float64)
    return jbop, convert.banded_operator(jbop), w, n


def _jdtype(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


@functools.partial(jax.jit, static_argnames=("smoother", "kind"))
def _jax_apply(jbop, w, B, prev_state, smoother, kind):
    """The JAX package's preconditioner at weights w applied to B: cold, or
    (prev_state given) refreshed by Newton-Schulz with rebuild=False, which
    reuses the carried coarse inverse."""
    BD = jb.assemble_bd(jbop, w, fused=False)
    if prev_state is None:
        M, st = jb.make_banded_precond(jbop, BD, w=w, smoother=smoother,
                                       kind=kind, return_state=True)
    else:
        M, st = jb.make_banded_precond(jbop, BD, w=w, smoother=smoother,
                                       kind=kind, prev_state=prev_state,
                                       use_prev=True, rebuild=False,
                                       return_state=True)
    return M(B), st


def _port(tbop, w, dtype, smoother, kind, **kw):
    tw = torch.as_tensor(w, dtype=dtype)
    BD = tb.assemble_bd(tbop, tw)
    return tb.make_banded_precond(tbop, BD, w=tw if smoother == "chain"
                                  else None, smoother=smoother, kind=kind,
                                  **kw), BD


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("smoother,kind", PAIRS)
def test_variant_matches_jax(smoother, kind, dtype):
    """M(B) on a seeded (n, 4) block equals the JAX package's for each
    (smoother, kind): rtol 1e-10 of max |M(B)| in float64, 1e-5 in
    float32. In float64 also the JAX test's checks: M symmetric, and per
    kind a Richardson step on L u = b that contracts the error below 0.7
    (mult) or positivity on four probes (additive: S + P Lc^-1 R double-
    counts smooth components, so its Richardson step need not contract)."""
    jbop, tbop, w, n = _operators()
    rng = np.random.RandomState(2)
    B = rng.normal(size=(n, 4))
    jdt = _jdtype(dtype)
    ref, _ = _jax_apply(jbop, jnp.asarray(w, jdt), jnp.asarray(B, jdt), None,
                        smoother, kind)
    M, BD = _port(tbop, w, dtype, smoother, kind)
    got = M(torch.as_tensor(B, dtype=dtype))
    assert got.dtype == dtype
    _close(got.numpy(), np.asarray(ref), RTOL[dtype])
    if dtype != torch.float64:
        return

    def apply(v):
        return M(torch.as_tensor(v)).numpy()

    x, y = rng.normal(size=(n, 1)), rng.normal(size=(n, 1))
    ip1, ip2 = float(np.sum(apply(x) * y)), float(np.sum(x * apply(y)))
    assert abs(ip1 - ip2) < 1e-8 * max(abs(ip1), 1.0)
    if kind == "additive":
        for _ in range(4):
            z = rng.normal(size=(n, 1))
            assert float(np.sum(z * apply(z))) > 0.0
        return
    u = rng.normal(size=(n, 1))
    u -= u.mean()
    b = tb.banded_apply(tbop, BD, torch.as_tensor(u)).numpy()
    e_pc = u - apply(b)
    e_pc -= e_pc.mean()
    assert np.linalg.norm(e_pc) < 0.7 * np.linalg.norm(u)


@pytest.mark.parametrize("smoother,kind", [("chain", "additive"),
                                           ("bjacobi", "mult")])
def test_variant_lanes_match_per_lane_calls(smoother, kind):
    """With R = 2 lanes (BD and w (2, m), block-Jacobi's inverses (2, nb,
    BS, BS)), each lane's M(B) equals the single call on that lane's
    weights, in float64."""
    _, tbop, w, n = _operators()
    rng = np.random.RandomState(6)
    W = np.stack([w, w * (0.5 + rng.rand(len(w)))])
    B = torch.as_tensor(rng.normal(size=(2, n, 4)))
    M, _ = _port(tbop, W, torch.float64, smoother, kind)
    got = M(B)
    for r in range(2):
        M_r, _ = _port(tbop, W[r], torch.float64, smoother, kind)
        _close(got[r].numpy(), M_r(B[r]).numpy(), 1e-12)


@pytest.mark.parametrize("kind", ["mult", "additive"])
def test_bjacobi_carried_state_matches_jax(kind):
    """Block-Jacobi with a carried state (prev_state, use_prev=True,
    rebuild=False): the coarse inverse is the carried one and the block
    inverses are those of the new weights, as in the JAX package (float64,
    rtol 1e-10); its state carries no chain factor."""
    jbop, tbop, w, n = _operators()
    rng = np.random.RandomState(7)
    w2 = w * (0.5 + rng.rand(len(w)))
    B = rng.normal(size=(n, 4))
    _, jprev = _jax_apply(jbop, jnp.asarray(w), jnp.asarray(B), None,
                          "bjacobi", kind)
    ref, jst = _jax_apply(jbop, jnp.asarray(w2), jnp.asarray(B), jprev,
                          "bjacobi", kind)
    prev = convert.precond_state(jprev, dtype=torch.float64)
    assert prev.chain_dp is None and prev.chain_l is None
    tw2 = torch.as_tensor(w2)
    M, st = tb.make_banded_precond(
        tbop, tb.assemble_bd(tbop, tw2), smoother="bjacobi", kind=kind,
        prev_state=prev, use_prev=True, rebuild=False, return_state=True)
    assert st.Lc_inv is prev.Lc_inv
    assert st.chain_dp is None and st.chain_l is None
    _close(M(torch.as_tensor(B)).numpy(), np.asarray(ref), 1e-10)
    np.testing.assert_array_equal(st.Lc_inv.numpy(), np.asarray(jst.Lc_inv))


def test_refusals():
    """The chain smoother needs w, an unknown smoother or kind raises, and
    kind=None takes PRECOND_KIND ("mult", the form every route takes)."""
    _, tbop, w, n = _operators()
    tw = torch.as_tensor(w)
    BD = tb.assemble_bd(tbop, tw)
    with pytest.raises(ValueError, match="weight vector"):
        tb.make_banded_precond(tbop, BD)
    with pytest.raises(ValueError, match="smoother"):
        tb.make_banded_precond(tbop, BD, w=tw, smoother="jacobi")
    with pytest.raises(ValueError, match="kind"):
        tb.make_banded_precond(tbop, BD, w=tw, kind="multiplicative")
    assert tb.PRECOND_KIND == jb.PRECOND_KIND == "mult"
    B = torch.as_tensor(np.random.RandomState(0).normal(size=(n, 2)))
    torch.testing.assert_close(
        tb.make_banded_precond(tbop, BD, w=tw)(B),
        tb.make_banded_precond(tbop, BD, w=tw, kind="mult")(B),
        rtol=0, atol=0)

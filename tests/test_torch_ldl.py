"""Parity of the chain LDL^T factorisation of the PyTorch port (kernels K3
and K3b, run here as their plain versions) against the JAX package's
tridiag_ldl and tridiag_ldl_blocked, on the CPU; the dispatch of
tridiag_ldl_auto; the wrappers' checks; and, with a card standing in for
the kernels, that every caller on the solvers' routes hands the kernels
what they take. Inputs are made from seeds with numpy and handed to both
packages as arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import tridiag as jt
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.ops.kernels import ldl

torch.set_num_threads(1)


def _chain(n, seed, lanes=None):
    """A diagonally dominant chain: d (n,), e (n - 1,), or (lanes, ...)."""
    rng = np.random.RandomState(seed)
    shape = () if lanes is None else (lanes,)
    e = -(0.5 + rng.rand(*shape, n - 1))
    z = np.zeros((*shape, 1))
    d = (0.1 + rng.rand(*shape, n) - np.concatenate([z, e], -1)
         - np.concatenate([e, z], -1))
    return d, e


def _ulps(a, b):
    """Largest distance in float32 ulps between two float32 arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [10000, 10003])
@pytest.mark.parametrize("block", [128, 1024])
def test_blocked_plain_bitwise_equals_jax(block, n, dtype):
    """K3b's plain version is the JAX package's segment-decoupled factor
    bit for bit, dp and l, with ragged last segments too."""
    d, e = _chain(n, n + block)
    jf = jt.tridiag_ldl_blocked(jnp.asarray(d, dtype), jnp.asarray(e, dtype),
                                block=block)
    tf = tt.tridiag_ldl_blocked(torch.as_tensor(d.astype(dtype)),
                                torch.as_tensor(e.astype(dtype)), block=block)
    assert tf.seg == block and tf.dp.dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    np.testing.assert_array_equal(tf.dp.numpy(), np.asarray(jf.dp))
    np.testing.assert_array_equal(tf.l.numpy(), np.asarray(jf.l))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2500, 3001])
def test_exact_plain_matches_jax(n, dtype):
    """K3's plain version against the JAX package's exact factor: 1e-13
    relative in float64 (two doubling scans, one order of rounding apart at
    most), at most one ulp in float32."""
    d, e = _chain(n, n)
    jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d, dtype), jnp.asarray(e, dtype))
    tf = tt.tridiag_ldl(torch.as_tensor(d.astype(dtype)),
                        torch.as_tensor(e.astype(dtype)))
    assert tf.seg is None
    for got, want in ((tf.dp.numpy(), np.asarray(jf.dp)),
                      (tf.l.numpy(), np.asarray(jf.l))):
        if dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
        else:
            assert _ulps(got, want) <= 1


@pytest.mark.parametrize("kind", ["exact", "blocked"])
def test_lanes_match_separate_jax_calls(kind):
    """R = 3 lanes, a chain each, in one call against three JAX calls:
    the blocked factor bitwise, the exact one within 1e-13 (float64)."""
    n, R = 2049, 3
    d, e = _chain(n, 7, lanes=R)
    if kind == "blocked":
        tf = tt.tridiag_ldl_blocked(torch.as_tensor(d), torch.as_tensor(e),
                                    block=128)
        js = [jt.tridiag_ldl_blocked(jnp.asarray(d[r]), jnp.asarray(e[r]),
                                     block=128) for r in range(R)]
    else:
        tf = tt.tridiag_ldl(torch.as_tensor(d), torch.as_tensor(e))
        js = [jax.jit(jt.tridiag_ldl)(jnp.asarray(d[r]), jnp.asarray(e[r]))
              for r in range(R)]
    assert tuple(tf.dp.shape) == tuple(tf.l.shape) == (R, n)
    for r, jf in enumerate(js):
        for got, want in ((tf.dp[r].numpy(), np.asarray(jf.dp)),
                          (tf.l[r].numpy(), np.asarray(jf.l))):
            if kind == "blocked":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("n,seg", [(32768, None), (32769, 1024)])
def test_auto_dispatch_at_the_scan_limit(n, seg):
    """tridiag_ldl_auto: the exact factor up to TRIDIAG_SCAN_MAX_N rows, the
    factor decoupled every 1024 rows past it; each equal to the explicit
    call, and past it to the JAX package's auto factor bit for bit."""
    assert tt.TRIDIAG_SCAN_MAX_N == 32768
    d, e = _chain(n, 3)
    dt, et = torch.as_tensor(d, dtype=torch.float32), torch.as_tensor(
        e, dtype=torch.float32)
    f = tt.tridiag_ldl_auto(dt, et)
    assert f.seg == seg
    ref = (tt.tridiag_ldl(dt, et) if seg is None
           else tt.tridiag_ldl_blocked(dt, et, block=1024))
    assert torch.equal(f.dp, ref.dp) and torch.equal(f.l, ref.l)
    if seg is not None:
        jf = jt.tridiag_ldl_auto(jnp.asarray(d, jnp.float32),
                                 jnp.asarray(e, jnp.float32))
        np.testing.assert_array_equal(f.dp.numpy(), np.asarray(jf.dp))
        np.testing.assert_array_equal(f.l.numpy(), np.asarray(jf.l))


def _counts():
    return [(dict(w.launches_by_dtype), dict(w.launches_by_lanes), w.launches)
            for w in (ldl.tridiag_ldl, ldl.tridiag_ldl_blocked)]


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors the wrappers and every factor of ops.tridiag run the
    plain versions: no launch, the counts unchanged."""
    def no_launch(*args, **kw):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(ldl, "_launch", no_launch)
    before = _counts()
    d, e = _chain(3000, 1)
    for dtype in (torch.float32, torch.float64):
        dt, et = torch.as_tensor(d, dtype=dtype), torch.as_tensor(e,
                                                                  dtype=dtype)
        dp, l = ldl.tridiag_ldl(dt, et)
        assert dp.dtype == dtype and dp.device.type == "cpu"
        ldl.tridiag_ldl_blocked(dt, et, 128)
        tt.tridiag_ldl(dt, et)
        tt.tridiag_ldl_blocked(dt.expand(2, -1), et.expand(2, -1), 1024)
        tt.tridiag_ldl_auto(dt, et)
    assert _counts() == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes (both devices) and, through check_kernel_args, the kernels'
    dtype and layout rules; a lane stride of 0 (one chain shared) passes."""
    d, e = torch.ones(10), torch.zeros(9)
    for bad_d, bad_e in ((d, torch.zeros(10)), (d[None], e),
                         (torch.ones(2, 10), torch.zeros(3, 9)),
                         (torch.ones(2, 2, 10), torch.zeros(2, 2, 9)),
                         (torch.ones(0), torch.zeros(0))):
        for fn in (ldl.tridiag_ldl, ldl.tridiag_ldl_blocked):
            with pytest.raises(ValueError, match="want d"):
                fn(bad_d, bad_e)
    with pytest.raises(ValueError, match="block"):
        ldl.tridiag_ldl_blocked(d, e, block=0)
    with pytest.raises(TypeError, match="float32 or float64"):
        ldl.check_kernel_args("K3", d.half(), e.half())
    with pytest.raises(TypeError, match="e is torch.float64"):
        ldl.check_kernel_args("K3", d, e.double())
    with pytest.raises(ValueError, match="d not contiguous"):
        ldl.check_kernel_args("K3", torch.ones(20)[::2], e)
    with pytest.raises(ValueError, match="e not contiguous"):
        ldl.check_kernel_args("K3", d, torch.zeros(18)[::2])
    with pytest.raises(ValueError, match="no lanes"):
        ldl.check_kernel_args("K3", torch.ones(0, 10), torch.zeros(0, 9))
    ldl.check_kernel_args("K3", d.expand(4, -1), e.expand(4, -1))
    ldl.check_kernel_args("K3", torch.ones(3, 12)[:, 1:11],
                          torch.zeros(3, 9))


class _StandInCard:
    """Stands in for a card on the CPU: the factor wrappers take CPU
    tensors as if they lay on a card (the kernels' dtype and layout checks
    run), and each launch records the exported function it would call,
    with its lane count, and returns the plain version's result."""

    def __init__(self, monkeypatch):
        self.launched = []
        real_on_card = ldl._on_card

        def on_card(name, d, e):
            real_on_card(name, d, e)  # the shape checks
            ldl.check_kernel_args(name, d, e)
            return True

        def launch(fn, d, e, *extra):
            self.launched.append((fn, d.shape[0] if d.dim() == 2 else 1))
            if fn.startswith("tridiag_ldl_blocked"):
                return ldl.tridiag_ldl_blocked_plain(d, e, *extra)
            return ldl.tridiag_ldl_plain(d, e)

        monkeypatch.setattr(ldl, "_on_card", on_card)
        monkeypatch.setattr(ldl, "_launch", launch)


def test_solver_routes_hand_the_kernels_what_they_take(monkeypatch):
    """With a card standing in: the banded float32 chain factor past 4096
    nodes reaches tridiag_ldl_blocked_f32 and below it tridiag_ldl_f32, a
    budget sweep's lanes one launch for all lanes, the float64 device
    route tridiag_ldl_f64, the matrix-free route's V-cycle (an expander,
    n = 2000) tridiag_ldl_f32; each route's result is the plain run's."""
    from mac_tpu_torch.solvers import MAC

    from chip_smoke import synthetic
    from tests.test_torch_banded import pose_graph

    card = _StandInCard(monkeypatch)
    cases = [
        (pose_graph(4500, 700, 40, 4), dict(use_banded=True,
                                           dtype=torch.float32),
         "tridiag_ldl_blocked_f32"),
        (pose_graph(600, 110, 9, 11), dict(use_banded=True,
                                          dtype=torch.float32),
         "tridiag_ldl_f32"),
        (pose_graph(400, 60, 30, 1), dict(dtype=torch.float64,
                                          use_banded=False),
         "tridiag_ldl_f64"),
        (synthetic(2000), dict(dtype=torch.float32, use_banded=False,
                               fiedler_maxiter=10, fiedler_inner_iters=4),
         "tridiag_ldl_f32"),
    ]
    for graph, kw, want in cases:
        if len(graph) == 4:  # the expander: no band, the V-cycle's factor
            fi, wf, ci, wc = graph
            idx, w, n = np.concatenate([fi, ci]), np.concatenate(
                [wf, wc]), len(wf) + 1
        else:
            idx, w, n = graph
        fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
        k = len(cands[1]) // 2
        mac = MAC(fixed, cands, n, fw_polish=False, round_guard=False,
                  device="cpu", **kw)
        assert mac._banded is not None or len(graph) == 4 or (
            kw["dtype"] == torch.float64)
        assert len(graph) != 4 or mac._banded is None
        card.launched.clear()
        got = mac.solve(k, max_iters=2)
        assert card.launched and {fn for fn, _ in card.launched} == {want}, (
            n, card.launched[:3])
        monkeypatch.undo()
        plain = MAC(fixed, cands, n, fw_polish=False, round_guard=False,
                    device="cpu", **kw).solve(k, max_iters=2)
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)
        card = _StandInCard(monkeypatch)
    idx, w, n = pose_graph(600, 110, 9, 11)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
              fw_polish=False, round_guard=False, device="cpu")
    card.launched.clear()
    mac.solve_sweep([20, 40], max_iters=2)
    assert card.launched and set(card.launched) == {("tridiag_ldl_f32", 2)}

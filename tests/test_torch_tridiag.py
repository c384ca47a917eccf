"""Parity of the PyTorch port's tridiagonal LDL^T factors and solves
(kernels K1 and K1b, run here as their plain versions) against the JAX
package, on the CPU, and the port's solve dispatch. Inputs are made from
seeds with numpy and handed to both as arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import tridiag as jt
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.ops.kernels.tridiag import (tridiag_solve,
                                               tridiag_solve_blocked,
                                               tridiag_solve_blocked_plain,
                                               tridiag_solve_plain)

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def _chain_system(n, seed):
    rng = np.random.RandomState(seed)
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    return d, e, rng


@pytest.mark.parametrize("kind", ["exact", "blocked"])
def test_tridiag_ldl_pivots_match_f64(kind):
    """Exact (Moebius doubling scan) and blocked (128-step recurrence)
    LDL^T factors match the JAX package's in float64 at rtol 1e-10."""
    d, e, _ = _chain_system(3000, 0)
    if kind == "exact":
        jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d), jnp.asarray(e))
        tf = tt.tridiag_ldl(torch.as_tensor(d), torch.as_tensor(e))
        assert tf.seg is None
    else:
        jf = jt.tridiag_ldl_blocked(jnp.asarray(d), jnp.asarray(e), block=128)
        tf = tt.tridiag_ldl_blocked(torch.as_tensor(d), torch.as_tensor(e),
                                    block=128)
        assert tf.seg == 128
    np.testing.assert_allclose(tf.dp.numpy(), np.asarray(jf.dp), rtol=1e-10)
    np.testing.assert_allclose(tf.l.numpy(), np.asarray(jf.l), rtol=1e-10,
                               atol=1e-300)


def test_tridiag_plain_solve_matches_pallas_kernel():
    """K1's plain version against the Pallas kernel (interpret mode) in f32
    at rtol/atol 2e-4, the tolerance the JAX package holds its kernel to;
    the wrapper on CPU tensors is the plain version."""
    from mac_tpu.ops.pallas.tridiag_kernel import tridiag_solve_fused

    d, e, rng = _chain_system(1200, 1)
    jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d, jnp.float32),
                                 jnp.asarray(e, jnp.float32))
    B = rng.normal(size=(1200, 3)).astype(np.float32)
    ref = np.asarray(tridiag_solve_fused(jf.dp, jf.l, jnp.asarray(B),
                                         interpret=True))
    dp, l = torch.tensor(np.asarray(jf.dp)), torch.tensor(np.asarray(jf.l))
    got = tridiag_solve_plain(dp, l, torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    before = tridiag_solve.launches
    np.testing.assert_array_equal(
        tridiag_solve(dp, l, torch.as_tensor(B)).numpy(), got)
    assert tridiag_solve.launches == before
    with pytest.raises(ValueError):
        tridiag_solve(dp[:-1], l, torch.as_tensor(B))


@pytest.mark.parametrize("n,q,kind", [(2500, 3, "blocked"),
                                       (2500, 3, "exact"),
                                       (40000, 8, "blocked")])
def test_blocked_plain_solve_matches_pallas_kernel(n, q, kind):
    """K1b's plain version against the segment-decoupled Pallas kernel
    (interpret mode) in f32 at rtol/atol 2e-4: on blocked factors (seg
    1024), and on an exact factor, whose non-zero couplings at the 1024
    boundaries both versions force to 0; the wrapper on CPU tensors is the
    plain version and counts no launch."""
    from mac_tpu.ops.pallas.tridiag_kernel import tridiag_solve_fused_blocked

    d, e, rng = _chain_system(n, 1 if n < 10000 else 7)
    ldl = jt.tridiag_ldl_blocked if kind == "blocked" else jt.tridiag_ldl
    jf = jax.jit(ldl)(jnp.asarray(d, jnp.float32),
                      jnp.asarray(e, jnp.float32))
    if kind == "exact":
        assert np.all(np.asarray(jf.l)[1024::1024] != 0)
    B = rng.normal(size=(n, q)).astype(np.float32)
    ref = np.asarray(tridiag_solve_fused_blocked(
        jf.dp.astype(jnp.float32), jf.l.astype(jnp.float32), jnp.asarray(B),
        block=1024, interpret=True))
    dp, l = torch.tensor(np.asarray(jf.dp)), torch.tensor(np.asarray(jf.l))
    got = tridiag_solve_blocked_plain(dp, l, torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    before = tridiag_solve_blocked.launches
    np.testing.assert_array_equal(
        tridiag_solve_blocked(dp, l, torch.as_tensor(B)).numpy(), got)
    assert tridiag_solve_blocked.launches == before


def test_tridiag_dispatch_refuses_unported_blocked_kernel(monkeypatch):
    """No blocked factor is refused any more, now that K1b is ported (a
    float64 block takes the same kernels' float64 instantiations, which
    tests/test_torch_banded_f64.py and tests/test_torch_cuda.py check).
    The dispatch rule of the JAX package: past 32768
    rows a factor decoupled at segments dividing 1024 (seg 1024 or 128)
    goes to K1b, and an exact factor to K1 (the TPU's 32768 cap was its
    VMEM budget; K1 has none), so no plain scan runs on this path; up to
    32768 rows every factor goes to K1; blocks wider than 32 columns go to
    the same kernels (the 32-column cap was the TPU's too). On CPU tensors
    each wrapper is its plain version, which agrees with the plain
    whole-row scans."""
    calls = []
    for name in ("tridiag_solve", "tridiag_solve_blocked"):
        real = getattr(tt._kernels, name)
        monkeypatch.setattr(
            tt._kernels, name, lambda *a, _f=real, _n=name, **k: (
                calls.append(_n), _f(*a, **k))[1])
    n = 33000
    d, e, rng = _chain_system(n, 2)
    d32 = torch.as_tensor(d, dtype=torch.float32)
    e32 = torch.as_tensor(e, dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(n, 40)), dtype=torch.float32)
    cases = [(tt.tridiag_ldl_blocked(d32, e32, block=1024), n, 2,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl_blocked(d32, e32, block=128), n, 2,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl(d32, e32), n, 2, "tridiag_solve"),
             (tt.tridiag_ldl_blocked(d32[:3000], e32[:2999], block=1024),
              3000, 2, "tridiag_solve"),
             (tt.tridiag_ldl_blocked(d32, e32, block=1024), n, 40,
              "tridiag_solve_blocked"),
             (tt.tridiag_ldl(d32[:3000], e32[:2999]), 3000, 40,
              "tridiag_solve")]
    for f, rows, q, want in cases:
        calls.clear()
        got = tt.tridiag_solve_factored_fast(f, B[:rows, :q])
        assert calls == [want], (f.seg, rows, calls)
        ref = tt.tridiag_solve_factored(f, B[:rows, :q])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("q", [1, 5])
def test_blocked_plain_solve_matches_pallas_kernel_at_short_blocks(block, q):
    """K1b's plain version against the segment-decoupled Pallas kernel
    (interpret mode) in f32 at rtol/atol 2e-4 with the segment length passed
    explicitly (128 and 256) on a ragged n = 1500 at one and five
    right-hand sides. The factor is exact, so both versions have to cut its
    non-zero couplings at the `block` boundaries themselves."""
    from mac_tpu.ops.pallas.tridiag_kernel import tridiag_solve_fused_blocked

    n = 1500
    d, e, rng = _chain_system(n, 11)
    jf = jax.jit(jt.tridiag_ldl)(jnp.asarray(d, jnp.float32),
                                 jnp.asarray(e, jnp.float32))
    assert np.all(np.asarray(jf.l)[block::block] != 0)
    B = rng.normal(size=(n, q)).astype(np.float32)
    ref = np.asarray(tridiag_solve_fused_blocked(
        jf.dp, jf.l, jnp.asarray(B), block=block, interpret=True))
    dp, l = torch.tensor(np.asarray(jf.dp)), torch.tensor(np.asarray(jf.l))
    got = tridiag_solve_blocked_plain(dp, l, torch.as_tensor(B),
                                      block=block).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    before = tridiag_solve_blocked.launches
    np.testing.assert_array_equal(
        tridiag_solve_blocked(dp, l, torch.as_tensor(B), block=block).numpy(),
        got)
    assert tridiag_solve_blocked.launches == before


class _StubLibrary:
    """Stands in for a ctypes.CDLL: each exported function is an object
    that takes argtypes and restype, records its calls and returns the
    library's `result` as its cudaError_t."""

    class _Function:
        def __init__(self, lib, name):
            self.lib, self.name, self.calls = lib, name, []

        def __call__(self, *args):
            self.calls.append(args)
            return self.lib.result

    def __init__(self, path):
        self.path = path
        self.result = 0
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._fns.setdefault(name, self._Function(self, name))


@pytest.mark.parametrize("name,fn", [
    ("tridiag", "tridiag_solve_f32"),
    ("tridiag", "tridiag_solve_blocked_f32"),
    ("assemble", "assemble_ut_f32")])
def test_kept_function_handle_follows_a_loaded_library(monkeypatch, name, fn):
    """The wrappers resolve their C function once (_build.function) and
    keep it; _build.load(name, signatures, path) makes another library the
    one they call from then on, for that source only."""
    from mac_tpu_torch.ops.kernels import _build, assemble
    from mac_tpu_torch.ops.kernels import tridiag as ktridiag

    sigs = {"tridiag": ktridiag._SIGNATURES,
            "assemble": assemble._SIGNATURES}[name]
    other = "assemble" if name == "tridiag" else "tridiag"
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", _StubLibrary)
    monkeypatch.setattr(_build, "build", lambda nm: f"built/{nm}")

    first = _build.function(name, fn, sigs)
    assert first.lib.path == f"built/{name}" and first.name == fn
    assert first.argtypes == sigs[fn] and first.restype is _build.ctypes.c_int
    assert _build.function(name, fn, sigs) is first  # kept, not resolved anew
    kept_other = _build.function(other, "some_function", {})

    lib_a = _build.load(name, sigs, "elsewhere/a.so")
    swapped = _build.function(name, fn, sigs)
    assert swapped is not first and swapped.lib is lib_a
    assert lib_a.path == "elsewhere/a.so"
    assert _build.function(name, fn, sigs) is swapped
    assert _build.function(other, "some_function", {}) is kept_other
    _build.load(name, sigs, "built/" + name)
    assert _build.function(name, fn, sigs).lib.path == f"built/{name}"
    assert _build.load(name, sigs) is _build.function(name, fn, sigs).lib


def test_launch_calls_the_kept_function_with_the_kernel_arguments(monkeypatch):
    """_launch marshals (dp, l, B, X, n, q, lanes, factor lane stride,
    extra..., stream) to the function
    _build.function returns, on the current stream of B's device, and raises
    on a non-zero cudaError_t; no device is needed for that."""
    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import tridiag as ktridiag

    lib = _StubLibrary("stub")
    monkeypatch.setattr(_build, "function",
                        lambda name, fn, sigs: getattr(lib, fn))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda: type("Stream", (), {"cuda_stream": 77})())
    dp, l, B = torch.ones(6), torch.zeros(6), torch.ones(6, 2)
    X = ktridiag._launch("tridiag_solve_blocked_f32", dp, l, B, 32)
    (args,) = lib.tridiag_solve_blocked_f32.calls
    assert args == (dp.data_ptr(), l.data_ptr(), B.data_ptr(), X.data_ptr(),
                    6, 2, 1, 0, 32, 77)
    assert X.shape == B.shape and X.data_ptr() != B.data_ptr()
    ktridiag._launch("tridiag_solve_f32", dp, l, B)
    assert len(lib.tridiag_solve_f32.calls[0]) == 9
    # Lanes: B (R, n, q) with a factor per lane (lane stride n) or shared
    # (lane stride 0).
    B3 = torch.ones(3, 6, 2)
    ktridiag._launch("tridiag_solve_f32", dp.expand(3, 6).contiguous(),
                     l.expand(3, 6).contiguous(), B3)
    assert lib.tridiag_solve_f32.calls[1][4:8] == (6, 2, 3, 6)
    ktridiag._launch("tridiag_solve_f32", dp, l, B3)
    assert lib.tridiag_solve_f32.calls[2][4:8] == (6, 2, 3, 0)
    lib.result = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        ktridiag._launch("tridiag_solve_f32", dp, l, B)


@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize("n,q", [(1, 1), (300, 5), (2500, 4)])
def test_lane_plain_solves_equal_a_loop_of_single_solves(n, q, shared):
    """The lane forms of K1's and K1b's plain versions (B (R, n, q), a
    factor per lane (R, n) or one shared (n,)) equal a loop of single-lane
    calls, bitwise; so do the factorisations of R lanes (tridiag_ldl,
    tridiag_ldl_blocked)."""
    R = 3
    systems = [_chain_system(max(n, 2), 50 + r) for r in range(R)]
    d = torch.tensor(np.stack([s[0][:n] for s in systems]))
    e = torch.tensor(np.stack([s[1][:n - 1] for s in systems]))
    B = torch.tensor(systems[0][2].normal(size=(R, n, q)))
    for factor, solve, kw in (
            (tt.tridiag_ldl, tridiag_solve_plain, {}),
            (lambda d_, e_: tt.tridiag_ldl_blocked(d_, e_, block=128),
             tridiag_solve_blocked_plain, dict(block=128))):
        lanes = factor(d, e)
        singles = [factor(d[r], e[r]) for r in range(R)]
        assert torch.equal(lanes.dp, torch.stack([f.dp for f in singles]))
        assert torch.equal(lanes.l, torch.stack([f.l for f in singles]))
        dp, l = ((lanes.dp[0], lanes.l[0]) if shared
                 else (lanes.dp, lanes.l))
        got = solve(dp, l, B, **kw)
        loop = torch.stack([solve(dp if shared else dp[r],
                                  l if shared else l[r], B[r], **kw)
                            for r in range(R)])
        assert got.shape == B.shape and torch.equal(got, loop)
        # The dispatching wrappers take the same lanes on the CPU.
        wrapper = tridiag_solve if not kw else tridiag_solve_blocked
        assert torch.equal(wrapper(dp, l, B, **kw), got)


def test_lane_solves_refuse_mismatched_factors():
    dp, l = torch.ones(3, 10), torch.zeros(3, 10)
    for bad_dp, bad_l, B in ((dp, l, torch.ones(10, 2)),
                             (dp, l, torch.ones(2, 10, 2)),
                             (dp, l[:, :9], torch.ones(3, 10, 2)),
                             (dp[:, :9], l[:, :9], torch.ones(3, 10, 2))):
        with pytest.raises(ValueError, match="want dp, l"):
            tridiag_solve(bad_dp, bad_l, B)
        with pytest.raises(ValueError, match="want dp, l"):
            tridiag_solve_blocked(bad_dp, bad_l, B)

"""Parity of the chain LDL^T factorisation of the PyTorch port (kernels K3
and K3b, run here as their plain versions) against the JAX package's
tridiag_ldl and tridiag_ldl_blocked, on the CPU; the dispatch of
tridiag_ldl_auto; the wrappers' checks; and, with a card standing in for
the kernels, that every caller on the solvers' routes hands the kernels
what they take. Inputs are made from seeds with numpy and handed to both
packages as arrays."""

import math
import struct
from fractions import Fraction

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


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once, as the card's fma: the exact value in
    rationals, rounded to the nearest double by float() (math.fma exists
    from Python 3.13 on; this is exact for finite operands and a result in
    the normal range, which the cases below keep to)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _renorm(vals, always=False):
    """ldl.cu's renorm: scale by the power of two that brings the largest
    magnitude into [1, 2) once it leaves [2^-64, 2^64] (always with
    always=True); exact."""
    m = max(abs(v) for v in vals)
    if (always or m > 2.0 ** 64 or m < 2.0 ** -64) and 0 < m < math.inf:
        k = 1 - math.frexp(m)[1]
        return [math.ldexp(v, k) for v in vals]
    return vals


def _out_of_range(vals):
    """ldl.cu's out_of_range, on the exponent fields: an entry at or past
    2^64 (or not finite), or every entry below 2^-64 and one of them
    normal."""
    ex = max((struct.unpack("<q", struct.pack("<d", v))[0] >> 52) & 0x7ff
             for v in vals)
    return ex >= 1023 + 64 or 0 < ex < 1023 - 64


def _max_nan(a, b):
    """ldl.cu's max_nan: NaN wins, else the larger (a when equal)."""
    if a != a or b != b:
        return a if a != a else b
    return b if a < b else a


def k3_model(d, e):
    """K3's float64 arithmetic in the kernel's order (csrc/ldl.cu), on the
    host: the chain scaled by 2^-k, 2^k <= max(d) < 2^(k+1) (chain_scale),
    the chunking (up to 1024 chunks of at least 16 rows), step 1's
    composed maps with their fma placement (compose_row), step 2's serial
    carry of the minors' vector (carry), step 3's recurrence (recur_row)
    and its two divisions a row, the pivots scaled back by 2^k and
    floored; each renormalisation where the kernel makes it: a row's (a
    group of 8 chunks') range test acted on a row (a chunk) later, every
    chunk's map normalised at its end, the carry's last partial group left
    as it is. (dp, l) as float64 arrays. The register and the staged forms
    of the kernel share this arithmetic."""
    d = [float(x) for x in d]
    e = [float(x) for x in e] + [0.0]
    n = len(d)
    mx = max(d)
    k = (min(max(math.frexp(mx)[1] - 1, -1022), 1022)
         if 0 < mx < math.inf else 0)
    down, up = 2.0 ** -k, 2.0 ** k
    nchunk = min(1024, (n - 1) // 16 + 1)
    chunk = (n - 1) // nchunk + 1
    nseg = (n - 1) // chunk + 1
    bounds = [(s * chunk, min(s * chunk + chunk, n)) for s in range(nseg)]
    maps = []
    for i0, i1 in bounds:  # 1.
        q, pending = [1.0, 0.0, 0.0, 1.0], False
        e_prev = e[i0 - 1] * down if i0 > 0 else 0.0
        for i in range(i0, i1):
            e2 = 0.0 if i == 0 else e_prev * e_prev
            x = d[i] * down
            q = [_fma(x, q[0], -(e2 * q[2])), _fma(x, q[1], -(e2 * q[3])),
                 q[0], q[1]]
            if pending:
                q = _renorm(q, True)
            pending = _out_of_range(q)
            e_prev = e[i] * down
        maps.append(_renorm(q, True))
    v0, v1, vin, pending = 1.0, 0.0, [], False  # 2.
    whole = nseg - nseg % 8
    for k, (qa, qb, qc, qd) in enumerate(maps):
        vin.append((v0, v1))
        v0, v1 = _fma(qa, v0, qb * v1), _fma(qc, v0, qd * v1)
        if k < whole and k % 8 == 0 and pending:
            v0, v1 = _renorm([v0, v1], True)
        if k < whole and k % 8 == 7:
            pending = _out_of_range([v0, v1])
    floor = 8 * np.finfo(np.float64).eps * max(d)
    dp, l = np.empty(n), np.zeros(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        for (i0, i1), (v0, v1) in zip(bounds, vin):  # 3.
            e_prev = e[i0 - 1] * down if i0 > 0 else 0.0
            pending = False
            for i in range(i0, i1):
                e2 = 0.0 if i == 0 else e_prev * e_prev
                v = _fma(d[i] * down, v0, -(e2 * v1))
                f = _max_nan(float(np.float64(v) / np.float64(v0)) * up,
                             floor)
                v0, v1 = v, v0
                if pending:
                    v0, v1 = _renorm([v0, v1], True)
                pending = _out_of_range([v0, v1])
                dp[i] = f
                if i + 1 < n:
                    l[i + 1] = float(np.float64(e[i]) / np.float64(f))
                e_prev = e[i] * down
    return dp, l


def _sphere2500_chain():
    """The chain that banded.chain_factor hands the exact factor on
    sphere2500 at its start weights (data/sphere2500.g2o, K = 50%,
    NaiveGreedy), as phase 3d of chip_smoke.py takes it, in float64."""
    from chip_smoke import captured_args, dataset_inputs
    from mac_tpu_torch.ops import banded

    bop, w = dataset_inputs(torch.device("cpu"), "sphere2500")[6:8]
    d, e = captured_args(banded, "tridiag_ldl_auto", lambda: banded.
                         chain_factor(bop, banded.assemble_bd(bop, w), w))
    return d.double().numpy(), e.double().numpy()


def _floor_chain(n):
    """A weighted path's Laplacian: pivots w_0, w_1, ..., and a last one of
    0 up to rounding, which falls to the floor."""
    w = 0.5 + np.random.RandomState(n).rand(n - 1)
    z = np.zeros(1)
    return np.concatenate([w, z]) + np.concatenate([z, w]), -w


@pytest.mark.parametrize("case", ["sphere2500", "random 17", "random 1000",
                                  "random 4096", "random 4097",
                                  "floor 1000", "2^400 1000", "2^-400 1000"])
def test_k3_order_within_the_referee(case):
    """K3's arithmetic in its order (k3_model) within F64_FACTOR_RTOL
    relative of the extended-precision referee (chip_smoke.pivot_referee,
    the card's gate), dp and l, on sphere2500's chain, random chains of 17,
    1000, 4096 (the largest that K3 keeps in registers) and 4097 rows, a
    chain whose last pivot falls to the floor, and a random chain scaled
    by 2^400 and by 2^-400 (unscaled, its first row's map would hold e^2
    near 2^+-800, and the row that the lagged range test lets pass would
    leave the range). On the scaled chains the model gives the unscaled
    chain's dp times the same power of two and its l, bit for bit."""
    from chip_smoke import F64_FACTOR_RTOL, pivot_referee

    kind, _, rows = case.partition(" ")
    if kind == "sphere2500":
        d, e = _sphere2500_chain()
    elif kind == "random":
        d, e = _chain(int(rows), int(rows))
    elif kind == "floor":
        d, e = _floor_chain(int(rows))
    else:
        d, e = (np.ldexp(a, int(kind[2:])) for a in _chain(int(rows), 7))
    dp, l = k3_model(d, e)
    ref_dp, ref_l = pivot_referee(torch.as_tensor(d), torch.as_tensor(e))
    for got, ref in ((dp, ref_dp[0]), (l, ref_l[0])):
        rel = np.abs(got.astype(np.longdouble) - ref) / np.maximum(
            np.abs(ref), 1e-300)
        assert float(rel.max()) <= F64_FACTOR_RTOL, (case, float(rel.max()))
    if kind == "floor":
        assert dp[-1] == 8 * np.finfo(np.float64).eps * d.max()
        assert ref_dp[0, -1] == dp[-1]
    if kind.startswith("2^"):
        dp1, l1 = k3_model(*_chain(int(rows), 7))
        assert np.array_equal(dp, np.ldexp(dp1, int(kind[2:])))
        assert np.array_equal(l, l1)


def _ldl_ptxas_report(spill):
    """A ptxas -v report of ldl.cu's kernels as nvcc prints it for the
    card (the anonymous namespace's mangled prefix included): K3's
    ldl_kernel<T, rows, stamped> at rows 16 and 0, K3b's
    ldl_blocked_kernel<T, stamped>, both types, stamped and not, the
    instance `spill` ((kernel, type letter, rows)) with a spilling frame."""
    prefix = "_ZN38_GLOBAL__N__59dd69ad_6_ldl_cu_3341ebb2"
    names = {}
    for t in "fd":
        for c in "01":
            for rows in (16, 0):
                names[("K3", t, rows, c)] = (
                    f"{prefix}10ldl_kernelI{t}Li{rows}ELb{c}EEEvPKT_S3_PS1_S4"
                    f"_ixxPx")
            names[("K3b", t, None, c)] = (
                f"{prefix}18ldl_blocked_kernelI{t}Lb{c}EEEvPKT_S3_PS1_S4_iixx"
                f"iPx")
    out = []
    for key, name in names.items():
        bad = key[:3] == spill
        out += [f"ptxas info    : Compiling entry function '{name}' for "
                f"'sm_90a'",
                f"ptxas info    : Function properties for {name}",
                f"    {48 if bad else 0} bytes stack frame, "
                f"{44 if bad else 0} bytes spill stores, "
                f"{44 if bad else 0} bytes spill loads",
                "ptxas info    : Used 128 registers, used 1 barriers"]
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("spill,fails", [
    (None, False), (("K3", "d", 0), False), (("K3", "d", 16), True),
    (("K3b", "f", None), True)])
def test_ldl_frame_gate(spill, fails):
    """chip_smoke.py's phase-2 gate on ldl.cu: K3's 16-row instantiations
    and K3b's, which keep rows in registers, must have no stack frame and
    no spill, in both types; K3's staged instantiation is not gated; the
    stamped builds are left out of the table."""
    import chip_smoke

    log = _ldl_ptxas_report(spill)
    if fails:
        with pytest.raises(SystemExit):
            chip_smoke.ldl_frame_gate(log)
        return
    regs = chip_smoke.ldl_frame_gate(log)
    assert sorted(regs, key=str) == sorted(
        [("K3", t, r) for t in ("float32", "float64") for r in (16, 0)]
        + [("K3b", t, None) for t in ("float32", "float64")], key=str)
    assert regs[("K3", "float64", 0)][1:] == (
        (48, 44, 44) if spill else (0, 0, 0))


@pytest.mark.parametrize("entry", ["phases", "step_probe"])
def test_measuring_entry_points_want_the_card(entry):
    """ldl.phases (the stamped build) and ldl.step_probe (the chain probe)
    measure the card: on CPU tensors they raise, and count no launch."""
    before = _counts()
    d, e = (torch.as_tensor(a) for a in _chain(100, 5))
    out = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "phases":
            ldl.phases(d, e, 32)
        else:
            ldl.step_probe(torch.float64, 128, 0, out)
    assert _counts() == before

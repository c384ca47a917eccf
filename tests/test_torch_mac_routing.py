"""The automatic routing of mac_tpu_torch.MAC on the CPU: the size gate and
the tiny-gap escalation with their auto_dtype_reason, the explicit knobs
that bypass them, the bundled datasets' routes, the disconnected graph that
stays on the device engine and solves to lambda_2 = 0, and the routes that
still raise."""

from pathlib import Path

import numpy as np
import pytest
import torch

from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                           split_edges)
from mac_tpu_torch.solvers import MAC, mac as tmac
from mac_tpu_torch.utils.graphs import Edge
from tests.test_torch_banded import GRAPHS, pose_graph
from tests.test_torch_mac_host import tiny_gap_chain

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data"


def small_banded_problem():
    """nosplit700: 700 nodes, a narrow band, a gap float32 resolves."""
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    return (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:]), n


def test_small_instance_routes_to_the_host_engine():
    """n <= SMALL_HOST_N with a gap float32 resolves: float64, the host
    engine, the small-instance reason; the probe's ratio is kept."""
    fixed, cands, n = small_banded_problem()
    mac = MAC(fixed, cands, n, device="cpu")
    assert n <= tmac.SMALL_HOST_N
    assert mac.dtype == torch.float64 and mac.fiedler_backend == "host"
    assert mac._small_host and not mac._tiny_gap
    assert "small instance" in mac.auto_dtype_reason
    assert mac.spectral_ratio >= tmac.F32_SPECTRAL_RATIO_MIN
    assert mac._banded is None and not mac.fw_polish and not mac.round_guard
    k = len(cands[1]) // 2
    rounded, _, _ = mac.solve(k)
    assert rounded.sum() == k and mac.last_solve_stats["backend"] == "host"


def test_tiny_gap_escalates_above_the_size_gate():
    """n = 2400 > SMALL_HOST_N with lambda_2 / ||L||_inf below float32
    resolution: escalated to float64 by the probe, the host engine, the
    chain-solve preconditioner for the device engine's evaluations."""
    fixed, cands, n = tiny_gap_chain(2400, 200, 2)
    mac = MAC(fixed, cands, n, device="cpu")
    assert mac.dtype == torch.float64 and mac.fiedler_backend == "host"
    assert mac._tiny_gap and not mac._small_host
    assert "below float32 resolution" in mac.auto_dtype_reason
    assert mac.spectral_ratio < tmac.F32_SPECTRAL_RATIO_MIN
    assert mac.fiedler_precond == "tridiag"


@pytest.mark.parametrize("kwargs,want", [
    (dict(dtype=torch.float32), (torch.float32, "device", True)),
    (dict(dtype=torch.float64), (torch.float64, "device", False)),
    (dict(use_banded=True), (torch.float32, "device", True)),
    (dict(use_banded=False), (torch.float32, "device", False)),
    (dict(fiedler_backend="device"), (torch.float32, "device", True)),
    (dict(fiedler_backend="host"), (torch.float32, "host", True)),
    (dict(dtype=torch.float64, fiedler_backend="host"),
     (torch.float64, "host", False)),
])
def test_explicit_knobs_bypass_the_size_gate(kwargs, want):
    """An explicit dtype, use_banded or fiedler_backend each bypasses the
    small-instance rule (an explicit dtype also skips the probe): the knobs
    win, and no reason is recorded."""
    fixed, cands, n = small_banded_problem()
    mac = MAC(fixed, cands, n, device="cpu", **kwargs)
    assert (mac.dtype, mac.fiedler_backend, mac._banded is not None) == want
    assert mac.auto_dtype_reason is None and not mac._small_host
    assert (mac.spectral_ratio is None) == ("dtype" in kwargs)
    # The tails resolve True exactly on the small banded float32 route.
    assert mac.fw_polish == mac.round_guard == want[2]


@pytest.mark.parametrize("dataset,dtype,backend,banded,reason", [
    ("intel", torch.float64, "host", False, "small instance"),
    ("kitti_05", torch.float64, "host", False, "below float32"),
    ("kitti_02", torch.float64, "host", False, "below float32"),
    ("ais2klinik", torch.float64, "host", False, "below float32"),
    ("sphere2500", torch.float32, "device", True, None),
    ("city10000", torch.float32, "device", True, None),
])
def test_bundled_datasets_construct_on_the_reference_route(
        dataset, dtype, backend, banded, reason):
    """None of the six bundled datasets raises at construction, and each
    takes the reference's route; sphere2500 alone gets the exact tails."""
    meas, n = read_g2o_file(str(DATA / f"{dataset}.g2o"))
    fixed, cands = split_edges(rpm_to_mac(meas))
    mac = MAC(fixed, cands, n, device="cpu")
    assert (mac.dtype, mac.fiedler_backend) == (dtype, backend)
    assert (mac._banded is not None) == banded
    if reason is None:
        assert mac.auto_dtype_reason is None
    else:
        assert reason in mac.auto_dtype_reason
    assert mac.fw_polish == mac.round_guard == (dataset == "sphere2500")


def disconnected_problem():
    """Two chains of 600 nodes and three candidates, none joining them (the
    graph of the JAX package's
    test_disconnected_graph_stays_on_device_engine)."""
    n, half = 1200, 600
    fixed = [Edge(i, i + 1, 1.0) for i in range(half - 1)] + \
            [Edge(i, i + 1, 1.0) for i in range(half, n - 1)]
    cands = [Edge(0, 5, 1.0), Edge(half, half + 9, 1.0), Edge(2, 30, 1.0)]
    return fixed, cands, n


def test_disconnected_graph_stays_on_device_engine():
    """A graph disconnected even with every candidate probes at a noise
    ratio and escalates to float64, but must not reach the host engine
    (singular grounded system): it stays on the device engine in float64
    and solves to the analytic lambda_2 = 0 (|lambda_2| < 1e-8), with a
    finite bound, both with the two-grid and with the chain-solve
    preconditioner."""
    fixed, cands, n = disconnected_problem()
    mac = MAC(fixed, cands, n, device="cpu")
    assert mac.fiedler_backend == "device" and mac.dtype == torch.float64
    assert mac._tiny_gap and mac.op.mode == "ell"
    rounded, unrounded, upper = mac.solve(2)
    assert rounded.sum() == 2 and np.isfinite(upper)
    obj = mac.evaluate_objective(unrounded)
    assert np.isfinite(obj) and abs(obj) < 1e-8
    assert obj <= upper + 1e-12
    tri = MAC(fixed, cands, n, device="cpu", fiedler_precond="tridiag")
    assert abs(tri.evaluate_objective(unrounded)) < 1e-8


def test_singular_coarse_level_is_regularised():
    """The two-grid coarse operator of that graph has one null vector per
    component, which the constant shift does not lift (its aggregates do
    not straddle the cut): the preconditioner regularises it and stays
    finite, where the plain Cholesky factor is singular."""
    from mac_tpu_torch.ops.lobpcg import cholesky_upper
    from mac_tpu_torch.ops.laplacian import build_operator, lap_applier
    from mac_tpu_torch.ops.twogrid import (coarse_laplacian,
                                           make_twogrid_precond)

    fixed, cands, n = disconnected_problem()
    idx = np.array([[e.i, e.j] for e in fixed + cands])
    op = build_operator(idx, n)
    w = torch.ones(len(idx), dtype=torch.float64)
    Lc = coarse_laplacian(op, w)
    nc = op.coarse_nc
    piv = torch.diagonal(cholesky_upper(
        Lc + ((2.0 * torch.diagonal(Lc).max() + 1.0) / nc)
        * torch.ones_like(Lc)))
    assert not bool(piv.min() > 1e-7 * piv.max())
    Minv = make_twogrid_precond(op, w, lap_applier(op, w))
    B = torch.randn((n, 4), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    out = Minv(B)
    assert bool(torch.isfinite(out).all())
    assert float(out.abs().max()) < 1e6 * float(B.abs().max())


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "mesh"),
    (dict(use_banded=True, dtype=torch.float64), "float32 route"),
    (dict(use_banded=True, dtype=torch.float32, fiedler_method="lobpcg"),
     "LOBPCG"),
])
def test_routes_that_still_raise(kwargs, match):
    """A mesh that is no torch.distributed DeviceMesh is a TypeError
    (meshes are ported). The two routes that raised NotImplementedError
    until the port had them now resolve: use_banded=True in float64 builds
    the banded operator under the reference's non-fast32 knobs with
    fw_polish and round_guard False; LOBPCG on the banded float32 operator
    keeps the fast32 policy and its host tails."""
    fixed, cands, n = small_banded_problem()
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match=match):
            MAC(fixed, cands, n, device="cpu", **kwargs)
        return
    mac = MAC(fixed, cands, n, device="cpu", **kwargs)
    assert mac.dtype == kwargs["dtype"] and mac.fiedler_backend == "device"
    assert mac._banded is not None and mac.op is None
    fast32 = kwargs["dtype"] == torch.float32
    assert mac._fast32 == fast32
    assert mac.fw_polish == mac.round_guard == fast32
    assert mac.fiedler_method == kwargs.get("fiedler_method", "tracemin")
    assert (mac.fiedler_tol, mac.fiedler_maxiter, mac.fiedler_inner_iters,
            mac.fiedler_rel_tol) == ((6e-4, 50, 10, 3e-2) if fast32
                                     else (1e-8, 200, 16, None))


def test_bad_knobs_raise():
    fixed, cands, n = small_banded_problem()
    with pytest.raises(ValueError, match="fiedler_backend"):
        MAC(fixed, cands, n, device="cpu", fiedler_backend="tpu")
    with pytest.raises(ValueError, match="dtype"):
        MAC(fixed, cands, n, device="cpu", dtype=torch.float16)

"""The PyTorch port's SLAM harness against the JAX package's on the CPU:
each of the 12 trajectory-metric functions (mac_tpu_torch.slam.metrics) and
the 7 SE-Sync evaluation functions (mac_tpu_torch.slam.sesync_eval) on
seeded SE(2) and SE(3) inputs, to 1e-12; the package's exported names; and
the three examples of mac_tpu_torch.examples, on the CPU."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mac_tpu.slam as jslam
from mac_tpu.slam import metrics as jm
from mac_tpu.slam import sesync_eval as je
from mac_tpu.slam.pose_graph import rot2D_from_theta
import mac_tpu_torch.slam as tslam
from mac_tpu_torch.slam import metrics as tm
from mac_tpu_torch.slam import sesync_eval as te
from mac_tpu_torch.slam.pose_graph import RelativePoseMeasurement
from tests.slam.test_pose_graph import _poses_matrix
from tests.slam.test_sesync_eval import _random_measurements

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-12


def _rotation(d, rng):
    if d == 2:
        return rot2D_from_theta(rng.uniform(-np.pi, np.pi))
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return Q * np.sign(np.linalg.det(Q))


def _variable_matrix(d, n, seed):
    """A seeded SE-Sync variable matrix [t_1 .. t_n | R_1 .. R_n]."""
    rng = np.random.RandomState(seed)
    return _poses_matrix(rng.randn(d, n),
                         [_rotation(d, rng) for _ in range(n)])


def _se2_poses(n, seed):
    rng = np.random.RandomState(seed)
    out = np.tile(np.eye(3), (n, 1, 1))
    for k in range(n):
        out[k, :2, :2] = rot2D_from_theta(rng.uniform(-np.pi, np.pi))
        out[k, :2, 2] = rng.randn(2)
    return out


def _close(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=ATOL)


# (function name, argument builder of d): each builder returns the
# positional arguments, made from seeds with numpy.
_METRICS = {
    "translations_from_variable_matrix": lambda d: (_variable_matrix(d, 9, 1),),
    "rotations_from_variable_matrix": lambda d: (_variable_matrix(d, 9, 2),),
    "normalize_poses": lambda d: (_variable_matrix(d, 9, 3),),
    "umeyama_alignment": lambda d: (np.random.RandomState(4).randn(d, 20),
                                    np.random.RandomState(5).randn(d, 20)),
    "ate_tran": lambda d: (_variable_matrix(d, 12, 6),
                           _variable_matrix(d, 12, 7)),
    "rpe_rot": lambda d: (_variable_matrix(d, 12, 8),
                          _variable_matrix(d, 12, 9)),
    "poses_ate_tran": lambda d: (_variable_matrix(d, 10, 10),
                                 _variable_matrix(d, 10, 11)),
    "poses_rpe_rot": lambda d: (_variable_matrix(d, 10, 12),
                                _variable_matrix(d, 10, 13)),
    "poses_to_se3_matrices": lambda d: (_variable_matrix(d, 7, 14),),
    # The SE(2)-only helpers take SE(2) pose matrices whatever d is.
    "se2poses_to_x": lambda d: (_se2_poses(8, 15 + d),),
    "Rt_from_pose": lambda d: (_se2_poses(1, 17 + d)[0],),
    "se2_to_se3": lambda d: (_se2_poses(1, 19 + d)[0],),
}


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", sorted(_METRICS))
def test_metric_matches_jax(name, d):
    args = _METRICS[name](d)
    _close(getattr(tm, name)(*args), getattr(jm, name)(*args))


def _measurements(d, seed):
    """The JAX package's seeded fixture, and the same measurements as the
    port's RelativePoseMeasurement."""
    meas, n = _random_measurements(d=d, seed=seed)
    return meas, [RelativePoseMeasurement(*m) for m in meas], n


def _sesync_case(name, d):
    """(JAX arguments, port arguments) of one sesync_eval function."""
    jmeas, tmeas, n = _measurements(d, 30 + d)
    rng = np.random.RandomState(40 + d)
    if name == "orbit_distance_dS":
        X = np.concatenate([_rotation(d, rng) for _ in range(n)], axis=1)
        Y = np.concatenate([_rotation(d, rng) for _ in range(n)], axis=1)
        return (X, Y, True), (X, Y, True)
    if name in ("_meas_arrays", "construct_LGrho",
                "construct_sesync_quadratic_form_matrix"):
        return (jmeas,), (tmeas,)
    if name == "evaluate_sesync_rotation_objective":
        R = rng.normal(size=(d, d * n))
        return (je.construct_LGrho(jmeas), R), (te.construct_LGrho(tmeas), R)
    if name == "evaluate_sesync_objective":
        X = rng.normal(size=(d, (d + 1) * n))
        return ((je.construct_sesync_quadratic_form_matrix(jmeas), X),
                (te.construct_sesync_quadratic_form_matrix(tmeas), X))
    w = (rng.rand(len(jmeas)) > 0.5).astype(float)
    return (jmeas, w), (tmeas, w)


_SESYNC = ["orbit_distance_dS", "_meas_arrays", "construct_LGrho",
           "evaluate_sesync_rotation_objective",
           "construct_sesync_quadratic_form_matrix",
           "evaluate_sesync_objective", "select_measurements"]


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", _SESYNC)
def test_sesync_eval_matches_jax(name, d):
    jargs, targs = _sesync_case(name, d)
    ref = getattr(je, name)(*jargs)
    got = getattr(te, name)(*targs)
    if name.startswith("construct"):
        assert got.format == ref.format == "csr"
        assert got.shape == ref.shape
        got, ref = got.toarray(), ref.toarray()
    elif name == "select_measurements":
        assert [tuple(m[:2]) for m in got] == [tuple(m[:2]) for m in ref]
        assert all(isinstance(m, RelativePoseMeasurement) for m in got)
        return
    _close(got, ref)


def test_slam_package_exports_the_jax_names():
    assert sorted(tslam.__all__) == sorted(jslam.__all__)
    for name in tslam.__all__:
        assert callable(getattr(tslam, name)) or name == \
            "RelativePoseMeasurement"


def test_g2o_experiment_runs_on_the_cpu(tmp_path):
    """`python -m mac_tpu_torch.examples.g2o_experiment data/intel.g2o
    --budgets 0.5 --cpu` (the host engine) exits 0 and reports one budget;
    run in-process on the same arguments, each selection holds k edges and
    the reported lambda_2 obey rounded <= relaxed <= upper."""
    out = tmp_path / "intel.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mac_tpu_torch.examples.g2o_experiment",
         "data/intel.g2o", "--budgets", "0.5", "--cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PySESync not installed" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["k"] == 392
    from mac_tpu_torch.examples.g2o_experiment import main

    (rec,) = main([str(REPO / "data" / "intel.g2o"), "--budgets", "0.5",
                   "--cpu"])
    k = rec["k"]
    for key in ("mac_selection", "madow_selection", "naive_selection"):
        assert sum(rec[key]) == k, key
    assert rec["lam2_mac_nearest"] <= rec["lam2_unrounded"] * (1 + 1e-9)
    assert rec["lam2_unrounded"] <= rec["dual_upper"] * (1 + 1e-9)


@pytest.mark.parametrize("name", ["petersen_graph_sparsification",
                                  "random_graph_sparsification"])
def test_graph_examples_run_on_the_cpu(name, capsys):
    """The two graph examples in-process with --cpu: every lambda_2 they
    print is finite, and MAC's relaxed one lies within its upper bound."""
    import importlib

    importlib.import_module(f"mac_tpu_torch.examples.{name}").main(["--cpu"])
    text = capsys.readouterr().out
    values = [float(v) for v in re.findall(r"lambda2\S*\s*=\s*(\S+)", text)]
    assert len(values) >= 2 and all(np.isfinite(values))
    if name == "random_graph_sparsification":
        rel = float(text.split("lambda2(relaxed)  =")[1].split()[0])
        upper = float(text.split("dual upper bound  =")[1].split()[0])
        assert rel <= upper * (1 + 1e-9)

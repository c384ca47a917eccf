"""Trajectory quality metrics: Umeyama-aligned ATE and rotation RPE (numpy;
the port's own copy of mac_tpu.slam.metrics, which imports no JAX either).

  * ate_tran: mean translation error after SE(d) Umeyama alignment
    (gauge-invariant, matching evo.metrics.APE(translation_part)).
  * rpe_rot: mean relative rotation error in degrees between consecutive
    pose pairs (matching evo.metrics.RPE(rotation_angle_deg) with unit delta).

Poses are SE-Sync variable matrices: X = [t_1 .. t_n | R_1 .. R_n] of shape
(d, n(d+1)).
"""

from typing import Tuple

import numpy as np


def translations_from_variable_matrix(xhat: np.ndarray) -> np.ndarray:
    d, cols = xhat.shape
    n = cols // (d + 1)
    return xhat[:, :n]


def rotations_from_variable_matrix(xhat: np.ndarray) -> np.ndarray:
    d, cols = xhat.shape
    n = cols // (d + 1)
    return xhat[:, n:(d + 1) * n]


def normalize_poses(xhat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gauge-normalize: rotate by R_1^T and translate t_1 to the origin.
    Returns (t (d, n), R (d, d*n))."""
    t = translations_from_variable_matrix(xhat)
    R = rotations_from_variable_matrix(xhat)
    d = t.shape[0]
    R0 = R[:, :d]
    t = R0.T @ t
    R = R0.T @ R
    t = t - t[:, :1]
    return t, R


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) minimizing ||R src + t - dst||_F^2 (no scale)."""
    mu_s = src.mean(axis=1, keepdims=True)
    mu_d = dst.mean(axis=1, keepdims=True)
    cov = (dst - mu_d) @ (src - mu_s).T / src.shape[1]
    U, S, Vt = np.linalg.svd(cov)
    d = src.shape[0]
    sign = np.sign(np.linalg.det(U @ Vt))
    D = np.eye(d)
    D[-1, -1] = sign
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    return R, t


def ate_tran(estimate: np.ndarray, reference: np.ndarray) -> float:
    """Mean translation ATE after Umeyama alignment of the estimate onto the
    reference (reference semantics: pose_graph_utils.py:470-493)."""
    t_est, _ = normalize_poses(estimate)
    t_ref, _ = normalize_poses(reference)
    R, t = umeyama_alignment(t_est, t_ref)
    aligned = R @ t_est + t
    errs = np.linalg.norm(aligned - t_ref, axis=0)
    return float(errs.mean())


def rpe_rot(estimate: np.ndarray, reference: np.ndarray) -> float:
    """Mean relative rotation error (degrees) over consecutive pose pairs
    (reference semantics: pose_graph_utils.py:495-506)."""
    _, R_est = normalize_poses(estimate)
    _, R_ref = normalize_poses(reference)
    d = R_est.shape[0]
    n = R_est.shape[1] // d
    errs = []
    for i in range(n - 1):
        Re0 = R_est[:, i * d:(i + 1) * d]
        Re1 = R_est[:, (i + 1) * d:(i + 2) * d]
        Rr0 = R_ref[:, i * d:(i + 1) * d]
        Rr1 = R_ref[:, (i + 1) * d:(i + 2) * d]
        dRe = Re0.T @ Re1
        dRr = Rr0.T @ Rr1
        E = dRr.T @ dRe
        cos = (np.trace(E) - (d - 2)) / 2.0
        errs.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return float(np.mean(errs))


def poses_ate_tran(estimate: np.ndarray, reference: np.ndarray) -> float:
    return ate_tran(estimate, reference)


def poses_rpe_rot(estimate: np.ndarray, reference: np.ndarray) -> float:
    return rpe_rot(estimate, reference)


def se2poses_to_x(poses) -> np.ndarray:
    """Pack N SE(2) pose matrices into the SE-Sync variable-matrix layout
    [t_1 .. t_N | R_1 .. R_N] of shape (2, 3N)
    (reference: pose_graph_utils.py:68-87), vectorized."""
    P = np.asarray(poses, dtype=np.float64)  # (N, 3, 3)
    N = P.shape[0]
    X = np.zeros((2, 3 * N))
    X[:, :N] = P[:, :2, 2].T
    X[:, N:] = P[:, :2, :2].transpose(1, 0, 2).reshape(2, 2 * N)
    return X


def Rt_from_pose(pose: np.ndarray):
    """(rotation block, translation block) of one SE(2) pose matrix
    (reference: pose_graph_utils.py:90-103)."""
    pose = np.asarray(pose)
    assert pose.shape == (3, 3)
    X = se2poses_to_x([pose])
    return rotations_from_variable_matrix(X), translations_from_variable_matrix(X)


def se2_to_se3(pose: np.ndarray) -> np.ndarray:
    """Embed an SE(2) pose matrix into SE(3): [R 0 t; 0 0 1 0; 0 0 0 1]
    (reference: pose_graph_utils.py:414-430)."""
    pose = np.asarray(pose, dtype=np.float64)
    R, t = pose[:2, :2], pose[:2, 2]
    out = np.eye(4)
    out[:2, :2] = R
    out[:2, 3] = t
    return out


def poses_to_se3_matrices(xhat: np.ndarray) -> np.ndarray:
    """(N, 4, 4) homogeneous SE(3) matrices from an SE-Sync variable
    matrix (2D poses embedded). Role of the reference's
    `sesync_poses_to_traj` (pose_graph_utils.py:432-468), which builds an
    `evo` PoseTrajectory3D — trajectory metrics here consume the variable
    matrix directly (ate_tran / rpe_rot), so this returns plain arrays."""
    xhat = np.asarray(xhat, dtype=np.float64)
    d = xhat.shape[0]
    n = xhat.shape[1] // (d + 1)
    t = translations_from_variable_matrix(xhat)
    R = rotations_from_variable_matrix(xhat)
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :d, 3] = t.T
    Rs = R.reshape(d, n, d).transpose(1, 0, 2)
    out[:, :d, :d] = Rs
    return out

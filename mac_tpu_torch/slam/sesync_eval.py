"""SE-Sync solution-quality metrics (SO(d) orbit distance, rotation-graph
Laplacian cost, full SE(d)-synchronization quadratic objective); numpy and
scipy, the port's own copy of mac_tpu.slam.sesync_eval.

The metric functions of the reference experiment driver
(examples/g2o_experiment.py of the reference library), assembled as
vectorised COO construction into scipy sparse matrices (linear memory), and
the quadratic forms evaluated without dense products:
tr(X M X^T) = sum (M X^T) * X^T. On ais2klinik (n = 15,115, d = 2) the
dense rotation Laplacian alone would be 7.3 GB; the sparse one is ~2 MB.
Measurements are mac_tpu_torch.slam.pose_graph.RelativePoseMeasurement.
"""

from typing import List

import numpy as np
import scipy.sparse as sp


def orbit_distance_dS(X: np.ndarray, Y: np.ndarray, compute_G_S: bool = False):
    """SO(d) orbit distance between rotation-block matrices X, Y of shape
    (d, d·n): min over G in SO(d) of ||X - G Y||_F, computed in closed form
    from the SVD of X Yᵀ with the determinant-sign correction
    (reference: g2o_experiment.py:23-48)."""
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    d = X.shape[0]
    n = X.shape[1] // d
    u, s, vh = np.linalg.svd(X @ Y.T)
    xi = np.ones(d)
    xi[-1] = np.copysign(1.0, np.linalg.det(u @ vh))
    dS = np.sqrt(abs(2.0 * d * n - 2.0 * float(np.dot(xi, s))))
    if compute_G_S:
        return dS, (u * xi[None, :]) @ vh
    return dS


def _meas_arrays(measurements):
    i = np.asarray([m.i for m in measurements], dtype=np.int64)
    j = np.asarray([m.j for m in measurements], dtype=np.int64)
    kappa = np.asarray([m.kappa for m in measurements], dtype=np.float64)
    tau = np.asarray([m.tau for m in measurements], dtype=np.float64)
    R = np.asarray([m.R for m in measurements], dtype=np.float64)
    t = np.asarray([m.t for m in measurements], dtype=np.float64)
    return i, j, kappa, tau, R, t


def construct_LGrho(measurements) -> sp.csr_matrix:
    """Rotation-graph "connection Laplacian" L(G^rho): (d·n, d·n) sparse,
    with kappa·I_d diagonal blocks and -kappa·R_ij / -kappa·R_ijᵀ coupling
    blocks (reference: g2o_experiment.py:50-91, dense there)."""
    if len(measurements) == 0:
        return sp.csr_matrix((0, 0))
    i, j, kappa, tau, R, t = _meas_arrays(measurements)
    d = R.shape[1]
    n = int(max(i.max(), j.max())) + 1
    m = len(i)

    kd = np.arange(d)
    # Diagonal blocks: kappa at (d*i + k, d*i + k) and (d*j + k, d*j + k).
    rows_d = np.concatenate([(d * i)[:, None] + kd, (d * j)[:, None] + kd], 0).ravel()
    vals_d = np.repeat(np.concatenate([kappa, kappa]), d)
    # Coupling blocks: -kappa R at (d i + r, d j + c); transpose at (j, i).
    rr, cc = np.meshgrid(kd, kd, indexing="ij")
    rows_ij = ((d * i)[:, None, None] + rr).ravel()
    cols_ij = ((d * j)[:, None, None] + cc).ravel()
    vals_ij = (-kappa[:, None, None] * R).ravel()
    L = sp.coo_matrix(
        (
            np.concatenate([vals_d, vals_ij, vals_ij]),
            (
                np.concatenate([rows_d, rows_ij, cols_ij]),
                np.concatenate([rows_d, cols_ij, rows_ij]),
            ),
        ),
        shape=(d * n, d * n),
    )
    return L.tocsr()


def evaluate_sesync_rotation_objective(LGrho, R: np.ndarray) -> float:
    """tr(R L(G^rho) Rᵀ) for a (d, d·n) rotation-block matrix
    (reference: g2o_experiment.py:93-94), sparse-friendly."""
    R = np.asarray(R, dtype=np.float64)
    return float(np.sum(np.asarray(LGrho @ R.T) * R.T))


def construct_sesync_quadratic_form_matrix(measurements) -> sp.csr_matrix:
    """The translation-explicit SE(d)-synchronization data matrix M with
    variable layout [t_1..t_n ; vec-blocks of R_1..R_n], such that the
    SE-Sync objective is tr(X M Xᵀ) for X = [t ; R] of shape
    (d, (d+1)·n) (reference: g2o_experiment.py:96-177)."""
    if len(measurements) == 0:
        return sp.csr_matrix((0, 0))
    i, j, kappa, tau, R, t = _meas_arrays(measurements)
    d = R.shape[1]
    n = int(max(i.max(), j.max())) + 1
    kd = np.arange(d)

    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(np.asarray(r).ravel())
        cols.append(np.asarray(c).ravel())
        vals.append(np.asarray(v).ravel())

    # L(W^tau): translation-weight graph Laplacian on the first n indices.
    add(i, i, tau)
    add(j, j, tau)
    add(i, j, -tau)
    add(j, i, -tau)
    # V (upper-right) and Vᵀ (lower-left): tau * t_ij at rows i (+) and j (−),
    # columns of pose i's rotation block.
    ci = (n + d * i)[:, None] + kd
    tv = tau[:, None] * t
    add(np.broadcast_to(i[:, None], ci.shape), ci, tv)
    add(np.broadcast_to(j[:, None], ci.shape), ci, -tv)
    add(ci, np.broadcast_to(i[:, None], ci.shape), tv)
    add(ci, np.broadcast_to(j[:, None], ci.shape), -tv)
    # L(G^rho) block (shifted by n).
    rr, cc = np.meshgrid(kd, kd, indexing="ij")
    rows_d = np.concatenate([(n + d * i)[:, None] + kd,
                             (n + d * j)[:, None] + kd], 0)
    add(rows_d, rows_d, np.repeat(np.concatenate([kappa, kappa]), d))
    rows_ij = (n + d * i)[:, None, None] + rr
    cols_ij = (n + d * j)[:, None, None] + cc
    vij = -kappa[:, None, None] * R
    add(rows_ij, cols_ij, vij)
    add(cols_ij, rows_ij, vij)
    # Sigma: tau * t tᵀ on pose i's rotation block.
    ri = (n + d * i)[:, None, None] + rr
    cii = (n + d * i)[:, None, None] + cc
    add(ri, cii, tau[:, None, None] * t[:, :, None] * t[:, None, :])

    M = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=((d + 1) * n, (d + 1) * n),
    )
    return M.tocsr()


def evaluate_sesync_objective(M, Xhat: np.ndarray) -> float:
    """tr(X M Xᵀ) (reference: g2o_experiment.py:179-180), sparse-friendly."""
    Xhat = np.asarray(Xhat, dtype=np.float64)
    return float(np.sum(np.asarray(M @ Xhat.T) * Xhat.T))


def select_measurements(measurements, w) -> List:
    """Measurements whose selection weight is 1
    (reference: g2o_experiment.py:196-202)."""
    w = np.asarray(w)
    return [m for m, wi in zip(measurements, w) if wi == 1.0]

"""Pose-graph datasets: g2o parsing, odometry/loop splitting and conversion
to weighted sparsification problems and NetworkX graphs, and a plot of an
estimate (numpy; NetworkX and matplotlib imported where used; the port of
mac_tpu.slam.pose_graph).

Weight conventions:
  2D (EDGE_SE2 .. I11 I12 I13 I22 I23 I33):
      tau   = 2 / tr(Sigma_t^-1) with Sigma_t = [[I11, I12], [I12, I22]]^-1
      kappa = I33
  3D (EDGE_SE3:QUAT, upper-triangular 6x6 information):
      tau   = 3 / tr(Sigma_t^-1),  kappa = 3 / (2 tr(Sigma_R^-1))
Edges are weighted by kappa for MAC (rpm_to_mac).
"""

from collections import namedtuple
from typing import List, Tuple

import numpy as np

from mac_tpu_torch.utils.graphs import Edge

RelativePoseMeasurement = namedtuple(
    "RelativePoseMeasurement", ["i", "j", "t", "R", "kappa", "tau"]
)


def rot2D_from_theta(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def quat2rot(q) -> np.ndarray:
    """Rotation matrix from quaternion [qw, qx, qy, qz]."""
    qw, qx, qy, qz = q
    return np.array(
        [
            [qw * qw + qx * qx - qy * qy - qz * qz, 2 * (qx * qy - qz * qw),
             2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), qw * qw - qx * qx + qy * qy - qz * qz,
             2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
             qw * qw - qx * qx - qy * qy + qz * qz],
        ]
    )


def split_edges(edges: List[Edge]) -> Tuple[List[Edge], List[Edge]]:
    """Split edges into the odometry chain (|i - j| == 1, 'fixed') and loop
    closures (|i - j| > 1, 'candidates')."""
    chain, loops = [], []
    for e in edges:
        (loops if abs(e.j - e.i) > 1 else chain).append(e)
    return chain, loops


def _se2_fields(fields: np.ndarray) -> List[RelativePoseMeasurement]:
    out = []
    for row in fields:
        i, j = int(row[0]), int(row[1])
        dx, dy, dtheta, I11, I12, I13, I22, I23, I33 = row[2:11]
        tran_info = np.array([[I11, I12], [I12, I22]])
        tau = 2.0 / np.trace(np.linalg.inv(tran_info))
        out.append(
            RelativePoseMeasurement(
                i=i, j=j, t=np.array([dx, dy]), R=rot2D_from_theta(dtheta),
                kappa=I33, tau=tau,
            )
        )
    return out


def _se3_fields(fields: np.ndarray) -> List[RelativePoseMeasurement]:
    out = []
    for row in fields:
        i, j = int(row[0]), int(row[1])
        dx, dy, dz, dqx, dqy, dqz, dqw = row[2:9]
        q = np.array([dqw, dqx, dqy, dqz])
        q = q / np.linalg.norm(q)
        (I11, I12, I13, I14, I15, I16,
         I22, I23, I24, I25, I26,
         I33, I34, I35, I36,
         I44, I45, I46,
         I55, I56,
         I66) = row[9:30]
        info = np.array(
            [
                [I11, I12, I13, I14, I15, I16],
                [I12, I22, I23, I24, I25, I26],
                [I13, I23, I33, I34, I35, I36],
                [I14, I24, I34, I44, I45, I46],
                [I15, I25, I35, I45, I55, I56],
                [I16, I26, I36, I46, I56, I66],
            ]
        )
        tau = 3.0 / np.trace(np.linalg.inv(info[0:3, 0:3]))
        kappa = 3.0 / (2.0 * np.trace(np.linalg.inv(info[3:6, 3:6])))
        out.append(
            RelativePoseMeasurement(i=i, j=j, t=np.array([dx, dy, dz]),
                                    R=quat2rot(q), kappa=kappa, tau=tau)
        )
    return out


def read_g2o_file(filename: str) -> Tuple[List[RelativePoseMeasurement], int]:
    """Parse a .g2o file; returns (measurements, num_poses).

    Supports EDGE_SE2 and EDGE_SE3:QUAT records. Uses the native C tokenizer
    (mac_tpu_torch.native) when it builds, else a Python parse.
    """
    from mac_tpu_torch import native

    parsed = native.g2o_parse_arrays(filename)
    if parsed is not None:
        se2_rows, se3_rows = parsed
    else:
        se2_rows, se3_rows = [], []
        with open(filename, "r") as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if parts[0] == "EDGE_SE2":
                    se2_rows.append([float(v) for v in parts[1:12]])
                elif parts[0] == "EDGE_SE3:QUAT":
                    se3_rows.append([float(v) for v in parts[1:31]])

    measurements: List[RelativePoseMeasurement] = []
    num_poses = 0
    if len(se2_rows):
        arr = np.asarray(se2_rows)
        measurements.extend(_se2_fields(arr))
        num_poses = max(num_poses, int(arr[:, :2].max()))
    if len(se3_rows):
        arr = np.asarray(se3_rows)
        measurements.extend(_se3_fields(arr))
        num_poses = max(num_poses, int(arr[:, :2].max()))
    return measurements, num_poses + 1


def rpm_to_mac(measurements: List[RelativePoseMeasurement]) -> List[Edge]:
    """Edges weighted by the rotation concentration kappa."""
    return [Edge(m.i, m.j, m.kappa) for m in measurements]


def rpm_to_arrays(measurements) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (idx (m, 2) int32, kappa weights (m,)) arrays of the
    measurements."""
    idx = np.array([[m.i, m.j] for m in measurements], dtype=np.int32)
    w = np.array([m.kappa for m in measurements])
    return idx, w


def rpm_to_nx(measurements):
    """NetworkX graph of the measurements, weighted by kappa."""
    import networkx as nx

    G = nx.Graph()
    for m in measurements:
        G.add_edge(m.i, m.j, weight=m.kappa)
    return G


def _normalized_translations(xhat: np.ndarray) -> np.ndarray:
    """The (d, n) translations of an SE-Sync variable matrix
    X = [t_1 .. t_n | R_1 .. R_n] of shape (d, n (d + 1)), gauge-normalised:
    rotated by R_1^T and moved so that t_1 is the origin."""
    d, cols = xhat.shape
    n = cols // (d + 1)
    R0 = xhat[:, n:n + d]
    t = R0.T @ xhat[:, :n]
    return t - t[:, :1]


def plot_poses(xhat: np.ndarray, measurements, show: bool = True,
               color: str = "b", alpha: float = 0.25, ax=None):
    """Draw an estimated pose graph: the odometry chain as a solid
    polyline, loop closures as faint segments. 2D and 3D variable
    matrices; returns the matplotlib axis."""
    import matplotlib.pyplot as plt

    t = _normalized_translations(np.asarray(xhat))
    d = t.shape[0]
    if ax is None:
        fig = plt.figure()
        ax = (fig.add_subplot(projection="3d") if d == 3
              else fig.add_subplot(1, 1, 1))
    if d == 2:
        ax.plot(t[0], t[1], color=color, alpha=1.0, linewidth=0.5)
    else:
        ax.plot3D(t[0], t[1], t[2], color=color, alpha=1.0, linewidth=0.3)
    for m in measurements:
        if abs(m.i - m.j) <= 1:
            continue
        seg = t[:, [m.i, m.j]]
        if d == 2:
            ax.plot(seg[0], seg[1], color=color, alpha=alpha, linewidth=0.5)
        else:
            ax.plot3D(seg[0], seg[1], seg[2], color=color, alpha=alpha,
                      linewidth=0.3)
    if d == 2:
        ax.set_aspect("equal")
    ax.set_axis_off()
    if show:
        plt.show()
    return ax

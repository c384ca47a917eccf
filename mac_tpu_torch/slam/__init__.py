"""The SLAM harness: pose-graph datasets, trajectory metrics and the SE-Sync
objective evaluations (numpy and scipy); the names of mac_tpu.slam."""

from mac_tpu_torch.slam.metrics import (
    ate_tran,
    normalize_poses,
    poses_ate_tran,
    poses_rpe_rot,
    rotations_from_variable_matrix,
    rpe_rot,
    translations_from_variable_matrix,
    umeyama_alignment,
)
from mac_tpu_torch.slam.pose_graph import (
    RelativePoseMeasurement,
    plot_poses,
    quat2rot,
    read_g2o_file,
    rot2D_from_theta,
    rpm_to_arrays,
    rpm_to_mac,
    rpm_to_nx,
    split_edges,
)

__all__ = [
    "RelativePoseMeasurement",
    "plot_poses",
    "quat2rot",
    "read_g2o_file",
    "rot2D_from_theta",
    "rpm_to_arrays",
    "rpm_to_mac",
    "rpm_to_nx",
    "split_edges",
    "ate_tran",
    "normalize_poses",
    "poses_ate_tran",
    "poses_rpe_rot",
    "rotations_from_variable_matrix",
    "rpe_rot",
    "translations_from_variable_matrix",
    "umeyama_alignment",
]

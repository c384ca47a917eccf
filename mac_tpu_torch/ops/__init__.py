"""Banded operator, tridiagonal solves, CG and the TRACEMIN eigensolver;
the package exports the names of mac_tpu.ops."""

from mac_tpu_torch.ops.laplacian import (
    GraphOperator,
    build_operator,
    lap_apply,
    lap_degrees,
    lap_dense,
)
from mac_tpu_torch.ops.lobpcg import dense_fiedler, lobpcg_fiedler

__all__ = [
    "GraphOperator",
    "build_operator",
    "lap_apply",
    "lap_dense",
    "lap_degrees",
    "lobpcg_fiedler",
    "dense_fiedler",
]

"""Pose-graph datasets."""

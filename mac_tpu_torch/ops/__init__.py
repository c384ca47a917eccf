"""Banded operator, tridiagonal solves, CG and the TRACEMIN eigensolver."""

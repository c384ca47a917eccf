"""Parity of the PyTorch port's matrix-free Laplacian operator
(mac_tpu_torch.ops.laplacian) against the JAX package's, on the CPU: the
GraphOperator tables, the degrees, the tridiagonal part and the ELL and
dense products. Graphs come from the scale benchmark's seeded generator."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import laplacian as jl
from mac_tpu_torch import convert
from mac_tpu_torch.ops import laplacian as tl
from scripts.bench_scale import synthetic

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def graph_and_weights(n, seed=0):
    """All edges of synthetic(n) (chain first, then candidates) and float32
    weights with the candidates scaled by a random selection in [0, 1]."""
    fi, wf, ci, wc = synthetic(n, seed=seed)
    idx = np.concatenate([fi, ci]).astype(np.int64)
    x = np.random.RandomState(seed + 1).rand(len(wc))
    w = np.concatenate([wf, x * wc]).astype(np.float32)
    return idx, w, n


@pytest.mark.parametrize("n,mode", [(3000, "ell"), (200, "dense")])
def test_build_operator_tables_equal_jax(n, mode):
    """build_operator gives the JAX package's six tables (ELL slot order
    included) and static fields exactly, and convert carries the JAX
    operator over unchanged."""
    idx, _, n = graph_and_weights(n)
    jop = jl.build_operator(idx, n)
    top = tl.build_operator(idx, n)
    assert top.mode == jop.mode == mode
    assert (top.n, top.coarse_s, top.coarse_nc) == (jop.n, jop.coarse_s,
                                                   jop.coarse_nc)
    conv = convert.graph_operator(jop)
    for name in tl.TABLES:
        ref = np.asarray(getattr(jop, name))
        np.testing.assert_array_equal(getattr(top, name).numpy(), ref,
                                      err_msg=name)
        np.testing.assert_array_equal(getattr(conv, name).numpy(), ref,
                                      err_msg=name)


@pytest.mark.parametrize("n", [3000, 200])
def test_degrees_band_and_products_match_jax(n):
    """lap_degrees, lap_inf_norm and lap_tridiagonal_part within 1e-6
    relative in float32; lap_apply (difference-form ELL gather, or the
    dense product) and lap_applier within 1e-6 of the largest entry."""
    idx, w, n = graph_and_weights(n)
    jop, top = jl.build_operator(idx, n), tl.build_operator(idx, n)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    np.testing.assert_allclose(tl.lap_degrees(top, tw).numpy(),
                               np.asarray(jl.lap_degrees(jop, jw)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.lap_inf_norm(top, tw)),
                               float(jl.lap_inf_norm(jop, jw)), rtol=1e-6)
    (td, te), (jd, je) = (tl.lap_tridiagonal_part(top, tw),
                          jl.lap_tridiagonal_part(jop, jw))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    assert te.shape == (n - 1,) and float(te.abs().min()) > 0  # full chain
    V = np.random.RandomState(2).normal(size=(n, 4)).astype(np.float32)
    ref = np.asarray(jl.lap_apply(jop, jw, jnp.asarray(V)))
    tol = 1e-6 * np.abs(ref).max()
    for got in (tl.lap_apply(top, tw, torch.as_tensor(V)),
                tl.lap_applier(top, tw)(torch.as_tensor(V))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=tol)

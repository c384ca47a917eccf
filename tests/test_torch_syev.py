"""Kernel K4's plain version (mac_tpu_torch.ops.kernels.syev.sym_eig_plain,
the round-robin cyclic Jacobi that a CPU tensor takes) against
numpy.linalg.eigh and the JAX package's jnp.linalg.eigh, and the port's
TRACEMIN, whose Rayleigh-Ritz eigensolves run through it, against the JAX
package's. The kernel itself runs only on the card
(tests/test_torch_cuda.py). Inputs are made from numpy seeds.

Tolerances, with eps the dtype's and ||H|| the Frobenius norm: eigenvalues
within 2 k eps ||H|| of numpy's float64 ones (of the same H rounded to the
dtype); the residual ||H V - V diag(evals)|| within 2 k eps ||H|| and
||V^T V - I|| within 2 k eps; a cluster of equal eigenvalues by its
invariant subspace, its projector within 2 k eps ||H|| / gap of numpy's
(the clusters 1 apart); against JAX's eigenvectors, each |cosine| within
2 k eps / (gap / ||H||)^2 of 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mac_tpu_torch.ops.kernels.syev import MAX_K, sym_eig, sym_eig_plain

torch.set_num_threads(1)

KS = (1, 2, 3, 4, 12, 31, 32)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _matrices(kind, k, batch=3, seed=0):
    """(batch, k, k) float64 symmetric matrices of a kind, and the sizes of
    the clusters of equal eigenvalues they were built with (None: no
    planted cluster)."""
    rng = np.random.RandomState(seed + 97 * k)
    if kind == "random":
        A = rng.normal(size=(batch, k, k))
        return A + A.transpose(0, 2, 1), None
    if kind == "diagonal":
        return np.stack([np.diag(rng.normal(size=k))
                         for _ in range(batch)]), None
    if kind == "zero":
        return np.zeros((batch, k, k)), None
    # clustered: Q diag(lam) Q^T with lam in blocks of equal values.
    sizes = [min(3, k - i) for i in range(0, k, 3)]
    out = []
    for _ in range(batch):
        lam = np.repeat(np.arange(len(sizes)) * 1.0 - 1.5, sizes)
        Q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        out.append((Q * lam) @ Q.T)
    A = np.stack(out)
    return (A + A.transpose(0, 2, 1)) / 2, sizes


def _check(H64, evals, V, dtype, sizes):
    """The tolerances of the module docstring, per matrix."""
    k = H64.shape[-1]
    eps = torch.finfo(dtype).eps
    evals = evals.double().numpy()
    V = V.double().numpy()
    for h, e, v in zip(H64, evals, V):
        hn = max(np.linalg.norm(h), np.finfo(np.float64).tiny)
        ref, vref = np.linalg.eigh(h)
        tol = 2 * k * eps
        assert np.all(np.diff(e) >= 0), e  # ascending
        np.testing.assert_allclose(e, ref, rtol=0, atol=tol * hn)
        resid = np.linalg.norm(h @ v - v * e[None, :])
        assert resid <= tol * hn, (resid, tol * hn)
        assert np.abs(v.T @ v - np.eye(k)).max() <= tol
        # The sign convention: each column's largest entry (the first on
        # ties) is positive.
        top = v[np.argmax(np.abs(v), axis=0), np.arange(k)]
        assert np.all(top > 0), top
        if sizes is not None:  # clusters 1 apart
            start = 0
            for size in sizes:
                P = v[:, start:start + size] @ v[:, start:start + size].T
                Pref = (vref[:, start:start + size]
                        @ vref[:, start:start + size].T)
                assert np.abs(P - Pref).max() <= tol * hn  # gap 1
                start += size


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["random", "diagonal", "zero", "clustered"])
@pytest.mark.parametrize("k", KS)
def test_plain_jacobi_matches_numpy_eigh(k, kind, dtype):
    """A batch of three matrices (k from 1 to 32, float32 and float64):
    eigenvalues, residual, orthogonality, order, the sign convention and
    clusters by subspace, against numpy.linalg.eigh in float64."""
    dt = DTYPES[dtype]
    A, sizes = _matrices(kind, k)
    H = torch.as_tensor(A, dtype=dt)
    evals, V = sym_eig(H)  # a CPU tensor: the plain version
    assert evals.dtype == V.dtype == dt
    assert evals.shape == (3, k) and V.shape == (3, k, k)
    _check(H.double().numpy(), evals, V, dt, sizes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", KS)
def test_plain_jacobi_matches_jax_eigh(k, dtype):
    """The eigenvalues of the JAX package's jnp.linalg.eigh (the call K4
    stands for) on the same random matrices in the same dtype, within
    2 k eps ||H||, and its eigenvectors up to sign (random matrices:
    simple eigenvalues)."""
    dt = DTYPES[dtype]
    A, _ = _matrices("random", k, seed=5)
    H = torch.as_tensor(A, dtype=dt)
    evals, V = sym_eig(H)
    jw, jv = jnp.linalg.eigh(jnp.asarray(H.numpy()))
    jw, jv = np.asarray(jw, np.float64), np.asarray(jv, np.float64)
    eps = torch.finfo(dt).eps
    for h, e, v, je, jvv in zip(H.double().numpy(), evals.double().numpy(),
                                V.double().numpy(), jw, jv):
        hn = np.linalg.norm(h)
        np.testing.assert_allclose(e, je, rtol=0, atol=2 * k * eps * hn)
        if k == 1:
            continue
        gap = np.min(np.diff(je)) / hn
        cos = np.abs(np.sum(v * jvv, axis=0))
        assert np.all(cos >= 1 - 2 * k * eps / gap ** 2), (cos, gap)


def test_plain_jacobi_stays_in_the_dtype_and_the_batch_shape():
    """Leading batch dimensions pass through; float32 computes in float32
    (its result differs from the float64 run's by more than float64
    rounding); a single matrix is a batch of none."""
    A, _ = _matrices("random", 12, batch=6, seed=2)
    H = torch.as_tensor(A.reshape(2, 3, 12, 12))
    e64, V64 = sym_eig_plain(H)
    e32, V32 = sym_eig_plain(H.float())
    assert e64.shape == (2, 3, 12) and V64.shape == (2, 3, 12, 12)
    assert e32.dtype == torch.float32
    assert (e32.double() - e64).abs().max() > 1e-10
    e1, V1 = sym_eig(H[1, 2])
    assert torch.equal(e1, e64[1, 2]) and torch.equal(V1, V64[1, 2])


def test_sym_eig_refuses_what_it_does_not_take():
    """A non-square or 1-D tensor raises on the CPU; the kernel's own
    limits (k <= MAX_K, float32/float64, contiguous) are checked on the
    card (tests/test_torch_cuda.py)."""
    with pytest.raises(ValueError):
        sym_eig(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        sym_eig(torch.zeros(4, dtype=torch.float64))
    assert MAX_K == 32


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_tracemin_on_sym_eig_matches_jax(prec, monkeypatch):
    """The port's TRACEMIN, whose Rayleigh-Ritz eigensolves go through
    sym_eig (the plain Jacobi here), against the JAX package's on the same
    banded operator, start block and injected previous-iterate block, at
    the parity tolerances of tests/test_torch_eigen.py (lambda_2 rtol 1e-4,
    |<v, v'>| >= 1 - 1e-4), with sym_eig called at the entry and once an
    outer iteration."""
    import mac_tpu_torch.ops.kernels.syev as syev_mod
    from tests.test_torch_eigen import test_tracemin_matches_jax

    calls = []
    real = syev_mod.sym_eig

    def counted(H):
        calls.append(tuple(H.shape))
        return real(H)

    monkeypatch.setattr(syev_mod, "sym_eig", counted)
    test_tracemin_matches_jax(prec)
    assert calls[0] == (4, 4) and set(calls[1:]) == {(12, 12)}
    assert len(calls) >= 2

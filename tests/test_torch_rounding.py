"""mac_tpu_torch.utils.rounding against mac_tpu.utils.rounding on the CPU:
the numpy nearest rounding bitwise; Madow sampling bitwise with the JAX
package's offset injected (jax.random cannot be reproduced by a
torch.Generator), its exact cardinality and inclusion probabilities; best
of R; Bernoulli rounding's mean."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.utils import rounding as jr
from mac_tpu_torch.utils import rounding as tr

torch.set_num_threads(1)


def relaxed(m, k, seed):
    """A point strictly inside the box with |x| = k and several exact
    ties, and candidate weights with ties of their own."""
    rng = np.random.RandomState(seed)
    d = rng.rand(m)
    d[::7] = d[0]
    d -= d.mean()
    mid = k / m
    x = mid + 0.9 * min(mid, 1 - mid) * d / max(np.abs(d).max(), 1e-300)
    return x, 0.5 + rng.randint(0, 4, m) / 4.0


@pytest.mark.parametrize("m,k", [(50, 0), (50, 50), (50, 7), (333, 100)])
@pytest.mark.parametrize("ties", [False, True])
def test_round_nearest_np_equals_jax(m, k, ties):
    """round_nearest_np: bitwise the JAX package's numpy rounding, and the
    tensor form agrees with it when ties are broken by weight."""
    x, w = relaxed(m, max(k, 1), m + k)
    kw = dict(weights=w, break_ties_decimal_tol=10) if ties else {}
    got = tr.round_nearest_np(x, k, **kw)
    np.testing.assert_array_equal(got, jr.round_nearest_np(x, k, **kw))
    assert got.sum() == min(k, m)
    if ties:
        np.testing.assert_array_equal(
            tr.round_nearest(torch.as_tensor(x), k, **kw).numpy(), got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m,k", [(40, 1), (40, 13), (500, 250), (500, 499)])
def test_round_madow_base_equals_jax_with_injected_u(dtype, m, k):
    """The same offsets u through both packages: bitwise equal samples of
    exactly k items, also with the offset the JAX key draws."""
    x, _ = relaxed(m, k, 3 * m + k)
    x = x.astype(dtype)
    key = jax.random.PRNGKey(m + k)
    us = [0.0, 0.25, 0.999, float(jax.random.uniform(key, (), dtype=dtype))]
    for u in us:
        ref = np.asarray(jr.round_madow_base(jnp.asarray(x), k, u=u))
        got = tr.round_madow_base(torch.as_tensor(x), k, u=u).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.sum() == k and set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_array_equal(
        np.asarray(jr.round_madow_base(jnp.asarray(x), k, key)),
        tr.round_madow_base(torch.as_tensor(x), k, u=us[-1]).numpy())


def test_round_madow_base_generator_cardinality_and_inclusion():
    """From a torch.Generator: every sample holds exactly k items, a seed
    reproduces its sample, k <= 0 selects nothing, and over 4000 samples the
    inclusion frequencies match w k / |w| within 0.03 (4 sigma of a
    Bernoulli mean at p = 1/2 is 0.032)."""
    m, k = 30, 9
    x, _ = relaxed(m, k, 11)
    xt = torch.as_tensor(x)
    gen = torch.Generator().manual_seed(5)
    acc = np.zeros(m)
    n_samples = 4000
    for _ in range(n_samples):
        s = tr.round_madow_base(xt, k, gen).numpy()
        assert s.sum() == k
        acc += s
    np.testing.assert_allclose(acc / n_samples, x * k / x.sum(), atol=0.03)
    a = tr.round_madow_base(xt, k, torch.Generator().manual_seed(1))
    b = tr.round_madow_base(xt, k, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert tr.round_madow_base(xt, 0, gen).sum() == 0


def test_round_madow_best_of_r():
    """round_madow returns the trial its batched value function scores
    highest, the JAX package's pick on the same offsets; one trial (or no
    value function) is round_madow_base."""
    m, k, R = 60, 20, 6
    x, w = relaxed(m, k, 2)
    us = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (R,)),
                    np.float64)
    value = lambda xs: xs @ torch.as_tensor(w)  # noqa: E731
    got = tr.round_madow(torch.as_tensor(x), k, value_fn=value, max_iters=R,
                         u=us).numpy()
    trials = np.stack([np.asarray(jr.round_madow_base(jnp.asarray(x), k,
                                                      u=u)) for u in us])
    np.testing.assert_array_equal(got, trials[np.argmax(trials @ w)])
    gen = torch.Generator().manual_seed(3)
    one = tr.round_madow(torch.as_tensor(x), k, gen)
    assert torch.equal(one, tr.round_madow_base(
        torch.as_tensor(x), k, torch.Generator().manual_seed(3)))
    best = tr.round_madow(torch.as_tensor(x), k,
                          torch.Generator().manual_seed(3), value_fn=value,
                          max_iters=R)
    assert best.sum() == k


def test_round_random_mean():
    """Bernoulli rounding: 0/1 entries whose mean over 2000 draws is w
    within 0.05, and a seed reproduces its draw."""
    x = np.linspace(0.05, 0.95, 19)
    gen = torch.Generator().manual_seed(2)
    acc = sum(tr.round_random(torch.as_tensor(x), 5, gen).numpy()
              for _ in range(2000))
    np.testing.assert_allclose(acc / 2000, x, atol=0.05)
    a = tr.round_random(torch.as_tensor(x), 5)
    assert torch.equal(a, tr.round_random(torch.as_tensor(x), 5))
    assert set(np.unique(a.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dynamic_lane_forms_equal_jax(dtype):
    """The sweep's lane forms on seeded inputs with exact ties, budgets 0,
    inside and past m: solve_subset_box_lp_dynamic (ranks of one stable
    descending sort), round_nearest_dynamic (with and without the weight
    tie-break) and round_madow_base_dynamic (the JAX package's offsets
    injected) equal the JAX package's functions of each lane exactly."""
    from mac_tpu.optimization import constraints as jc
    from mac_tpu_torch.optimization.constraints import \
        solve_subset_box_lp_dynamic

    m = 57
    rng = np.random.RandomState(11)
    g = np.round(rng.rand(5, m), 1).astype(dtype)  # many exact ties
    ks = np.array([0, 1, 13, 40, 60])
    x = np.stack([relaxed(m, max(min(k, m - 1), 1), 7 + k)[0] for k in ks]
                 ).astype(dtype)
    weights = relaxed(m, 1, 3)[1]
    keys = jax.random.split(jax.random.PRNGKey(5), len(ks))
    u = [float(jax.random.uniform(kk, (), dtype=dtype)) for kk in keys]
    k_t = torch.as_tensor(ks)
    got_lp = solve_subset_box_lp_dynamic(torch.as_tensor(g), k_t).numpy()
    got_near = [tr.round_nearest_dynamic(torch.as_tensor(x), k_t,
                                         weights=wts).numpy()
                for wts in (None, weights)]
    got_madow = tr.round_madow_base_dynamic(
        torch.as_tensor(x), k_t, torch.tensor(u, dtype=torch.float64)).numpy()
    for r, k in enumerate(ks):
        kj = jnp.asarray(k)
        np.testing.assert_array_equal(
            got_lp[r], jc.solve_subset_box_lp_dynamic(jnp.asarray(g[r]), kj))
        for got, wts in zip(got_near, (None, weights)):
            np.testing.assert_array_equal(got[r], jr.round_nearest_dynamic(
                jnp.asarray(x[r]), kj, weights=wts))
        np.testing.assert_array_equal(got_madow[r], jr.round_madow_base_dynamic(
            jnp.asarray(x[r]), kj, keys[r]))
        assert got_lp[r].sum() == min(k, m) and got_near[1][r].sum() == min(
            k, m)

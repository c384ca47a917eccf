"""Parity of the PyTorch port's eigensolver (TRACEMIN), LP oracle, nearest
rounding, Frank-Wolfe loop and MAC.problem against the JAX package, on the
CPU. Random inputs come from numpy seeds; the random block that seeds
TRACEMIN's previous-iterate memory is drawn by JAX and injected into the
port (torch cannot reproduce jax.random)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu.ops.lobpcg import tracemin_fiedler as jax_tracemin
from mac_tpu.optimization.constraints import solve_subset_box_lp as jax_lp
from mac_tpu.optimization.frankwolfe import frank_wolfe_with_state as jax_fw
from mac_tpu.solvers import MAC as JMAC
from mac_tpu.utils.rounding import round_nearest as jax_round
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.ops.lobpcg import tracemin_fiedler
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.optimization.frankwolfe import frank_wolfe_with_state
from mac_tpu_torch.solvers import MAC
from mac_tpu_torch.utils.rounding import round_nearest
from tests.test_torch_banded import GRAPHS, pose_graph

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

JDT = {"f64": jnp.float64, "f32": jnp.float32}
TDT = {"f64": torch.float64, "f32": torch.float32}


def jax_xprev(n, q, dtype):
    """The block the JAX TRACEMIN draws internally (PRNGKey(7))."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(7), (n, q),
                                        dtype=dtype))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_tracemin_matches_jax(prec):
    """Up to eight outer iterations from the same X0 and the injected
    previous-iterate block, on the same banded operator and preconditioner: lambda_2
    matches at rtol 1e-4 and |<v, v'>| >= 1 - 1e-4 (eigh column signs may
    differ between the packages)."""
    jdt, tdt = JDT[prec], TDT[prec]
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jdt)
    tbop = convert.banded_operator(jbop)
    rng = np.random.RandomState(3)
    X0 = rng.normal(size=(n, 4))
    kw = dict(tol=1e-12, maxiter=8, inner_iters=5, rel_tol=1e-12,
              coeff_dtype=None if prec == "f64" else jdt)

    @jax.jit
    def run_jax(w, X0):
        BD = jb.assemble_bd(jbop, w, fused=False)
        M = jb.make_banded_precond(jbop, BD, w=w)
        return jax_tracemin(lambda V: jb.banded_apply(jbop, BD, V), X0,
                            2.0 * jnp.max(BD.deg), M, **kw)

    jres = run_jax(jnp.asarray(w, jdt), jnp.asarray(X0, jdt))
    tw = torch.as_tensor(w, dtype=tdt)
    BD = tb.assemble_bd(tbop, tw)
    M = tb.make_banded_precond(tbop, BD, w=tw)
    tkw = dict(kw, coeff_dtype=None if prec == "f64" else tdt)
    tres = tracemin_fiedler(
        lambda V: tb.banded_apply(tbop, BD, V),
        torch.as_tensor(X0, dtype=tdt), 2.0 * BD.deg.max(), M,
        xprev0=torch.tensor(jax_xprev(n, 4, jdt)), **tkw)
    assert tres.iters == int(jres.iters)
    if prec == "f64":
        assert tres.iters == 8  # f32 may stop earlier, at its own floor
    np.testing.assert_allclose(float(tres.lam[0]), float(jres.lam[0]),
                               rtol=1e-4)
    v = tres.X[:, 0].double().numpy()
    vj = np.asarray(jres.X[:, 0], np.float64)
    cos = abs(v @ vj) / (np.linalg.norm(v) * np.linalg.norm(vj))
    assert cos >= 1 - 1e-4, cos


def test_subset_box_lp_matches_jax_on_ties():
    """The top-k oracle breaks ties to the lower index, as jax.lax.top_k."""
    rng = np.random.RandomState(0)
    g = rng.randint(0, 5, size=200).astype(np.float32)
    for k in (0, 1, 17, 100, 199, 200, 250):
        np.testing.assert_array_equal(
            solve_subset_box_lp(torch.as_tensor(g), k).numpy(),
            np.asarray(jax_lp(jnp.asarray(g), k)), err_msg=f"k={k}")


@pytest.mark.parametrize("with_weights", [True, False])
def test_round_nearest_matches_jax_on_ties(with_weights):
    """Nearest rounding: the lexsort tie-break on (w, original weight) and
    the plain top-k, both with many exact ties."""
    rng = np.random.RandomState(1)
    w = rng.choice([0.0, 0.25, 0.5, 1.0], size=300).astype(np.float32)
    weights = rng.choice([1.0, 2.0, 3.0], size=300).astype(np.float32)
    extra = (dict(weights=weights, break_ties_decimal_tol=10)
             if with_weights else {})
    textra = (dict(weights=torch.as_tensor(weights),
                   break_ties_decimal_tol=10) if with_weights else {})
    for k in (0, 1, 50, 150, 299, 300):
        got = round_nearest(torch.as_tensor(w), k, **textra).numpy()
        ref = np.asarray(jax_round(
            jnp.asarray(w), k,
            **({k_: jnp.asarray(v) if k_ == "weights" else v
                for k_, v in extra.items()})))
        np.testing.assert_array_equal(got, ref, err_msg=f"k={k}")


@pytest.mark.parametrize("gap_tol,tail,lin", [(0.0, 6, 0.0),
                                               (1e-3, None, 20.0)])
def test_frank_wolfe_matches_jax(gap_tol, tail, lin):
    """Frank-Wolfe on the concave f(x) = lin a.x - ||x - c||^2 over the
    k-subset box in float64: the iterate, the dual bound, the threaded state
    and the step count match to rtol 1e-12 -- with Cesaro tail averaging and
    the gap stop off (tol <= 0), and with the gap stop on (a strong linear
    term puts the optimum at a vertex, which stops the loop early)."""
    rng = np.random.RandomState(2)
    m, k = 40, 7
    c = rng.rand(m)
    a = lin * rng.rand(m)
    x0 = np.full(m, k / m)

    def make_problem(asarray):
        cc, aa = asarray(c), asarray(a)

        def problem(x, state):
            return (aa @ x - ((x - cc) ** 2).sum(), aa - 2.0 * (x - cc),
                    state + 1)
        return problem

    jx, ju, jst, jit_ = jax_fw(
        jnp.asarray(x0), jnp.asarray(0), make_problem(jnp.asarray),
        lambda g: jax_lp(g, k), maxiter=20, relative_duality_gap_tol=gap_tol,
        tail_average_from=tail)
    tx, tu, tst, tit = frank_wolfe_with_state(
        torch.as_tensor(x0), 0, make_problem(torch.as_tensor),
        lambda g: solve_subset_box_lp(g, k), maxiter=20,
        relative_duality_gap_tol=gap_tol, tail_average_from=tail)
    assert tit == int(jit_) and tst == int(jst)
    assert (tit < 20) == (gap_tol > 0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(float(tu), float(ju), rtol=1e-12)


def test_mac_problem_matches_jax():
    """MAC.problem(x) -- one cold Fiedler solve with the fast32 knobs and the
    supergradient -- on the same graph, start block and previous-iterate
    block: f at rtol 1e-4, the gradient at rtol 1e-3 (atol 1e-3 of its
    largest entry, as entries near zero carry f32 noise)."""
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    jm = JMAC(fixed, cands, n, use_banded=True, dtype=jnp.float32,
              fw_polish=False)
    jm.round_guard = False
    tm = MAC(fixed, cands, n, use_banded=True, dtype=torch.float32,
             fw_polish=False, round_guard=False, device="cpu")
    tm.xprev0 = torch.tensor(jax_xprev(n, tm._q, jnp.float32))
    # The parameter tuples agree (convert carries the JAX one over).
    for mine, theirs in zip(tm._params[:3], convert.mac_params(jm._params)):
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())
    x = np.random.RandomState(5).rand(len(cands[1]))
    jf, jg = jm.problem(x)
    tf, tg = tm.problem(x)
    np.testing.assert_allclose(tf, jf, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=1e-3 * np.abs(jg).max())

"""Parity of the PyTorch port's banded operator, assembly (kernel K2/K2b)
and two-level preconditioner against the JAX package, on the CPU. The port
runs its kernels' plain versions here; the JAX side runs its Pallas kernels
in interpret mode or its XLA path. Inputs are made from seeds with numpy
and handed to both as arrays."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def pose_graph(n=700, n_loops=260, span=40, seed=3):
    """Odometry chain plus short-range loop closures (banded after RCM)."""
    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    w = 0.5 + rng.rand(len(idx))
    return idx, w, n


# The three graph regimes of the slice: no overflow split with the exact
# chain factor (n <= 4096), the overflow split (K2b), and the blocked chain
# factor (n > 4096).
GRAPHS = {
    "nosplit700": (700, 120, 40, 3),
    "split1500": (1500, 1200, 25, 3),
    "blocked4500": (4500, 1500, 40, 3),
}


def both_operators(name):
    idx, w, n = pose_graph(*GRAPHS[name])
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jnp.float32)
    return jbop, convert.banded_operator(jbop), w, n


def _w_pad(w32):
    return jnp.concatenate([-w32, jnp.zeros((1,), jnp.float32)])


def test_assemble_plain_matches_xla_and_pallas_without_split():
    """K2's plain version equals the XLA sheared path and the Pallas kernel
    (interpret mode) bit for bit; the degrees agree to the few f32 ulps a
    different summation order gives (rtol 1e-6)."""
    from mac_tpu.ops.pallas.assemble_kernel import assemble_ut_fused

    jbop, tbop, w, n = both_operators("nosplit700")
    assert jbop.ov_rows == 0
    w32 = jnp.asarray(w, jnp.float32)
    wu = _w_pad(w32)[jbop.ueid_tbl]
    ref = np.asarray(jb._assemble_ut_xla(jbop, wu))
    pallas = np.asarray(assemble_ut_fused(jbop.dcol_tbl, wu, half=jbop.half,
                                          nb=jbop.nb, interpret=True))
    BD = tb.assemble_bd(tbop, torch.as_tensor(w, dtype=torch.float32))
    got = BD.ut.numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    jdeg = np.asarray(jb.assemble_bd(jbop, w32, fused=False).deg)
    np.testing.assert_allclose(BD.deg.numpy(), jdeg, rtol=1e-6)


def test_assemble_plain_matches_with_overflow_split():
    """With the overflow split (K2b's tables) the plain version still equals
    the XLA all-slots path bit for bit, and the Pallas overflow kernel
    (interpret mode) to its stated f32 reorder tolerance, atol 1e-6."""
    from mac_tpu.ops.pallas.assemble_kernel import assemble_ut_fused_ov

    jbop, tbop, w, n = both_operators("split1500")
    assert jbop.ov_rows > 0 and jbop.du_dense < jbop.ueid_tbl.shape[0]
    w32 = jnp.asarray(w, jnp.float32)
    w_pad = _w_pad(w32)
    ref = np.asarray(jb._assemble_ut_xla(jbop, w_pad[jbop.ueid_tbl]))
    pallas = np.asarray(assemble_ut_fused_ov(
        jbop.dcol_tbl[:jbop.du_dense], w_pad[jbop.ueid_tbl[:jbop.du_dense]],
        jbop.ocol_tbl, jbop.olane_tbl, w_pad[jbop.oeid_tbl],
        half=jbop.half, nb=jbop.nb, interpret=True))
    BD = tb.assemble_bd(tbop, torch.as_tensor(w, dtype=torch.float32))
    np.testing.assert_array_equal(BD.ut.numpy(), ref)
    np.testing.assert_allclose(BD.ut.numpy(), pallas, rtol=0, atol=1e-6)
    jdeg = np.asarray(jb.assemble_bd(jbop, w32, fused=False).deg)
    np.testing.assert_allclose(BD.deg.numpy(), jdeg, rtol=1e-6)


def test_assemble_wrapper_validates_and_counts_nothing_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches no
    kernel; malformed tables are refused."""
    _, tbop, w, _ = both_operators("nosplit700")
    w_pad = torch.cat([-torch.as_tensor(w, dtype=torch.float32),
                       torch.zeros(1)])
    args = (tbop.dcol_tbl, w_pad[tbop.ueid_tbl], tbop.ocol_tbl,
            tbop.olane_tbl, w_pad[tbop.oeid_tbl], tbop.half, tbop.nb)
    before = assemble_ut.launches
    np.testing.assert_array_equal(assemble_ut(*args).numpy(),
                                  assemble_ut_plain(*args).numpy())
    assert assemble_ut.launches == before
    with pytest.raises(ValueError):
        assemble_ut(args[0][:, :-1], *args[1:])


@pytest.mark.parametrize("name", ["nosplit700", "split1500"])
def test_banded_apply_matches_jax_f32(name):
    """L(w) V with local centring, f32, against the JAX HIGHEST-precision
    apply: rtol 1e-5 of max |LV|."""
    jbop, tbop, w, n = both_operators(name)
    rng = np.random.RandomState(1)
    V = rng.normal(size=(n, 4)).astype(np.float32)
    jBD = jb.assemble_bd(jbop, jnp.asarray(w, jnp.float32), fused=False)
    ref = np.asarray(jb.banded_apply(jbop, jBD, jnp.asarray(V)))
    tBD = tb.assemble_bd(tbop, torch.as_tensor(w, dtype=torch.float32))
    got = tb.banded_apply(tbop, tBD, torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@jax.jit
def _jax_precond_apply(jbop, w, B, prev_state, use_prev):
    """The JAX package's two-level preconditioner applied to B, compiled
    once: cold (prev_state None) or refreshed from a carried state."""
    BD = jb.assemble_bd(jbop, w, fused=False)
    if prev_state is None:
        M, st = jb.make_banded_precond(jbop, BD, w=w, return_state=True)
    else:
        M, st = jb.make_banded_precond(jbop, BD, w=w, prev_state=prev_state,
                                       use_prev=use_prev, return_state=True)
    return M(B), st


@pytest.mark.parametrize("name", ["nosplit700", "blocked4500"])
@pytest.mark.parametrize("state", ["cold", "newton_schulz"])
def test_precond_application_matches_jax(name, state):
    """The two-level preconditioner (chain smoother through the RCM
    permutation, coarse correction) applied to a random block matches the
    JAX package's at rtol 1e-4 of max |M B|, from a cold Cholesky build and
    from a Newton-Schulz refresh of a carried state (the inverse of a
    perturbed operator, as a warm Frank-Wolfe step carries). The port runs
    the reference's DEFAULT-precision products in f32, as JAX does on the
    CPU."""
    jbop, tbop, w, n = both_operators(name)
    rng = np.random.RandomState(4)
    w32 = (w * (0.5 + rng.rand(len(w)))).astype(np.float32)
    B = rng.normal(size=(n, 4)).astype(np.float32)
    tw = torch.as_tensor(w32)
    tBD = tb.assemble_bd(tbop, tw)
    if state == "cold":
        ref, _ = _jax_precond_apply(jbop, jnp.asarray(w32), jnp.asarray(B),
                                    None, None)
        tM = tb.make_banded_precond(tbop, tBD, w=tw)
    else:
        w_prev = jnp.asarray(np.asarray(w, np.float32))
        _, jprev = _jax_precond_apply(jbop, w_prev, jnp.asarray(B), None,
                                      None)
        ref, jst = _jax_precond_apply(jbop, jnp.asarray(w32), jnp.asarray(B),
                                      jprev, True)
        tM, tst = tb.make_banded_precond(
            tbop, tBD, w=tw, prev_state=convert.precond_state(jprev),
            use_prev=True, return_state=True)
        np.testing.assert_allclose(tst.Lc_inv.numpy(), np.asarray(jst.Lc_inv),
                                   rtol=1e-4,
                                   atol=1e-4 * np.abs(jst.Lc_inv).max())
    ref = np.asarray(ref)
    got = tM(torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_precond_rebuild_false_reuses_carried_state():
    """rebuild=False reuses the carried coarse inverse and chain factor as
    they are; rebuild needs a carried state."""
    _, tbop, w, n = both_operators("nosplit700")
    tw = torch.as_tensor(w, dtype=torch.float32)
    tBD = tb.assemble_bd(tbop, tw)
    _, st = tb.make_banded_precond(tbop, tBD, w=tw, return_state=True)
    _, st2 = tb.make_banded_precond(tbop, tBD, w=tw * 2, prev_state=st,
                                    use_prev=True, rebuild=False,
                                    return_state=True)
    assert st2.Lc_inv is st.Lc_inv
    assert st2.chain_dp is st.chain_dp and st2.chain_l is st.chain_l
    with pytest.raises(ValueError):
        tb.make_banded_precond(tbop, tBD, w=tw, rebuild=True)

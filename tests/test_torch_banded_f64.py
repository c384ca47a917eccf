"""The PyTorch port's banded layer in float64 against the JAX package's on
the CPU (the tables built as tests/ops/test_banded.py builds them, with
dtype float64): assembly (kernel K2/K2b's plain version, bitwise), the
degrees, the banded product, the chain factor and the two-level
preconditioner built cold and refreshed by Newton-Schulz, at rtol 1e-12.
Also the float64 rule of the tridiagonal dispatch on a card, shown on the
CPU by standing in for the card: every float64 block goes to a kernel
wrapper (K1 or K1b, float64 instantiation) with the arguments the kernels
take, none to the plain scans."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mac_tpu.ops import banded as jb
from mac_tpu_torch import convert
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.ops import tridiag as tt
from mac_tpu_torch.ops.kernels import assemble as kassemble
from mac_tpu_torch.ops.kernels import tridiag as ktridiag
from tests.test_torch_banded import GRAPHS, pose_graph

torch.set_num_threads(1)

RTOL = 1e-12


def operators64(name):
    """The JAX package's float64 banded tables of a GRAPHS entry, the
    port's copy of them, the edge weights and n."""
    idx, w, n = pose_graph(*GRAPHS[name])
    jbop, _ = jb.build_banded_rcm(idx, n, dtype=jnp.float64)
    return jbop, convert.banded_operator(jbop), w, n


def close(got, ref, rtol=RTOL):
    """got within rtol of ref, relative to max |ref|."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("name", ["nosplit700", "split1500"])
def test_assemble_f64_bitwise_and_degrees(name):
    """The float64 assembly (K2's table form, and K2b's overflow split)
    equals the JAX package's sheared XLA assembly bit for bit, and
    assemble_ut is its plain version on CPU tensors, launching nothing; the
    degrees agree at 1e-12; the dense L(w) read off BD in RCM ids equals
    the JAX package's dense Laplacian of the relabelled edges."""
    from mac_tpu.ops.laplacian import build_operator, lap_dense

    jbop, tbop, w, n = operators64(name)
    assert (jbop.ov_rows > 0) == (name == "split1500")
    w64 = jnp.asarray(w, jnp.float64)
    w_pad = jnp.concatenate([-w64, jnp.zeros((1,), jnp.float64)])
    ref = np.asarray(jb._assemble_ut_xla(jbop, w_pad[jbop.ueid_tbl]))
    tw = torch.as_tensor(w)
    before = kassemble.assemble_ut.launches
    BD = tb.assemble_bd(tbop, tw)
    assert BD.ut.dtype == torch.float64 and BD.deg.dtype == torch.float64
    np.testing.assert_array_equal(BD.ut.numpy(), ref)
    wt_pad = torch.cat([-tw, tw.new_zeros(1)])
    dd = tbop.du_dense
    plain = kassemble.assemble_ut_plain(
        tbop.dcol_tbl[:dd], wt_pad[tbop.ueid_tbl[:dd]], tbop.ocol_tbl,
        tbop.olane_tbl, wt_pad[tbop.oeid_tbl], tbop.half, tbop.nb)
    assert torch.equal(BD.ut, plain)
    assert kassemble.assemble_ut.launches == before
    jBD = jb.assemble_bd(jbop, w64, fused=False)
    close(BD.deg.numpy(), jBD.deg)
    idx, _, _ = pose_graph(*GRAPHS[name])
    ridx = np.asarray(jbop.iperm)[idx]
    dense = np.asarray(lap_dense(build_operator(ridx, n, mode="ell"), w64))
    close(tb.banded_dense(tbop, BD).numpy(), dense)


@pytest.mark.parametrize("name", ["nosplit700", "split1500"])
def test_banded_apply_f64_matches_jax(name):
    """L(w) V with local centring in float64 against the JAX package's at
    rtol 1e-12 of max |LV|, one block and two lanes."""
    jbop, tbop, w, n = operators64(name)
    rng = np.random.RandomState(2)
    V = rng.normal(size=(n, 4))
    jBD = jb.assemble_bd(jbop, jnp.asarray(w), fused=False)
    ref = np.asarray(jb.banded_apply(jbop, jBD, jnp.asarray(V)))
    tBD = tb.assemble_bd(tbop, torch.as_tensor(w))
    close(tb.banded_apply(tbop, tBD, torch.as_tensor(V)).numpy(), ref)
    W = torch.stack([torch.as_tensor(w), 2 * torch.as_tensor(w)])
    lanes = tb.banded_apply(tbop, tb.assemble_bd(tbop, W),
                            torch.as_tensor(np.stack([V, V])))
    close(lanes[0].numpy(), ref)
    close(lanes[1].numpy(), 2 * ref)


@jax.jit
def _jax_precond64(jbop, w, B, prev_state, use_prev):
    BD = jb.assemble_bd(jbop, w, fused=False)
    if prev_state is None:
        M, st = jb.make_banded_precond(jbop, BD, w=w, return_state=True)
    else:
        M, st = jb.make_banded_precond(jbop, BD, w=w, prev_state=prev_state,
                                       use_prev=use_prev, return_state=True)
    return M(B), st


@pytest.mark.parametrize("name", ["nosplit700", "blocked4500"])
@pytest.mark.parametrize("state", ["cold", "newton_schulz"])
def test_precond_f64_matches_jax(name, state):
    """chain_factor (exact for n <= 4096, blocked at 128 rows beyond) and
    make_banded_precond in float64, built cold (Cholesky) and refreshed by
    Newton-Schulz from a carried state: the chain factor, the coarse inverse
    and M B against the JAX package's at rtol 1e-12 of their max."""
    jbop, tbop, w, n = operators64(name)
    rng = np.random.RandomState(6)
    w2 = w * (0.5 + rng.rand(len(w)))
    B = rng.normal(size=(n, 4))
    tw = torch.as_tensor(w2)
    tBD = tb.assemble_bd(tbop, tw)
    fac = tb.chain_factor(tbop, tBD, tw)
    assert fac.seg == (None if n <= 4096 else tb.CHAIN_LDL_BLOCK)
    assert fac.dp.dtype == torch.float64
    if state == "cold":
        ref, jst = _jax_precond64(jbop, jnp.asarray(w2), jnp.asarray(B),
                                  None, None)
        tM, tst = tb.make_banded_precond(tbop, tBD, w=tw, return_state=True)
    else:
        _, jprev = _jax_precond64(jbop, jnp.asarray(w), jnp.asarray(B), None,
                                  None)
        ref, jst = _jax_precond64(jbop, jnp.asarray(w2), jnp.asarray(B),
                                  jprev, True)
        tM, tst = tb.make_banded_precond(
            tbop, tBD, w=tw,
            prev_state=convert.precond_state(jprev, dtype=torch.float64),
            use_prev=True, return_state=True)
    close(fac.dp.numpy(), jst.chain_dp)
    close(fac.l.numpy(), jst.chain_l)
    close(tst.Lc_inv.numpy(), jst.Lc_inv)
    close(tM(torch.as_tensor(B)).numpy(), ref)


class _StandInCard:
    """Stands in for a card on the CPU: the kernel wrappers take CPU
    tensors as if they lay on a card (the device checks pass, the dtype and
    layout checks of the kernels run), and each launch records the exported
    function it would call and returns the plain version's result."""

    def __init__(self, monkeypatch):
        self.launched = []
        self.plain_scans = 0
        real_on_card = ktridiag._on_card

        def on_card(name, dp, l, B):
            real_on_card(name, dp, l, B)  # the shape checks
            ktridiag.check_kernel_args(name, dp, l, B)
            return True

        def launch(fn, dp, l, B, *extra):
            self.launched.append(fn)
            if fn.startswith("tridiag_solve_blocked"):
                return ktridiag.tridiag_solve_blocked_plain(dp, l, B,
                                                            *extra)
            return ktridiag.tridiag_solve_plain(dp, l, B)

        def scans(f, B):
            self.plain_scans += 1
            return ktridiag.tridiag_solve_plain(f.dp, f.l, B)

        monkeypatch.setattr(ktridiag, "_on_card", on_card)
        monkeypatch.setattr(ktridiag, "_launch", launch)
        monkeypatch.setattr(tt, "tridiag_solve_factored", scans)


def test_float64_blocks_on_a_card_reach_the_kernels(monkeypatch):
    """tridiag_solve_factored_fast on float64 blocks with a card standing
    in: up to 32768 rows every factor goes to tridiag_solve_f64 (K1), past
    it a factor decoupled at segments dividing 1024 to
    tridiag_solve_blocked_f64 (K1b) and an exact factor to K1, lanes too;
    never to tridiag_solve_factored (the plain scans); each result equals
    the plain scans'. Float32 blocks keep their _f32 kernels."""
    card = _StandInCard(monkeypatch)
    rng = np.random.RandomState(0)
    n = 33000
    e = -(0.5 + rng.rand(n - 1))
    d = 0.1 + rng.rand(n) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    d64, e64 = torch.as_tensor(d), torch.as_tensor(e)
    B = torch.as_tensor(rng.normal(size=(n, 4)))
    cases = [(tt.tridiag_ldl_blocked(d64, e64, 1024), n, "blocked"),
             (tt.tridiag_ldl_blocked(d64, e64, 128), n, "blocked"),
             (tt.tridiag_ldl(d64, e64), n, "whole"),
             (tt.tridiag_ldl(d64[:3000], e64[:2999]), 3000, "whole"),
             (tt.tridiag_ldl_blocked(d64[:3000], e64[:2999], 128), 3000,
              "whole")]
    for f, rows, kind in cases:
        card.launched.clear()
        got = tt.tridiag_solve_factored_fast(f, B[:rows])
        want = ("tridiag_solve_blocked_f64" if kind == "blocked"
                else "tridiag_solve_f64")
        assert card.launched == [want], (f.seg, rows, card.launched)
        ref = ktridiag.tridiag_solve_plain(f.dp, f.l, B[:rows])
        if kind == "blocked":
            ref = ktridiag.tridiag_solve_blocked_plain(f.dp, f.l, B[:rows])
        assert torch.equal(got, ref)
    lanes = tt.tridiag_ldl(torch.stack([d64[:500], 2 * d64[:500]]),
                           e64[:499].expand(2, -1))
    card.launched.clear()
    tt.tridiag_solve_factored_fast(lanes, B[:500].expand(2, -1, -1)
                                   .contiguous())
    assert card.launched == ["tridiag_solve_f64"]
    card.launched.clear()
    tt.tridiag_solve_factored_fast(tt.tridiag_ldl(d64[:500].float(),
                                                  e64[:499].float()),
                                   B[:500].float())
    assert card.launched == ["tridiag_solve_f32"]
    assert card.plain_scans == 0


def test_float64_banded_solve_on_a_card_launches_only_kernels(monkeypatch):
    """A whole MAC solve on the banded operator in float64 (n = 600), with a
    card standing in for the kernels: every chain solve calls
    tridiag_solve_f64 with contiguous float64 arrays and every assembly
    assemble_ut_f64's checks pass; no block reaches the plain scans; the
    result is the plain run's, bit for bit."""
    from mac_tpu_torch.solvers import MAC

    idx, w, n = pose_graph(600, 110, 9, 11)
    fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
    k = len(cands[1]) // 2
    plain = MAC(fixed, cands, n, use_banded=True, dtype=torch.float64,
                device="cpu").solve(k)
    card = _StandInCard(monkeypatch)
    assembled = []
    real_assemble = kassemble.assemble_ut

    def assemble(dcol, wu, ocol, olane, ow, half, nb):
        kassemble.check_kernel_args((("dcol", dcol), ("wu", wu),
                                     ("ocol", ocol), ("olane", olane),
                                     ("ow", ow)))
        assembled.append(wu.dtype)
        return real_assemble(dcol, wu, ocol, olane, ow, half, nb)

    monkeypatch.setattr(tb, "assemble_ut", assemble)
    got = MAC(fixed, cands, n, use_banded=True, dtype=torch.float64,
              device="cpu").solve(k)
    assert set(card.launched) == {"tridiag_solve_f64"}
    assert assembled and set(assembled) == {torch.float64}
    assert card.plain_scans == 0
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)

"""The lane forms of the banded layer (the budget sweep's R weight vectors
in one call) against a loop of single-lane calls, on the CPU: kernel
K2/K2b's plain version (assemble_ut_plain), assemble_bd and the degree
vector, banded_apply, chain_factor and make_banded_precond, with and
without the overflow split and on both sides of the 4096-node gate of the
blocked chain factor. Bitwise where the lane form runs the same operations
per lane; the batched products and factorisations to 1e-12 in float64."""

import pytest
import torch

from mac_tpu_torch.ops import banded
from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
from tests.test_torch_banded import pose_graph

torch.set_num_threads(1)

R = 3


def lanes_of(graph, dtype=torch.float64):
    """The banded tables of a pose graph and R seeded weight vectors."""
    idx, w, n = pose_graph(*graph)
    bop, _ = banded.build_banded_rcm(idx, n)
    gen = torch.Generator().manual_seed(graph[-1])
    scale = 0.25 + torch.rand((R, len(w)), generator=gen, dtype=dtype)
    return bop, torch.as_tensor(w, dtype=dtype) * scale


# (n, loops, span, seed): no overflow split at n = 700, the split at 1500;
# the exact chain factor below 4096 nodes, the blocked one at 4500.
GRAPHS = [(700, 120, 40, 3), (1500, 1200, 25, 3), (4500, 1500, 40, 3)]


@pytest.mark.parametrize("graph", GRAPHS)
def test_assembly_lanes_equal_single_assemblies(graph):
    """assemble_ut_plain and assemble_ut (on CPU tensors) with wu (R, du,
    n_pad) and ow (R, ov, nb) give ut (R, half+1, nb, 128, 128), lane r
    bitwise the single assembly of lane r's weights; assemble_bd's lanes
    (ut and the degree vector) likewise."""
    bop, w = lanes_of(graph, torch.float32)
    if graph[0] == 1500:
        assert bop.ov_rows > 0
    w_pad = torch.cat([-w, w.new_zeros((R, 1))], dim=-1)
    dd = bop.du_dense
    args = (bop.dcol_tbl[:dd], w_pad[:, bop.ueid_tbl[:dd]], bop.ocol_tbl,
            bop.olane_tbl, w_pad[:, bop.oeid_tbl], bop.half, bop.nb)
    got = assemble_ut_plain(*args)
    assert got.shape == (R, bop.half + 1, bop.nb, banded.BS, banded.BS)
    assert torch.equal(assemble_ut(*args), got)
    BD = banded.assemble_bd(bop, w)
    for r in range(R):
        one = banded.assemble_bd(bop, w[r])
        assert torch.equal(got[r], one.ut) and torch.equal(BD.ut[r], one.ut)
        assert torch.equal(BD.deg[r], one.deg)


@pytest.mark.parametrize("graph", GRAPHS)
def test_banded_operator_lanes_equal_single_lanes(graph):
    """banded_apply on (R, n, q) (every lane's product in one batched
    matmul), chain_factor (one factor per lane) and make_banded_precond
    (one chain factor and one coarse level per lane) equal the single-lane
    calls to 1e-12 in float64."""
    bop, w = lanes_of(graph)
    n = bop.n
    V = torch.randn((R, n, 4), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    BD = banded.assemble_bd(bop, w)
    out = banded.banded_apply(bop, BD, V)
    fac = banded.chain_factor(bop, BD, w)
    assert fac.dp.shape == fac.l.shape == (R, n)
    assert fac.seg == (banded.CHAIN_LDL_BLOCK if n > 4096 else None)
    pre = banded.make_banded_precond(bop, BD, w)(V)
    for r in range(R):
        one = banded.assemble_bd(bop, w[r])
        torch.testing.assert_close(
            out[r], banded.banded_apply(bop, one, V[r]), rtol=1e-12,
            atol=1e-12)
        f1 = banded.chain_factor(bop, one, w[r])
        assert torch.equal(fac.dp[r], f1.dp) and torch.equal(fac.l[r], f1.l)
        torch.testing.assert_close(
            pre[r], banded.make_banded_precond(bop, one, w[r])(V[r]),
            rtol=1e-10, atol=1e-12)

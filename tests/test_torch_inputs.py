"""The PyTorch port's inputs and boundaries: import hygiene, the g2o reader,
NaiveGreedy, the banded tables (against the JAX package's, and through
mac_tpu_torch.convert), and what the constructor and solve do with each
route's knobs, the routes that still raise included."""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from mac_tpu.ops import banded as jb
from mac_tpu.slam import pose_graph as jpg
from mac_tpu.solvers import NaiveGreedy as JNaiveGreedy
from mac_tpu_torch import convert
from mac_tpu_torch.device import resolve_device
from mac_tpu_torch.ops import banded as tb
from mac_tpu_torch.parallel.mesh import make_mesh
from mac_tpu_torch.slam import pose_graph as tpg
from mac_tpu_torch.solvers import MAC, NaiveGreedy
from tests.test_torch_banded import GRAPHS, pose_graph

# The suite runs in several worker processes on shared cores; one torch
# thread per process keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mac_tpu_torch"


def test_import_does_not_load_jax():
    """Importing the port in a fresh interpreter loads neither JAX nor the
    JAX package (importing mac_tpu turns on x64 and a compile cache)."""
    code = ("import sys, mac_tpu_torch, mac_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mac_tpu' or "
            "m.startswith('mac_tpu.')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_jax_import_in_package_sources():
    """No file of the port imports jax or mac_tpu (static scan)."""
    pat = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|mac_tpu)(?!\w)",
                     re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("dataset", ["intel.g2o", "city10000.g2o"])
def test_g2o_reader_matches_jax(dataset):
    """read_g2o_file + rpm_to_mac + split_edges give the same edges, weights
    and pose counts as the JAX package's reader."""
    path = str(REPO / "data" / dataset)
    jm, jn = jpg.read_g2o_file(path)
    tm, tn = tpg.read_g2o_file(path)
    assert jn == tn and len(jm) == len(tm)
    for a, b in zip(jm, tm):
        assert (a.i, a.j) == (b.i, b.j)
        assert a.kappa == b.kappa and a.tau == b.tau
        np.testing.assert_array_equal(a.t, b.t)
        np.testing.assert_array_equal(a.R, b.R)
    jf, jc = jpg.split_edges(jpg.rpm_to_mac(jm))
    tf, tc = tpg.split_edges(tpg.rpm_to_mac(tm))
    assert [tuple(e) for e in jf] == [tuple(e) for e in tf]
    assert [tuple(e) for e in jc] == [tuple(e) for e in tc]


def test_naive_greedy_matches_jax():
    _, cands = tpg.split_edges(tpg.rpm_to_mac(
        tpg.read_g2o_file(str(REPO / "data" / "city10000.g2o"))[0]))
    for k in (0, 7, len(cands) // 2, len(cands)):
        np.testing.assert_array_equal(NaiveGreedy(cands).subset(k),
                                      JNaiveGreedy(cands).subset(k))


def _city10000_edges():
    meas, n = tpg.read_g2o_file(str(REPO / "data" / "city10000.g2o"))
    fixed, cands = tpg.split_edges(tpg.rpm_to_mac(meas))
    return np.array([[e.i, e.j] for e in fixed + cands]), n


@pytest.mark.parametrize("name", ["nosplit700", "split1500", "city10000"])
def test_banded_tables_match_jax_and_round_trip(name):
    """build_banded_rcm gives the JAX package's nine tables, static fields
    and relabelled edges exactly; convert carries the JAX tables over and
    round-trips the port's own."""
    if name == "city10000":
        idx, n = _city10000_edges()
    else:
        idx, _, n = pose_graph(*GRAPHS[name])
    jbop, jridx = jb.build_banded_rcm(idx, n, dtype=jnp.float32)
    tbop, tridx = tb.build_banded_rcm(idx, n)
    np.testing.assert_array_equal(tridx, np.asarray(jridx))
    if name == "city10000":
        assert (tbop.nb, tbop.half, tbop.du_dense, tbop.ov_rows,
                tbop.coarse_nc, tbop.coarse_s) == (79, 2, 5, 5, 500, 20)
    if name == "split1500":
        assert tbop.ov_rows > 0
    mine = convert.banded_tables(tbop)
    conv = convert.banded_tables(convert.banded_operator(jbop))
    back = convert.banded_tables(convert.banded_operator(mine))
    for key in tb.TABLES:
        ref = np.asarray(getattr(jbop, key))
        np.testing.assert_array_equal(mine[key], ref, err_msg=key)
        np.testing.assert_array_equal(conv[key], ref, err_msg=key)
        np.testing.assert_array_equal(back[key], ref, err_msg=key)
        assert mine[key].dtype == np.int32
    for key in tb.STATICS:
        assert mine[key] == conv[key] == back[key] == getattr(jbop, key), key


def _small_problem():
    idx, w, n = pose_graph(*GRAPHS["nosplit700"])
    return (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:]), n


BANDED32 = dict(use_banded=True, dtype=torch.float32, device="cpu")
CPU_MESH = "a one-rank gloo mesh on the CPU, made in the test"


@pytest.mark.parametrize("kwargs,want", [
    (dict(device="cpu"), (torch.float64, "host", False, False, False)),
    (dict(BANDED32), (torch.float32, "device", True, True, True)),
    (dict(BANDED32, fw_polish=False),
     (torch.float32, "device", True, False, True)),
    (dict(BANDED32, fw_polish=False, round_guard=False, mesh=object()),
     (TypeError, "DeviceMesh")),
    (dict(device="cuda", use_banded=False, mesh=CPU_MESH),
     (ValueError, "contradicts the mesh")),
    (dict(device="cpu", use_banded=True, dtype=torch.float64),
     (torch.float64, "device", True, False, False)),
    (dict(BANDED32, fiedler_method="lobpcg"),
     (torch.float32, "device", True, True, True)),
])
def test_unported_routes_raise(kwargs, want):
    """The constructor's routes on a small banded graph: the default one
    (the size gate sends it to the float64 host engine), the banded float32
    one with its exact tails, and the two routes that once raised
    NotImplementedError: the banded operator in float64 (the reference's
    conservative knobs, no host tails) and LOBPCG on the banded operator
    construct, with the dtype, backend, operator, fw_polish and round_guard
    the reference resolves. A mesh that is no DeviceMesh is a TypeError,
    and a device that contradicts the mesh's (a one-rank gloo mesh on the
    CPU here) a ValueError."""
    fixed, cands, n = _small_problem()
    if isinstance(want, tuple) and isinstance(want[0], type):
        exc, match = want
        if kwargs.get("mesh") is CPU_MESH:
            with tempfile.TemporaryDirectory() as tmp:
                dist.init_process_group("gloo", rank=0, world_size=1,
                                        init_method=f"file://{tmp}/rdv")
                try:
                    kwargs = dict(kwargs, mesh=make_mesh(device_type="cpu"))
                    with pytest.raises(exc, match=match):
                        MAC(fixed, cands, n, **kwargs)
                finally:
                    dist.destroy_process_group()
            return
        with pytest.raises(exc, match=match):
            MAC(fixed, cands, n, **kwargs)
        return
    mac = MAC(fixed, cands, n, **kwargs)
    assert (mac.dtype, mac.fiedler_backend, mac._banded is not None,
            mac.fw_polish, mac.round_guard) == want
    assert mac.fiedler_method == kwargs.get("fiedler_method", "tracemin")
    if mac._banded is not None and mac.dtype == torch.float64:
        # Not the fast32 policy: the reference's conservative knobs.
        assert (mac.fiedler_tol, mac.fiedler_maxiter, mac.fiedler_inner_iters,
                mac.fiedler_rel_tol, mac.fiedler_coeff_dtype,
                mac.fw_tail_average, mac._warm_inner_schedule) == (
            1e-8, 200, 16, None, None, False, None)


def test_unported_solve_options_raise():
    """What solve refused before the port had them now runs: Madow
    rounding selects exactly k edges, k = 0 nothing and k = m everything;
    an unknown rounding is a ValueError."""
    fixed, cands, n = _small_problem()
    mac = MAC(fixed, cands, n, fw_polish=False, round_guard=False,
              **BANDED32)
    m = len(cands[1])
    for kw, count in ((dict(k=5, rounding="madow"), 5), (dict(k=0), 0),
                      (dict(k=m), m)):
        rounded, unrounded, upper = mac.solve(**kw)
        assert rounded.sum() == count and np.isfinite(upper)
        assert set(np.unique(rounded)) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="rounding"):
        mac.solve(5, rounding="nearest_neighbour")


def test_graph_without_narrow_band_raises():
    """Expander-like loop closures leave no narrow band. Even with
    use_banded=True such a graph takes the matrix-free ELL operator in
    original node ids, where fw_polish and round_guard resolve False, as in
    the reference, and Madow rounding runs there. So does a float64 solver
    with use_banded=True (no band to take), and without use_banded, float64
    takes the ELL operator too."""
    rng = np.random.RandomState(0)
    n = 2000
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    rand = np.sort(rng.randint(0, n, size=(2000, 2)), axis=1)
    rand = rand[rand[:, 1] - rand[:, 0] > 1]
    fixed, cands = (chain, np.ones(n - 1)), (rand, np.ones(len(rand)))
    banded64 = MAC(fixed, cands, n, **dict(BANDED32, dtype=torch.float64))
    assert banded64._banded is None and banded64.op.mode == "ell"
    assert banded64.dtype == torch.float64
    assert not banded64.fw_polish and not banded64.round_guard
    mac64 = MAC(fixed, cands, n, dtype=torch.float64, device="cpu")
    assert mac64._banded is None and mac64.op.mode == "ell"
    assert mac64.fiedler_backend == "device"
    mac = MAC(fixed, cands, n, **BANDED32)
    assert mac._banded is None and mac.op.mode == "ell"
    assert not mac.fw_polish and not mac.round_guard
    np.testing.assert_array_equal(mac._int_idx,
                                  np.concatenate([chain, rand]))
    rounded, _, upper = mac.solve(5, rounding="madow", max_iters=2)
    assert rounded.sum() == 5 and np.isfinite(upper)


def test_cuda_device_without_cuda_raises(monkeypatch):
    """A CUDA device with no CUDA present is an error, never a silent move
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

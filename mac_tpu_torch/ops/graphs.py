"""TRACEMIN's inner solve as a replayed CUDA graph.

The reference runs each outer iteration's preconditioned CG as one
jax.lax.fori_loop inside its compiled eigensolver (mac_tpu/ops/cg.py:64):
a fixed number of steps, no stop test, no host read. ops.cg.pcg_fixed runs
the same steps eagerly, one launch per op (about 140 a step on city10000's
banded route, 75 on the n = 100000 matrix-free one). On the card this
module captures the steps once as a torch.cuda.CUDAGraph and replays it.

An InnerSolve is the inner solve of one route of one operator: the banded
operator with its chain-smoothed cycle of one kind (banded_inner), or the
ELL operator with its two-grid V-cycle (twogrid_inner). Its `build(state)`
makes the route's (apply_L, Minv) closures over a dict of tensors, the
state: what the product and the preconditioner read that changes from one
Frank-Wolfe step to the next (the assembled blocks or the ELL weight table,
the chain factor, the coarse inverse; banded_state, twogrid_state), to
which TRACEMIN adds its nullspace shift c and its shift sigma. Called with
a state, a right-hand side B, a start X0 and a step count:

  * on CPU tensors it builds the closures over that state and runs
    pcg_fixed (`plain`): the plain version;
  * on CUDA tensors it replays the graph of (dtype, block shape, steps,
    kernels in use) (`replay`), capturing it at first use: static copies of
    the state, B and X0 are made, the closures are built once over them,
    one step is run on a side stream (K1's first launch sets its function
    attributes, which a capture cannot) and then the steps are captured.
    Every call copies the current state, B and X0 into the static buffers,
    whether or not they moved, replays the graph and returns a clone of its
    output. A capture that fails raises; nothing falls back to the eager
    loop.

The InnerSolves live with their operator (`inner_solves`), so every
Frank-Wolfe step of every solve on it replays the same graphs, and go with
it (they hold it weakly). A graph keeps alive the operator's tables it read
at capture.

Launch counts stay true. The kernel wrappers count in Python, so a capture
counts once what each replay launches. That count is taken back (a capture
launches nothing) and added again at every replay.
"""

import gc
import time
import weakref
from typing import Callable, Dict, NamedTuple

import torch

from mac_tpu_torch.ops import banded as _banded
from mac_tpu_torch.ops import twogrid as _twogrid
from mac_tpu_torch.ops.cg import pcg_fixed
from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels import ldl as _ldl
from mac_tpu_torch.ops.kernels import tridiag as _tridiag
from mac_tpu_torch.ops.kernels.assemble import assemble_ut
from mac_tpu_torch.ops.laplacian import GraphOperator, ell_applier
from mac_tpu_torch.ops.lobpcg import _shift_term
from mac_tpu_torch.ops.tridiag import TridiagFactor

# Every kernel wrapper; a replay adds what its capture counted to each.
WRAPPERS = (_tridiag.tridiag_solve, _tridiag.tridiag_solve_blocked,
            assemble_ut, _ldl.tridiag_ldl, _ldl.tridiag_ldl_blocked)


def _counts():
    return [(w.launches, dict(w.launches_by_lanes), dict(w.launches_by_dtype))
            for w in WRAPPERS]


def _set_counts(counts) -> None:
    for w, (n, lanes, dtypes) in zip(WRAPPERS, counts):
        w.launches, w.launches_by_lanes, w.launches_by_dtype = (
            n, dict(lanes), dict(dtypes))


def _delta(after, before):
    """What each wrapper counted between two _counts(), zeros left out."""
    def sub(a, b):
        return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}

    return [(na - nb, sub(la, lb), sub(da, db))
            for (na, la, da), (nb, lb, db) in zip(after, before)]


def _add(delta) -> None:
    for w, (n, lanes, dtypes) in zip(WRAPPERS, delta):
        w.launches += n
        for key, v in lanes.items():
            w.launches_by_lanes[key] = w.launches_by_lanes.get(key, 0) + v
        for key, v in dtypes.items():
            w.launches_by_dtype[key] = w.launches_by_dtype.get(key, 0) + v


def _kernels_in_use():
    """What a capture bakes in beyond the shapes: the solve wrappers the
    tridiagonal dispatch calls (a comparison run may swap in their plain
    versions) and the kernel libraries loaded (kernel_ab.py loads other
    builds in turns)."""
    return (_tridiag.tridiag_solve, _tridiag.tridiag_solve_blocked,
            _build.loaded_files())


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: Dict[str, torch.Tensor]
    B: torch.Tensor
    X0: torch.Tensor
    out: torch.Tensor
    launches: list  # what one replay launches, per wrapper
    tables: tuple   # the operator's tables at capture, kept alive


class InnerSolve:
    """pcg_fixed of TRACEMIN's shifted operator, apply_L(V) + c-shift +
    sigma V, preconditioned by the route's Minv, for the closures that
    `build(state)` returns; see the module docstring. `tables()` gives the
    operator's tensors the closures read besides the state.

    captures / replays: graphs captured and replayed; capture_s: seconds
    spent capturing (warm-up step included); pool_bytes: device memory the
    captures reserved for their private pools; static_bytes: the static
    copies of state, B and X0."""

    def __init__(self, build: Callable, tables: Callable[[], tuple]):
        self.build = build
        self.tables = tables
        self.graphs = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.static_bytes = 0

    def __call__(self, state: Dict[str, torch.Tensor], B: torch.Tensor,
                 X0: torch.Tensor, iters: int) -> torch.Tensor:
        if B.is_cuda:
            return replay(self, state, B, X0, iters)
        return plain(self.build, state, B, X0, iters)


def inner_ops(build: Callable, state: Dict[str, torch.Tensor]):
    """(apply_inner, Minv) over `state`: TRACEMIN's apply_inner, in its
    order of operations (ops.lobpcg.tracemin_fiedler), and the route's
    preconditioner."""
    apply_L, Minv = build(state)
    c, sigma = state["c"], state["sigma"]

    def apply_inner(V):
        return apply_L(V) + _shift_term(V, c) + sigma * V

    return apply_inner, Minv


def plain(build: Callable, state: Dict[str, torch.Tensor], B: torch.Tensor,
          X0: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version: the closures built over `state`, then the eager
    pcg_fixed."""
    apply_inner, Minv = inner_ops(build, state)
    return pcg_fixed(apply_inner, B, Minv, iters=iters, X0=X0)


def _copy_in(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"inner solve: {name} is {tuple(src.shape)} "
                         f"{src.dtype}, the graph was captured for "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _capture(solve: InnerSolve, state, B, X0, iters: int) -> _Graph:
    dev = B.device
    t0 = time.perf_counter()
    tables = tuple(solve.tables())
    static = {name: t.clone() for name, t in state.items()}
    sB, sX0 = B.clone(), X0.clone()
    apply_inner, Minv = inner_ops(solve.build, static)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        pcg_fixed(apply_inner, sB, Minv, iters=1, X0=sX0)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    # A dead object's CUDA graph that the cycle collector destroys during
    # the capture would invalidate it (the destruction is an unsafe call
    # while a stream captures), and torch.cuda.graph no longer collects
    # before it begins: collect here.
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    try:
        with torch.cuda.graph(graph):
            out = pcg_fixed(apply_inner, sB, Minv, iters=iters, X0=sX0)
    except RuntimeError as exc:
        raise RuntimeError(f"capturing the inner solve ({iters} steps of "
                           f"{tuple(B.shape)} {B.dtype}) failed: {exc}"
                           ) from exc
    finally:
        after = _counts()
        _set_counts(before)
    solve.captures += 1
    solve.capture_s += time.perf_counter() - t0
    solve.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
    solve.static_bytes += sum(t.nbytes for t in (*static.values(), sB, sX0))
    return _Graph(graph, static, sB, sX0, out, _delta(after, before), tables)


def replay(solve: InnerSolve, state: Dict[str, torch.Tensor],
           B: torch.Tensor, X0: torch.Tensor, iters: int) -> torch.Tensor:
    """The inner solve on the card: the graph of this (dtype, shape, steps,
    kernels in use), captured at its first call, replayed over copies of
    the current state, B and X0."""
    def key():
        return (B.dtype, tuple(B.shape), int(iters), B.device,
                _kernels_in_use())

    g = solve.graphs.get(key())
    if g is None:
        g = _capture(solve, state, B, X0, iters)
        # Filed under the libraries it captured from: its warm-up step may
        # have loaded the first.
        solve.graphs[key()] = g
    if state.keys() != g.static.keys():
        raise ValueError(f"inner solve: state {sorted(state)}, the graph "
                         f"was captured for {sorted(g.static)}")
    for name, t in state.items():
        _copy_in(g.static[name], t, name)
    _copy_in(g.B, B, "B")
    _copy_in(g.X0, X0, "X0")
    g.graph.replay()
    _add(g.launches)
    solve.replays += 1
    return g.out.clone()


def bind(solve: InnerSolve, state: Dict[str, torch.Tensor]):
    """The inner solve of one Frank-Wolfe step, in the form
    ops.lobpcg.tracemin_fiedler takes (inner_solve): (B, X0, iters, c,
    sigma) -> X."""
    def inner(B, X0, iters, c, sigma):
        return solve(dict(state, c=c, sigma=sigma), B, X0, iters)

    return inner


def _cached(op, key, build: Callable, tables: Callable) -> InnerSolve:
    solve = op.inner_solves.get(key)
    if solve is None:
        solve = op.inner_solves[key] = InnerSolve(build, tables)
    return solve


def banded_inner(bop: "_banded.BandedOperator", kind: str) -> InnerSolve:
    """The banded route's inner solve: banded_apply and the chain-smoothed
    cycle of `kind` ("mult" or "additive"), rebuilt over the state by
    make_banded_precond(rebuild=False), which reuses the carried factor and
    coarse inverse and builds nothing. State: banded_state."""
    ref = weakref.ref(bop)  # the operator holds this InnerSolve: no cycle

    def build(state):
        op, BD = ref(), _banded.BDRep(ut=state["ut"], deg=state["deg"])
        Minv = _banded.make_banded_precond(
            op, BD, prev_state=_banded.PrecondState(
                Lc_inv=state["Lc_inv"], chain_dp=state["dp"],
                chain_l=state["l"]), rebuild=False, kind=kind)
        return (lambda V: _banded.banded_apply(op, BD, V)), Minv

    return _cached(bop, ("banded", kind), build,
                   lambda: tuple(ref().buffers()))


def banded_state(BD: "_banded.BDRep", pstate: "_banded.PrecondState"):
    """The banded route's state at one weight vector: the assembled blocks
    and degrees, the chain factor and the coarse inverse."""
    return {"ut": BD.ut, "deg": BD.deg, "dp": pstate.chain_dp,
            "l": pstate.chain_l, "Lc_inv": pstate.Lc_inv}


def twogrid_inner(op: GraphOperator, seg) -> InnerSolve:
    """The matrix-free route's inner solve: the ELL product and the two-grid
    V-cycle (ops.twogrid.twogrid_cycle) over a chain factor decoupled every
    `seg` rows (None: exact). State: twogrid_state."""
    ref = weakref.ref(op)  # the operator holds this InnerSolve: no cycle

    def build(state):
        apply_L = ell_applier(ref(), state["w_tbl"])
        fac = TridiagFactor(dp=state["dp"], l=state["l"], seg=seg)
        return apply_L, _twogrid.twogrid_cycle(ref(), fac, state["Lc_inv"],
                                               apply_L)

    return _cached(op, ("twogrid", seg), build, lambda: (ref().nbr_tbl,))


def twogrid_state(w_tbl: torch.Tensor, fac: TridiagFactor,
                  Lc_inv: torch.Tensor):
    """The matrix-free route's state at one weight vector: the ELL weight
    table, the chain factor and the coarse inverse."""
    return {"w_tbl": w_tbl, "dp": fac.dp, "l": fac.l, "Lc_inv": Lc_inv}

"""TRACEMIN's single solve, and each Frank-Wolfe step's set-up, as replayed
CUDA graphs.

The reference runs each eigensolve inside one compiled program with no host
round trip: the weight vector's operator and preconditioner, TRACEMIN's
entry, its outer lax.while_loop (mac_tpu/ops/lobpcg.py:468) and in each
outer iteration the fori_loop of preconditioned CG (mac_tpu/ops/cg.py:64)
and the Rayleigh-Ritz eigh. Run eagerly, the same work is one host launch
per op (about 140 a CG step on city10000's banded route) and a host read
per outer iteration. This module captures it as torch.cuda.CUDAGraphs and
replays them; the host keeps only the loop's counter and reads one flag an
outer iteration.

A Route is one route of one operator: the banded operator with its
chain-smoothed cycle of one kind (banded_route), or the ELL operator with
its two-grid V-cycle (twogrid_route). It holds
  * prepare(s, branch, guards) -> (state, lnorm): the route's state at the
    weight vector s["w"] (banded: the assembled blocks and degrees through
    K2/K2b, the chain factor through K3/K3b, the coarse inverse; ELL: the
    weight table, the V-cycle's factor and coarse inverse), built by the
    branch the host picks by step ("cold": Cholesky; "ns": Newton-Schulz
    from the carried inverse in s; "carried": s's state as it is), and
    ||L(w)||_inf;
  * build(state) -> (apply_L, Minv): the product and the preconditioner
    over a state, which build nothing.
A solve (`solve`) runs
  * on CPU tensors `plain_solve`: prepare, build, tracemin_fiedler, with
    the preconditioner's guards read on the host: the plain version;
  * on CUDA tensors `graphed_solve`, over one static state per (operator,
    dtype, shapes) (`Route.statics`: the inputs w, X0, xprev0, tol, rel_tol,
    the route's state, lnorm, TRACEMIN's carry, a saved copy of the carried
    state and the flags [keep, guard, done]): it copies the inputs in,
    replays the set-up graph of its (branch, entry), which saves the
    carried state and writes the state, lnorm, the carry, keep and guard,
    reads the flags in one sync, and then replays the outer iteration's
    graph (the inner CG steps, projection, CGS2, CholeskyQR2, Rayleigh-Ritz
    through K4, the residuals and the stall count), which updates the
    carry in place and writes keep, reading keep after each replay as
    tracemin_fiedler's loop does. A set guard (the Newton-Schulz start not
    finite, a singular coarse factor: what the eager code reads on the
    host) runs the step's set-up again eagerly from the saved state into
    the static state, so the result is the eager one (`Route.redos`).
A Frank-Wolfe loop's solves go through `StepSolves`, the per-step form of
the same: the inputs copied in once, then each step's set-up and outer
iterations over the static state as it stands, the next step's weights
written into w by the loop's K10 and its stop flag into done, which
reaches the host in the next set-up's flag read (a set-up that finds it
set is discarded, `Route.discards`). On CPU tensors StepSolves runs the
same functions over the same static buffers with no graph. `read_flag`
counts the host reads (`host_reads`).
`inner_replayed_solve` is the form before the set-up and outer iteration
were captured: the eager loop with only the inner CG steps replayed
(`inner_replay`), kept to compare against.

A graph is captured at the first call of its key (kind, branch or step
count, the block's dtype and shape, TRACEMIN's baked-in knobs, the kernels
in use): one step of it runs on a side stream over a copy of the static
state first (a kernel's first launch sets its function attributes and
cuBLAS and cuSOLVER make their handles, which a capture cannot), the cycle
collector runs (a graph it destroyed mid-capture would spoil the capture),
and then the function is captured over the static state, into the route's
one memory pool (torch.cuda.graph_pool_handle). Every graph leaves its
results in the static buffers and nothing live in the pool, so the graphs
may replay in any order. A capture that fails raises; nothing falls back
to the eager loop. The Routes live with their operator (`graph_routes`) and
hold it weakly; a graph keeps alive the operator's tables it read.

Launch counts stay true. The kernel wrappers count in Python, so a capture
counts once what each replay launches. That count is taken back (a capture
launches nothing) and added again at every replay.
"""

import gc
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import torch

from mac_tpu_torch.ops import banded as _banded
from mac_tpu_torch.ops import twogrid as _twogrid
from mac_tpu_torch.ops.cg import pcg_fixed
from mac_tpu_torch.ops import cg as _cg
from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels import banded as _kbanded
from mac_tpu_torch.ops.kernels import ell as _kell
from mac_tpu_torch.ops.kernels import pcg as _kpcg
from mac_tpu_torch.ops.kernels import ldl as _ldl
from mac_tpu_torch.ops.kernels import syev as _syev
from mac_tpu_torch.ops.kernels import tridiag as _tridiag
from mac_tpu_torch.ops.kernels.assemble import assemble_ut
from mac_tpu_torch.ops.kernels.tridiag import COUNT_DICTS
from mac_tpu_torch.ops.laplacian import (GraphOperator, ell_applier,
                                         lap_inf_norm, lap_weight_table)
from mac_tpu_torch.ops.lobpcg import (FiedlerResult, TraceminCarry,
                                      TraceminOps, as_operator,
                                      default_rel_tol, default_xprev,
                                      tracemin_fiedler)
from mac_tpu_torch.ops.tridiag import TRIDIAG_SCAN_MAX_N, TridiagFactor

# Every kernel wrapper; a replay adds what its capture counted to each.
WRAPPERS = (_tridiag.tridiag_solve, _tridiag.tridiag_solve_blocked,
            assemble_ut, _ldl.tridiag_ldl, _ldl.tridiag_ldl_blocked,
            _kbanded.banded_product, _kbanded.coarse_correct,
            _tridiag.tridiag_solve_permuted, _kpcg.col_sums,
            _kpcg.cg_update, _kpcg.cg_direction_dots, _kell.ell_product,
            _syev.sym_eig)


def _counts():
    return [(w.launches, *(dict(getattr(w, d)) for d in COUNT_DICTS))
            for w in WRAPPERS]


def _set_counts(counts) -> None:
    for w, (n, *dicts) in zip(WRAPPERS, counts):
        w.launches = n
        for d, got in zip(COUNT_DICTS, dicts):
            setattr(w, d, dict(got))


def _delta(after, before):
    """What each wrapper counted between two _counts(), zeros left out."""
    def sub(a, b):
        return {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}

    return [(na - nb, *(sub(a, b) for a, b in zip(da, db)))
            for (na, *da), (nb, *db) in zip(after, before)]


def _add(delta) -> None:
    for w, (n, *dicts) in zip(WRAPPERS, delta):
        w.launches += n
        for d, got in zip(COUNT_DICTS, dicts):
            counts = getattr(w, d)
            for key, v in got.items():
                counts[key] = counts.get(key, 0) + v


def _kernels_in_use():
    """What a capture bakes in beyond the shapes: the wrappers that the
    tridiagonal dispatch, the chain factor and TRACEMIN call through their
    modules (a comparison run may swap in their plain versions) and the
    kernel libraries loaded (kernel_ab.py loads other builds in turns)."""
    return (_tridiag.tridiag_solve, _tridiag.tridiag_solve_blocked,
            _ldl.tridiag_ldl, _ldl.tridiag_ldl_blocked, _syev.sym_eig,
            _kbanded.banded_product, _kbanded.coarse_correct,
            _tridiag.tridiag_solve_permuted, _kpcg.col_sums,
            _kpcg.cg_update, _kpcg.cg_direction_dots, _cg.pcg_fixed_steps,
            _banded._vcycle_kernels, _kell.ell_product,
            _twogrid._ell_vcycle_kernels, _build.loaded_files())


class Knobs(NamedTuple):
    """What a captured TRACEMIN bakes in beyond the shapes (its stall test
    keeps tracemin_fiedler's defaults)."""

    coeff_dtype: torch.dtype
    inner_iters: int


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: list  # what one replay launches, per wrapper
    tables: tuple   # the operator's tables at capture, kept alive


class Route:
    """The captured graphs of one route of one operator; see the module
    docstring. names: the route state's names; carried: those of them a
    set-up may read back (a carried state); tables(): the operator's
    tensors the route reads besides its state.

    captures / replays: graphs captured and replayed; capture_s: seconds
    spent capturing (warm-up steps included); pool_bytes: device memory the
    captures reserved for the route's pool; static_bytes: the static
    buffers; redos: set-ups run again eagerly for a set guard; discards:
    Frank-Wolfe steps' set-ups discarded for a stop flag (StepSolves), and
    discard_launches what each of their replays launched, per wrapper."""

    def __init__(self, prepare: Callable, build: Callable,
                 tables: Callable[[], tuple], names: tuple,
                 carried: tuple = ()):
        self.prepare = prepare
        self.build = build
        self.tables = tables
        self.names = names
        self.carried = carried
        self.statics = {}
        self.graphs = {}
        self.pool = None
        self.captures = 0
        self.replays = 0
        self.redos = 0
        self.discards = 0
        self.discard_launches = []
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.static_bytes = 0


def _ops(route: Route, state, lnorm, s, knobs: Knobs) -> TraceminOps:
    apply_L, Minv = route.build(state)
    return TraceminOps(apply_L, Minv, lnorm, dtype=s["X0"].dtype,
                       tol=s["tol"], rel_tol=s["rel_tol"],
                       coeff_dtype=knobs.coeff_dtype,
                       inner_iters=knobs.inner_iters)


def setup_outputs(route: Route, s: Dict[str, torch.Tensor], branch: str,
                  warm: bool, knobs: Knobs, guards: Optional[dict]):
    """A Frank-Wolfe step's set-up over the tensors s: the route's state at
    s["w"] by `branch`, lnorm, and TRACEMIN's entry from s["X0"] and
    s["xprev0"] (`warm`: the warm entry). Returns them by name, with the
    flags keep and guard. guards: a dict the preconditioner records its
    guard flags in (a graph's set-up), or None to read them on the host
    (the eager redo; guard is then false)."""
    state, lnorm = route.prepare(s, branch, guards)
    ops = _ops(route, state, lnorm, s, knobs)
    carry = ops.entry(s["X0"], s["xprev0"], warm)
    keep = ops.keep(carry)
    guard = torch.zeros_like(keep)
    for flag in (guards or {}).values():
        guard = guard | flag
    return dict(state, lnorm=lnorm, **carry._asdict(), keep=keep,
                guard=guard)


def outer_outputs(route: Route, s: Dict[str, torch.Tensor], knobs: Knobs):
    """One outer iteration over the tensors s: the new carry and keep."""
    state = {name: s[name] for name in route.names}
    ops = _ops(route, state, s["lnorm"], s, knobs)
    new = ops.step(TraceminCarry(*(s[f] for f in TraceminCarry._fields)))
    return dict(new._asdict(), keep=ops.keep(new))


def _write(s: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor]) -> None:
    """Copy each output into the static buffer of its name. An output that
    is itself another static buffer (the new Xprev is the old X) is copied
    first, before that buffer is overwritten."""
    static = {id(t) for t in s.values()}
    first = [n for n, t in out.items() if id(t) in static and t is not s[n]]
    for n in first + [n for n in out if n not in first]:
        if out[n] is not s[n]:
            s[n].copy_(out[n])


def _capture(route: Route, fn: Callable, s) -> _Graph:
    dev = s["X0"].device
    t0 = time.perf_counter()
    tables = tuple(route.tables())
    scratch = {n: t.clone() if isinstance(t, torch.Tensor) else t
               for n, t in s.items()}
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(scratch)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    del scratch
    # A dead object's CUDA graph that the cycle collector destroys during
    # the capture would invalidate it (the destruction is an unsafe call
    # while a stream captures), and torch.cuda.graph no longer collects
    # before it begins: collect here.
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    if route.pool is None:
        route.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    try:
        with torch.cuda.graph(graph, pool=route.pool):
            fn(s)
    except RuntimeError as exc:
        raise RuntimeError(f"capturing the solve's graph ({fn.__name__}, "
                           f"block {tuple(s['X0'].shape)} "
                           f"{s['X0'].dtype}) failed: {exc}") from exc
    finally:
        after = _counts()
        _set_counts(before)
    route.captures += 1
    route.capture_s += time.perf_counter() - t0
    route.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
    return _Graph(graph, _delta(after, before), tables)


def run(route: Route, key: tuple, fn: Callable,
        s: Dict[str, torch.Tensor]) -> Optional[_Graph]:
    """fn(s), which writes its results into s: on the card the replay of
    the graph filed under `key` (and the static state's key), captured at
    its first call, and that graph returned; on the CPU a call (None)."""
    if not s["X0"].is_cuda:
        fn(s)
        return None

    def full_key():
        return (key, s["key"], _kernels_in_use())

    g = route.graphs.get(full_key())
    if g is None:
        g = _capture(route, fn, s)
        # Filed under the libraries it captured from: its warm-up step may
        # have loaded one.
        route.graphs[full_key()] = g
    g.graph.replay()
    _add(g.launches)
    route.replays += 1
    return g


def _buffer(t: torch.Tensor) -> torch.Tensor:
    """A static copy of t, row-major whatever t's layout: the functions
    read their inputs in that layout (TraceminOps.entry), so that a copy
    in of another layout rounds as the eager code does."""
    return t.clone(memory_format=torch.contiguous_format)


_SAVED = "saved_"


def _static(route: Route, w, X, xprev0, carried, knobs: Knobs):
    """The static state of (w's and X's dtype and shape, device), made at
    its first use: clones of the inputs, buffers for the outputs, shaped by
    one eager set-up and one eager outer iteration over a copy (which also
    load the kernels' libraries), a copy of the carried state that each
    set-up takes before it writes (saved_<name>: what a guard's redo and
    a discarded step read), and the flags [keep, guard, done]: the set-up
    writes the first two, a Frank-Wolfe step's K10 the third."""
    key = (w.dtype, tuple(w.shape), X.dtype, tuple(X.shape), X.device)
    s = route.statics.get(key)
    if s is not None:
        return s
    one = torch.zeros((), dtype=X.dtype, device=X.device)
    s = {n: _buffer(t) for n, t in dict(carried, w=w, X0=X, xprev0=xprev0,
                                        tol=one, rel_tol=one).items()}
    out = setup_outputs(route, s, "cold", False, knobs, {})
    for n, t in out.items():
        if n not in s and n not in ("keep", "guard"):
            s[n] = torch.empty_like(t, memory_format=torch.contiguous_format)
    scratch = dict(s, **{n: t for n, t in out.items() if n in s})
    outer_outputs(route, scratch, knobs)
    for n in route.carried:
        s[_SAVED + n] = torch.empty_like(s[n])
    flags = torch.zeros(3, dtype=torch.bool, device=X.device)
    route.static_bytes += sum(t.nbytes for t in s.values()) + flags.nbytes
    s.update(flags=flags, keep=flags[0], guard=flags[1], done=flags[2],
             key=key)
    route.statics[key] = s
    return s


def _saved(route: Route, s) -> Dict[str, torch.Tensor]:
    """The carried state as the last set-up found it (its own copy)."""
    return {n: s[_SAVED + n] for n in route.carried}


def branch_of(pstate, use_prev, rebuild) -> str:
    """The set-up's branch for a carried preconditioner state and its
    flags, as make_banded_precond reads them: no state or a Cholesky
    rebuild "cold", a Newton-Schulz refresh "ns", a reused state
    "carried"."""
    if pstate is None:
        return "cold"
    if rebuild is not None and not rebuild:
        return "carried"
    return "ns" if use_prev else "cold"


def plain_solve(route: Route, w, X, *, carried=None, branch="cold",
                **kw):
    """The plain version of a solve: the route's state at w built eagerly
    (the guards read on the host), then tracemin_fiedler; kw are its
    knobs. Returns (FiedlerResult, state)."""
    state, lnorm = route.prepare(dict(carried or {}, w=w), branch, None)
    apply_L, Minv = route.build(state)
    return tracemin_fiedler(apply_L, X, lnorm, Minv, **kw), state


def inner_replayed_solve(route: Route, w, X, *, carried=None,
                         branch="cold", **kw):
    """plain_solve with only each outer iteration's inner CG steps replayed
    as a CUDA graph (inner_replay), the rest eager: the solve before its
    set-up and outer iteration were captured, to compare against."""
    state, lnorm = route.prepare(dict(carried or {}, w=w), branch, None)
    apply_L, Minv = route.build(state)

    def inner(B, X0, iters, c, sigma):
        return inner_replay(route, dict(state, c=c, sigma=sigma), B, X0,
                            iters)

    return tracemin_fiedler(apply_L, X, lnorm, Minv, inner_solve=inner,
                            **kw), state


def inner_replay(route: Route, state: Dict[str, torch.Tensor],
                 B: torch.Tensor, X0: torch.Tensor, iters: int):
    """`iters` pcg_fixed steps of TRACEMIN's shifted operator apply_L(V) +
    c-shift + sigma V, preconditioned by the route's Minv, over `state`
    (the route's state with c and sigma) from X0 toward B, through run():
    a graph over static copies of state, B and X0 on the card."""
    key = ("inner", B.dtype, tuple(B.shape), B.device)
    s = route.statics.get(key)
    if s is None:
        s = {n: _buffer(t) for n, t in dict(state, B=B, X0=X0).items()}
        s.update(Y=torch.empty_like(s["B"]), key=key)
        route.static_bytes += sum(t.nbytes for t in s.values()
                                  if isinstance(t, torch.Tensor))
        route.statics[key] = s
    for n, t in dict(state, B=B, X0=X0).items():
        s[n].copy_(t)

    def inner_steps(s):
        apply_L, Minv = route.build(s)
        apply_inner = as_operator(apply_L).shifted(s["c"], s["sigma"])
        s["Y"].copy_(pcg_fixed(apply_inner, s["B"], Minv, iters=iters,
                               X0=s["X0"]))

    run(route, ("inner", int(iters)), inner_steps, s)
    return s["Y"].clone()


# Device-to-host reads made by the solves' and the Frank-Wolfe loops'
# tests (graphed_solve's flags and keep, a loop's stop test; read_flag).
host_reads = 0


def read_flag(t: torch.Tensor):
    """t read on the host (a bool, or a list for a flag vector), counted
    in host_reads."""
    global host_reads
    host_reads += 1
    return t.tolist() if t.dim() else bool(t)


def _knobs(coeff_dtype, inner_iters) -> Knobs:
    return Knobs(torch.float64 if coeff_dtype is None else coeff_dtype,
                 int(inner_iters))


def _fill(s, tol, rel_tol) -> None:
    s["tol"].fill_(tol)
    s["rel_tol"].fill_(default_rel_tol(s["X0"].dtype) if rel_tol is None
                       else rel_tol)


def _solve_static(route: Route, s, branch: str, warm: bool, knobs: Knobs,
                  maxiter: int, min_iters: int, step: bool = False,
                  chain: bool = False):
    """The solve over the static state s as it stands: the set-up's graph
    (which first saves the carried state, and with chain starts from the
    last solve's Ritz block: X0 = X), one read of the flags (and an eager
    set-up from the saved state when a guard is set), then the outer
    iteration's graph until keep is false, maxiter, as tracemin_fiedler's
    loop. The outer iterations run; for a Frank-Wolfe step (step), None
    when the flag done (the last step's stop) was set."""
    def setup(s):
        if chain:
            s["X0"].copy_(s["X"])
        for n, t in _saved(route, s).items():
            t.copy_(s[n])
        _write(s, setup_outputs(route, s, branch, warm, knobs, {}))

    def outer(s):
        _write(s, outer_outputs(route, s, knobs))

    g = run(route, ("setup", branch, warm, knobs, chain), setup, s)
    keep, guard, done = read_flag(s["flags"])
    if step and done:
        route.discards += 1
        if g is not None:
            route.discard_launches.append(g.launches)
        return None
    if guard:
        # The graph overwrote the carried state: the redo reads the copy
        # it saved first.
        route.redos += 1
        _write(s, setup_outputs(route, dict(s, **_saved(route, s)), branch,
                                warm, knobs, None))
        keep = read_flag(s["keep"])
    it = 0
    while not (it >= min_iters and (it >= maxiter or not keep)):
        run(route, ("outer", knobs), outer, s)
        it += 1
        if min_iters <= it < maxiter:
            keep = read_flag(s["keep"])
    return it


def graphed_solve(route: Route, w, X, *, carried=None, branch="cold",
                  xprev0=None, tol: float = 1e-8, maxiter: int = 200,
                  inner_iters: int = 16, rel_tol=None, coeff_dtype=None,
                  lam0=None, warm_init=None, min_iters: int = 0):
    """The solve through run(): the inputs copied into the static state,
    then _solve_static. Returns (FiedlerResult, state) with copies of the
    static tensors."""
    knobs = _knobs(coeff_dtype, inner_iters)
    if xprev0 is None:
        xprev0 = default_xprev(X.shape[0], X.shape[1], X.dtype, X.device)
    carried = carried or {}
    s = _static(route, w, X, xprev0, carried, knobs)
    for n, t in dict(carried, w=w, X0=X, xprev0=xprev0).items():
        s[n].copy_(t)
    _fill(s, tol, rel_tol)
    warm = lam0 is not None and bool(warm_init)
    it = _solve_static(route, s, branch, warm, knobs, maxiter, min_iters)
    res = FiedlerResult(lam=s["lam"].clone(), X=s["X"].clone(), iters=it,
                        res=s["res"].clone())
    return res, {n: s[n].clone() for n in route.names}


class StepSolves:
    """The eigensolves of a Frank-Wolfe loop on one route, a step each,
    over the route's static state (ops.graphs' per-step interface; the
    loop is optimization.frankwolfe's device loop). Made from the first
    step's weights w, start block X and xprev0 (copied in once), it keeps
    everything in the static buffers from step to step:
      * w: the weight vector each set-up reads; the loop's K10 writes its
        candidates' part after each step;
      * done: the flag a step's K10 sets when its stop test fires (the
        loop clears it first); the next step's set-up read carries it to
        the host with keep and guard;
      * the Ritz block: with chain, each step after the first starts from
        the last step's X (copied to X0 by the set-up graph), else from X
        every step;
      * the carried preconditioner state stays where the last set-up
        wrote it, and each set-up saves a copy first (a guard's redo
        reads it).
    step(branch, maxiter, inner_iters) runs one step's solve and returns
    its outer iterations, or None when done was set: that step's set-up has
    run but is discarded, and X0 and the saved state hold what the last
    step left (stopped()). f, X and state() are where the graphs left the
    last step's Fiedler value, Ritz block and route state. So a step
    launches nothing of its own but the graphs' replays."""

    def __init__(self, route: Route, w, X, *, xprev0=None, tol=1e-8,
                 rel_tol=None, coeff_dtype=None, inner_iters=16,
                 chain=True):
        self.route, self.chain, self.coeff_dtype = route, chain, coeff_dtype
        if xprev0 is None:
            xprev0 = default_xprev(X.shape[0], X.shape[1], X.dtype, X.device)
        s = self.s = _static(route, w, X, xprev0, {},
                             _knobs(coeff_dtype, inner_iters))
        for n, t in dict(w=w, X0=X, xprev0=xprev0).items():
            s[n].copy_(t)
        _fill(s, tol, rel_tol)
        self.w, self.done = s["w"], s["done"]
        self.f, self.X = s["lam"][0], s["X"]
        self.steps = 0

    def step(self, branch: str, maxiter: int, inner_iters: int):
        it = _solve_static(self.route, self.s, branch, False,
                           _knobs(self.coeff_dtype, inner_iters), maxiter, 0,
                           step=True, chain=self.chain and self.steps > 0)
        if it is not None:
            self.steps += 1
        return it

    def state(self) -> Dict[str, torch.Tensor]:
        """The route's carried state as the last step left it."""
        return {n: self.s[n] for n in self.route.carried}

    def stopped(self):
        """(Ritz block, carried state) of the last step after a discarded
        set-up."""
        return self.s["X0"], _saved(self.route, self.s)


def solve(route: Route, w, X, **kw):
    """One TRACEMIN solve of L(w) on the route from the start block X:
    (FiedlerResult, the route's state at w). CUDA tensors: graphed_solve;
    CPU tensors: plain_solve. kw: `carried` (the route's carried state by
    name) and `branch` (branch_of), and tracemin_fiedler's knobs xprev0,
    tol, maxiter, inner_iters, rel_tol, coeff_dtype, lam0, warm_init and
    min_iters."""
    if w.is_cuda:
        return graphed_solve(route, w, X, **kw)
    return plain_solve(route, w, X, **kw)


def _cached(op, key, make: Callable) -> Route:
    route = op.graph_routes.get(key)
    if route is None:
        route = op.graph_routes[key] = make()
    return route


def banded_route(bop: "_banded.BandedOperator", kind: str) -> Route:
    """The banded route: assemble_bd (K2/K2b), make_banded_precond's chain
    cycle of `kind` ("mult" or "additive") by branch, and over a state
    banded_apply and the cycle rebuilt by make_banded_precond(rebuild=
    False), which builds nothing. State: banded_state."""
    ref = weakref.ref(bop)  # the operator holds this Route: no cycle

    def prepare(s, branch, guards):
        op, w = ref(), s["w"]
        BD = _banded.assemble_bd(op, w)
        kw = {}
        if branch != "cold":
            kw = dict(prev_state=banded_pstate(s), use_prev=branch == "ns",
                      rebuild=branch == "ns")
        _, pstate = _banded.make_banded_precond(
            op, BD, w=w, return_state=True, kind=kind, guards=guards, **kw)
        return banded_state(BD, pstate), 2.0 * BD.deg.amax(dim=(-2, -1))

    def build(state):
        op, BD = ref(), _banded.BDRep(ut=state["ut"], deg=state["deg"])
        Minv = _banded.make_banded_precond(
            op, BD, prev_state=banded_pstate(state), rebuild=False,
            kind=kind)
        return _banded.BandedProduct(op, BD), Minv

    return _cached(bop, ("banded", kind), lambda: Route(
        prepare, build, lambda: tuple(ref().buffers()),
        ("ut", "deg", "dp", "l", "Lc_inv"), ("dp", "l", "Lc_inv")))


def banded_state(BD: "_banded.BDRep", pstate: "_banded.PrecondState"):
    """The banded route's state at one weight vector: the assembled blocks
    and degrees, the chain factor and the coarse inverse."""
    return {"ut": BD.ut, "deg": BD.deg, "dp": pstate.chain_dp,
            "l": pstate.chain_l, "Lc_inv": pstate.Lc_inv}


def banded_pstate(state) -> "_banded.PrecondState":
    """The PrecondState in a banded state (or in a static state)."""
    return _banded.PrecondState(Lc_inv=state["Lc_inv"],
                                chain_dp=state["dp"], chain_l=state["l"])


def banded_carried(pstate: "_banded.PrecondState"):
    """A carried PrecondState by the banded state's names."""
    return {"Lc_inv": pstate.Lc_inv, "dp": pstate.chain_dp,
            "l": pstate.chain_l}


def twogrid_route(op: GraphOperator) -> Route:
    """The matrix-free route: the ELL weight table and ||L(w)||_inf, and
    twogrid_level (K3/K3b, the coarse operator, its Cholesky); over a state
    the ELL product (ops.laplacian.EllProduct, kernel K8) and the two-grid
    V-cycle (ops.twogrid.EllVCycle: K1p, K8, K7) over its chain factor,
    decoupled every 1024 rows past TRIDIAG_SCAN_MAX_N nodes as
    tridiag_ldl_auto factors it. State: twogrid_state."""
    ref = weakref.ref(op)  # the operator holds this Route: no cycle
    seg = None if op.n <= TRIDIAG_SCAN_MAX_N else 1024

    def prepare(s, branch, guards):
        op, w = ref(), s["w"]
        w_tbl = lap_weight_table(op, w)
        fac, Lc_inv = _twogrid.twogrid_level(op, w, guards=guards)
        return twogrid_state(w_tbl, fac, Lc_inv), lap_inf_norm(op, w)

    def build(state):
        apply_L = ell_applier(ref(), state["w_tbl"])
        fac = TridiagFactor(dp=state["dp"], l=state["l"], seg=seg)
        return apply_L, _twogrid.twogrid_cycle(ref(), fac, state["Lc_inv"],
                                               apply_L)

    return _cached(op, ("twogrid",), lambda: Route(
        prepare, build,
        lambda: (ref().slot_eid, ref().slot_nbr, ref().slot_count,
                 ref().ident32),
        ("w_tbl", "dp", "l", "Lc_inv")))


def twogrid_state(w_tbl: torch.Tensor, fac: TridiagFactor,
                  Lc_inv: torch.Tensor):
    """The matrix-free route's state at one weight vector: the ELL weight
    table, the chain factor and the coarse inverse."""
    return {"w_tbl": w_tbl, "dp": fac.dp, "l": fac.l, "Lc_inv": Lc_inv}

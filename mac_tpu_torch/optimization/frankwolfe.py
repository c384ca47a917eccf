"""Frank-Wolfe for maximising concave functions over simple feasible sets
(PyTorch counterpart of mac_tpu.optimization.frankwolfe):
frank_wolfe_with_state threads auxiliary state across steps, frank_wolfe is
the stateless form with the reference library's call signature, and
frank_wolfe_lanes runs R problems as lanes of one loop (the budget sweep).
_frank_wolfe_on_device is frank_wolfe_with_state's loop for MAC's problem
with its step's bookkeeping in kernels K9 and K10 (ops.kernels.fw) and its
stop test kept on the device, as the reference's lax.while_loop keeps it.

Termination semantics match the reference: when a tolerance check fires the
candidate iterate is not stepped, so the returned x is the one at which
(f, grad) was evaluated.
"""

from typing import Callable, Optional

import torch


def naive_stepsize(k) -> float:
    """Classic 2/(k+2) open-loop step size."""
    return 2.0 / (k + 2.0)


def frank_wolfe_with_state(
    initial: torch.Tensor,
    state0,
    problem: Callable,
    solve_lp: Callable,
    stepsize: Optional[Callable] = None,
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    verbose: bool = False,
    tail_average_from: Optional[int] = None,
    agree: Callable = bool,
):
    """Maximise a concave f via Frank-Wolfe.

    problem(x, state) -> (f, gradf, state'): objective, supergradient and
        updated auxiliary state (warm-start data).
    solve_lp(gradf) -> s: LP oracle over the feasible set.
    stepsize(x, gradf, s, k) -> gamma in [0, 1] at step k (from 0);
        naive_stepsize(k) = 2/(k+2) when None.
    relative_duality_gap_tol <= 0 disables the duality-gap stop (a noisy
        objective makes the accumulated bound fire spuriously).
    tail_average_from: when set, return the mean of the iterates evaluated
        from that step index on (Cesaro tail average).
    verbose: print f and the duality gap at every step.
    agree: reads "keep going" on the host, bool by default; on a mesh the
        group's agreement (parallel.mesh.MeshGroup.agree), so that every
        rank stops at the same step.

    Returns (x, u, state, num_iters) with u the running dual upper bound.
    """
    x = initial
    dtype = x.dtype
    u = torch.tensor(float("inf"), dtype=dtype, device=x.device)
    averaging = tail_average_from is not None
    xavg = torch.zeros_like(x) if averaging else x
    cnt = 0
    state = state0
    it = 0
    while it < maxiter:
        f, gradf, state = problem(x, state)
        s = solve_lp(gradf)
        u = torch.minimum(u, f + gradf @ (s - x))
        if verbose:
            print(f"FW iter {it}: f = {float(f)}, gap = {float(u - f)}")
        # Scale-aware gradient stop: min(1, |f|) keeps normal-scale graphs
        # at the reference's absolute test.
        small_grad = (torch.linalg.vector_norm(gradf)
                      < grad_norm_tol * torch.clamp(f.abs(), max=1.0))
        stop = small_grad
        if relative_duality_gap_tol > 0:
            stop = stop | ((u - f) < relative_duality_gap_tol * f.abs())
        if averaging and it >= tail_average_from:
            cnt += 1
            xavg = xavg + (x - xavg) / float(cnt)
        it += 1
        if not agree(~stop):
            break
        gamma = (naive_stepsize(it - 1) if stepsize is None
                 else stepsize(x, gradf, s, it - 1))
        gamma = torch.as_tensor(gamma, dtype=dtype, device=x.device)
        x = x + gamma * (s - x)
    if averaging and cnt > 0:
        x = xavg
    return x, u, state, it


def _frank_wolfe_on_device(initial: torch.Tensor, state0, problem: Callable,
                           ends: torch.Tensor, w_cand: torch.Tensor, k: int,
                           w_out: torch.Tensor, done: torch.Tensor, *,
                           maxiter: int, relative_duality_gap_tol: float,
                           grad_norm_tol: float, mask_tol: float,
                           tail_average_from: Optional[int] = None):
    """frank_wolfe_with_state's loop for a supergradient w_cand (v_i -
    v_j)^2 over the edges `ends` (int32 (m, 2)) and the top-k LP oracle,
    with each step's bookkeeping on x's device and no host read of its
    own: K9 (fw_oracle) takes the supergradient and the oracle, K10
    (fw_update) the bound, the stop tests, the tail average, the step and
    the next weights, in place. The same steps and results as
    frank_wolfe_with_state(initial, state0, ..., solve_subset_box_lp(., k))
    on the same problem.

    problem(x, state) -> (f, V, state'): f a 0-dim tensor, V the block
        whose column 0 is v. Its eigensolve reads its weights from w_out,
        whose last m entries each step sets to where(x > mask_tol, x, 0)
        w_cand (written for `initial` first). The flag
        `done` (0-dim bool on the device) is set by a step whose test
        fired; problem reads it with what it reads of its own solve and
        then returns (None, None, state_k), state_k the state as that
        stopped step left it, its own work leaving no trace.
    Returns (x, u, state, num_iters) as frank_wolfe_with_state."""
    # Imported here: ops.kernels.fw imports this module (naive_stepsize).
    from mac_tpu_torch.ops.kernels import fw as _fw

    x = initial.clone(memory_format=torch.contiguous_format)
    m = x.shape[0]
    w_new = w_out[w_out.shape[0] - m:]
    w_new.copy_(torch.where(x > mask_tol, x, torch.zeros_like(x)) * w_cand)
    u = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    xavg = torch.zeros_like(x)
    counters = torch.zeros(2, dtype=torch.int32, device=x.device)
    done.fill_(False)
    state = state0
    it = 0
    while it < maxiter:
        f, V, state = problem(x, state)
        if f is None:
            break
        g, s = _fw.fw_oracle(V, ends, w_cand, k)
        _fw.fw_update(f, g, s, x, u, xavg, counters, done, w_new, w_cand,
                      grad_norm_tol=grad_norm_tol,
                      gap_tol=relative_duality_gap_tol,
                      tail_from=tail_average_from, mask_tol=mask_tol)
        it += 1
    if tail_average_from is not None and it > tail_average_from:
        x = xavg
    return x, u, state, it


def frank_wolfe_lanes(
    initial: torch.Tensor,
    state0,
    problem: Callable,
    solve_lp: Callable,
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    tail_average_from: Optional[int] = None,
    agree: Callable = bool,
):
    """frank_wolfe_with_state for R lanes at once, as a vmap of the JAX
    package's loop computes them: x (R, m); problem(x, state, it) -> (f (R,),
    grad (R, m), state'), called with the loop's step index it (the step of
    every lane still running); solve_lp(grad) -> s (R, m).

    Each lane has its own dual bound, gradient and duality-gap stop tests,
    Cesaro tail average and step count. A lane whose test fired is frozen:
    its x, u and average are no longer updated, though problem() still
    sees it (the state it returns is not frozen; a caller that reads it
    for a stopped lane freezes it itself). The loop ends when every lane
    has stopped or after maxiter steps; the stop flags are read from the
    device once per step (through `agree`, as in frank_wolfe_with_state).
    Returns (x, u (R,), state, iterations (R,))."""
    x = initial
    R = x.shape[0]
    dtype, dev = x.dtype, x.device
    u = torch.full((R,), float("inf"), dtype=dtype, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    iters = torch.zeros(R, dtype=torch.int64, device=dev)
    averaging = tail_average_from is not None
    xavg = torch.zeros_like(x) if averaging else x
    cnt = torch.zeros(R, dtype=dtype, device=dev)
    state = state0
    for it in range(int(maxiter)):
        active = ~done
        f, gradf, state = problem(x, state, it)
        s = solve_lp(gradf)
        u = torch.where(active, torch.minimum(
            u, f + (gradf * (s - x)).sum(dim=-1)), u)
        stop = (torch.linalg.vector_norm(gradf, dim=-1)
                < grad_norm_tol * torch.clamp(f.abs(), max=1.0))
        if relative_duality_gap_tol > 0:
            stop = stop | ((u - f) < relative_duality_gap_tol * f.abs())
        if averaging and it >= tail_average_from:
            cnt = cnt + active.to(dtype)
            step = (x - xavg) / torch.clamp(cnt, min=1.0)[:, None]
            xavg = torch.where(active[:, None], xavg + step, xavg)
        iters = iters + active.to(iters.dtype)
        move = active & ~stop
        gamma = torch.as_tensor(naive_stepsize(it), dtype=dtype, device=dev)
        x = torch.where(move[:, None], x + gamma * (s - x), x)
        done = done | stop
        if not agree(~done.all()):
            break
    if averaging:
        x = torch.where((cnt > 0)[:, None], xavg, x)
    return x, u, state, iters


def frank_wolfe(
    initial,
    problem: Callable,
    solve_lp: Callable,
    stepsize: Optional[Callable] = None,
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    verbose: bool = False,
):
    """Stateless Frank-Wolfe: problem(x) -> (f, gradf). `initial` (a tensor
    or an array) is taken in float64 unless it is a floating tensor.
    Returns (x, u)."""
    x0 = initial if (isinstance(initial, torch.Tensor)
                     and initial.is_floating_point()) \
        else torch.as_tensor(initial, dtype=torch.float64)

    def problem_s(x, state):
        f, g = problem(x)
        return f, g, state

    x, u, _, _ = frank_wolfe_with_state(
        x0, None, problem_s, solve_lp, maxiter=maxiter,
        relative_duality_gap_tol=relative_duality_gap_tol,
        grad_norm_tol=grad_norm_tol, verbose=verbose, stepsize=stepsize)
    return x, u

"""Frank-Wolfe for maximising concave functions over simple feasible sets
(PyTorch counterpart of mac_tpu.optimization.frankwolfe):
frank_wolfe_with_state threads auxiliary state across steps, frank_wolfe is
the stateless form with the reference library's call signature, and
frank_wolfe_lanes runs R problems as lanes of one loop (the budget sweep).

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

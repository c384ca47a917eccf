"""Frank-Wolfe for maximising concave functions over simple feasible sets
(PyTorch counterpart of mac_tpu.optimization.frankwolfe):
frank_wolfe_with_state threads auxiliary state across steps, frank_wolfe is
the stateless form with the reference library's call signature.

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
    maxiter: int = 50,
    relative_duality_gap_tol: float = 1e-5,
    grad_norm_tol: float = 1e-10,
    tail_average_from: Optional[int] = None,
    verbose: bool = False,
    stepsize: Optional[Callable] = None,
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
        if bool(stop):
            break
        gamma = (naive_stepsize(it - 1) if stepsize is None
                 else stepsize(x, gradf, s, it - 1))
        gamma = torch.as_tensor(gamma, dtype=dtype, device=x.device)
        x = x + gamma * (s - x)
    if averaging and cnt > 0:
        x = xavg
    return x, u, state, it


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

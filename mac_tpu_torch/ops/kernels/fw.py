"""Kernels K9 and K10: the body of a Frank-Wolfe step after its eigensolve
(csrc/fw.cu).

Stand for no Pallas kernel: the reference's loop body, which XLA compiles
into the one program of its lax.while_loop (mac_tpu/optimization/
frankwolfe.py:93-137, with the supergradient of mac_tpu/solvers/mac.py:
1465-1468 and the top-k oracle of mac_tpu/optimization/constraints.py:20).

  `fw_oracle(V, ends, w_cand, k)` -> (g, s): K9, the supergradient
        g = (w_cand d) d, d = v[ends[:, 0]] - v[ends[:, 1]] with v = V[:, 0]
        (V the Ritz block (n, q), ends the candidates' int32 endpoints
        (m, 2)), and s the indicator of the top-k entries of g, ties to the
        lower index (solve_subset_box_lp); 1 <= k <= m;
  `fw_update(f, g, s, x, u, xavg, counters, done, w, w_cand, ...)`: K10,
        the rest of frank_wolfe_with_state's step, in place: u = min(u, f +
        g . (s - x)); stop = ||g|| < grad_norm_tol min(|f|, 1), or the gap
        test (u - f) < gap_tol |f| when gap_tol > 0; from step tail_from on
        (counters = [it, cnt], int32) the tail average xavg += (x - xavg) /
        cnt; x += gamma (s - x) unless stop, gamma = naive_stepsize(it) in
        x's type; it += 1; done |= stop; and w = where(x > mask_tol, x, 0)
        w_cand, the candidates' part of the next eigensolve's weights.

Each wrapper launches its kernel for CUDA tensors (float32 or float64) and
runs its plain PyTorch version (`*_plain`, the host loop's own operations)
for CPU tensors, and counts its launches as the other kernels' wrappers do
(`.launches`, `.launches_by_lanes`, `.launches_by_dtype`). On the card g,
s, x, xavg and w are bitwise the plain version's; u and ||g|| (hence the
stop test) agree to rounding, since the plain version's dot and norm are
cuBLAS's and PyTorch's reductions and the kernel's are its own fixed-order
sums in double.
"""

import ctypes

import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)
from mac_tpu_torch.optimization.constraints import solve_subset_box_lp
from mac_tpu_torch.optimization.frankwolfe import naive_stepsize

# The one block's threads of both kernels (csrc/fw.cu's kThreads).
THREADS = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {}
for _s in SUFFIX.values():
    # The last pointer of each is the stream.
    _SIGNATURES[f"fw_oracle_{_s}"] = [_P, _I, _P, _P, _I, _I, _P, _P, _P]
    _SIGNATURES[f"fw_update_{_s}"] = ([_P] * 10 + [_I, _D, _D, _I, _D]
                                      + [_P] * 2)


def _call(fn: str, dtype, device, *args) -> None:
    call = _build.function("fw", f"{fn}_{SUFFIX[dtype]}", _SIGNATURES)
    err = _build.launch(call, device, *args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")


def _on_card(name: str, first: torch.Tensor, *arrays) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain): one
    device, the floating arrays of first's type (float32 or float64),
    every array contiguous."""
    if any(a.device != first.device for a in arrays):
        raise ValueError(f"{name}: tensors on different devices")
    if first.dtype not in SUFFIX:
        raise TypeError(f"{name} takes float32 or float64, not "
                        f"{first.dtype}")
    if any(a.is_floating_point() and a.dtype != first.dtype
           for a in arrays):
        raise TypeError(f"{name}: arrays of different types")
    if any(not a.is_contiguous() for a in (first, *arrays)):
        raise ValueError(f"{name}: an array is not contiguous")
    return first.is_cuda


def fw_oracle_plain(V, ends, w_cand, k):
    """Plain version of fw_oracle: the gradient as MAC's host loop takes
    it, then solve_subset_box_lp."""
    v = V[:, 0]
    d = v[ends[:, 0]] - v[ends[:, 1]]
    g = w_cand * d * d
    return g, solve_subset_box_lp(g, k)


def fw_oracle(V: torch.Tensor, ends: torch.Tensor, w_cand: torch.Tensor,
              k: int):
    """K9 (see the module docstring): (g, s), each (m,) in V's type."""
    k = int(k)
    m = w_cand.shape[0] if w_cand.dim() == 1 else -1
    if V.dim() != 2 or m < 0 or tuple(ends.shape) != (m, 2):
        raise ValueError(f"fw_oracle: V (n, q), ends (m, 2) and w_cand "
                         f"(m,), got {tuple(V.shape)}, {tuple(ends.shape)}, "
                         f"{tuple(w_cand.shape)}")
    if ends.dtype != torch.int32:
        raise TypeError(f"fw_oracle: ends must be int32, not {ends.dtype}")
    if not 1 <= k <= m:
        raise ValueError(f"fw_oracle: k = {k} outside 1..{m}")
    if not _on_card("fw_oracle", V, ends, w_cand):
        return fw_oracle_plain(V, ends, w_cand, k)
    g, s = torch.empty_like(w_cand), torch.empty_like(w_cand)
    _call("fw_oracle", V.dtype, V.device, V.data_ptr(), V.shape[1],
          ends.data_ptr(), w_cand.data_ptr(), m, k, g.data_ptr(),
          s.data_ptr())
    count_launch(fw_oracle, 1, V.dtype)
    return g, s


def fw_update_plain(f, g, s, x, u, xavg, counters, done, w, w_cand, *,
                    grad_norm_tol, gap_tol, tail_from, mask_tol,
                    norm=None) -> None:
    """Plain version of fw_update: the operations of
    frank_wolfe_with_state's step and of MAC's weights, in place."""
    u.copy_(torch.minimum(u, f + g @ (s - x)))
    gnorm = torch.linalg.vector_norm(g)
    if norm is not None:
        norm.copy_(gnorm)
    stop = gnorm < grad_norm_tol * torch.clamp(f.abs(), max=1.0)
    if gap_tol > 0:
        stop = stop | ((u - f) < gap_tol * f.abs())
    it, cnt = counters.tolist()
    if tail_from is not None and it >= tail_from:
        cnt += 1
        xavg.copy_(xavg + (x - xavg) / float(cnt))
    gamma = torch.as_tensor(naive_stepsize(it), dtype=x.dtype,
                            device=x.device)
    x.copy_(torch.where(stop, x, x + gamma * (s - x)))
    counters.copy_(torch.tensor([it + 1, cnt], dtype=counters.dtype))
    done.copy_(done | stop)
    w.copy_(torch.where(x > mask_tol, x, torch.zeros_like(x)) * w_cand)


def fw_update(f: torch.Tensor, g: torch.Tensor, s: torch.Tensor,
              x: torch.Tensor, u: torch.Tensor, xavg: torch.Tensor,
              counters: torch.Tensor, done: torch.Tensor, w: torch.Tensor,
              w_cand: torch.Tensor, *, grad_norm_tol: float,
              gap_tol: float, tail_from=None, mask_tol: float,
              norm=None) -> None:
    """K10 (see the module docstring), in place on x, u, xavg, counters,
    done and w. f, u: 0-dim; g, s, x, xavg, w, w_cand: (m,); counters:
    int32 [it, cnt]; done: a 0-dim bool; tail_from None for no average;
    norm: None, or a 0-dim tensor that receives ||g|| (a check's)."""
    m = x.shape[0] if x.dim() == 1 else -1
    if (m < 0 or any(tuple(a.shape) != (m,) for a in (g, s, xavg, w,
                                                      w_cand))
            or f.dim() or u.dim() or done.dim()
            or (norm is not None and norm.dim())):
        raise ValueError("fw_update: f, u and done 0-dim, the others (m,)")
    if (counters.dtype != torch.int32 or tuple(counters.shape) != (2,)
            or done.dtype != torch.bool):
        raise TypeError("fw_update: counters int32 (2,), done bool")
    extra = () if norm is None else (norm,)
    if not _on_card("fw_update", x, f, g, s, u, xavg, counters, done, w,
                    w_cand, *extra):
        return fw_update_plain(f, g, s, x, u, xavg, counters, done, w,
                               w_cand, grad_norm_tol=grad_norm_tol,
                               gap_tol=gap_tol, tail_from=tail_from,
                               mask_tol=mask_tol, norm=norm)
    _call("fw_update", x.dtype, x.device, f.data_ptr(), g.data_ptr(),
          s.data_ptr(), x.data_ptr(), u.data_ptr(), xavg.data_ptr(),
          counters.data_ptr(), done.data_ptr(), w.data_ptr(),
          w_cand.data_ptr(), m, float(grad_norm_tol), float(gap_tol),
          -1 if tail_from is None else int(tail_from), float(mask_tol),
          0 if norm is None else norm.data_ptr())
    count_launch(fw_update, 1, x.dtype)


reset_counts(fw_oracle, fw_update)

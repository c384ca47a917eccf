"""Kernels K3 and K3b: the tridiagonal LDL^T factorisation (csrc/ldl.cu).

Factors the SPD tridiagonal matrix with diagonal d (n,) and off-diagonal e
(n - 1,) as L diag(dp) L^T, L unit lower bidiagonal with subdiagonal l
(l[0] = 0), in float64 whatever the dtype of d and e, the result in their
dtype, the pivots floored at 8 eps max(d):

  K3  `tridiag_ldl`: the exact factor (the JAX package's
      jax.lax.associative_scan of projective maps, mac_tpu/ops/tridiag.py);
  K3b `tridiag_ldl_blocked`: the segment-decoupled factor, each `block`-row
      segment factored on its own (the JAX package's rolled jax.lax.scan of
      length `block`).

Both also take R lanes in one call: d (R, n) and e (R, n - 1), one factor
per lane, dp and l (R, n).

Each wrapper launches its CUDA kernel for tensors on a CUDA device (float32
or float64, d and e of one dtype, rows contiguous: a lane stride of 0, one
chain shared by every lane, is taken as it is) and runs its plain PyTorch
version (`*_plain`) for tensors on the CPU, and counts its launches in
`.launches`, `.launches_by_lanes` and `.launches_by_dtype`, as the solve
kernels' wrappers do (mac_tpu_torch.ops.kernels.tridiag).

Two entry points measure the kernels on the card and are not counted:
`phases` runs K3 or K3b in the build that stamps its phases with
clock64(), and `step_probe` runs each kernel's dependent chain alone on
one thread (K3b's pivot step, K3's carry step), whose step times the
chain's length bound the kernel's time.
"""

import ctypes

import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)


def _mobius_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b @ a for stacks of projective 2x2 maps, normalised by the largest
    entry (b follows a in sequence order)."""
    m = b @ a
    scale = m.abs().amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return m / scale


def tridiag_ldl_plain(d: torch.Tensor, e: torch.Tensor):
    """Plain PyTorch version of K3: (dp, l) of the exact factor by a
    float64 doubling scan of the projective maps x -> d_i - e_{i-1}^2 / x
    (mac_tpu.ops.tridiag.tridiag_ldl); log2(n) stages."""
    out_dtype = d.dtype
    d = d.double()
    e = e.double()
    zero = torch.zeros((*d.shape[:-1], 1), dtype=d.dtype, device=d.device)
    e2 = torch.cat([zero, e * e], dim=-1)  # e2[i] = e_{i-1}^2
    # x_i = d_i - e2_i / x_{i-1} as [[d_i, -e2_i], [1, 0]] acting projectively.
    M = torch.stack([torch.stack([d, -e2], dim=-1),
                     torch.stack([torch.ones_like(d), torch.zeros_like(d)],
                                 dim=-1)], dim=-2)  # (..., n, 2, 2)
    n = d.shape[-1]
    k = 1
    while k < n:
        M = torch.cat([M[..., :k, :, :],
                       _mobius_combine(M[..., :-k, :, :], M[..., k:, :, :])],
                      dim=-3)
        k *= 2
    dp = M[..., 0, 0] / M[..., 1, 0]
    floor = 8 * torch.finfo(out_dtype).eps * d.amax(dim=-1, keepdim=True)
    dp = torch.maximum(dp, floor)
    l = torch.cat([zero, e / dp[..., :-1]], dim=-1)
    return dp.to(out_dtype), l.to(out_dtype)


def tridiag_ldl_blocked_plain(d: torch.Tensor, e: torch.Tensor,
                              block: int = 1024):
    """Plain PyTorch version of K3b: (dp, l) of the segment-decoupled
    factor (mac_tpu.ops.tridiag.tridiag_ldl_blocked): d padded with ones to
    a multiple of `block`, e_{i-1}^2 zero at every segment start, then a
    `block`-step float64 recurrence over every lane's segments at once,
    each starting from 1.0; the pivots floored after it; l_i = e_{i-1} /
    dp_{i-1}, zero at every segment start."""
    out_dtype = d.dtype
    dev = d.device
    lead, n = d.shape[:-1], d.shape[-1]
    nb = -(-n // block)
    n_pad = nb * block
    f64 = torch.float64
    d64 = torch.cat([d, torch.ones((*lead, n_pad - n), dtype=d.dtype,
                                   device=dev)], dim=-1).to(f64)
    e2 = torch.cat([torch.zeros((*lead, 1), dtype=f64, device=dev),
                    (e * e).to(f64),
                    torch.zeros((*lead, n_pad - n), dtype=f64, device=dev)],
                   dim=-1)
    pos = torch.arange(n_pad, device=dev) % block
    e2 = torch.where(pos == 0, torch.zeros_like(e2), e2)
    dB = d64.reshape(*lead, nb, block)
    eB = e2.reshape(*lead, nb, block)
    prev = torch.ones((*lead, nb), dtype=f64, device=dev)
    cols = []
    for i in range(block):  # every lane's segments in each step
        prev = dB[..., i] - eB[..., i] / prev
        cols.append(prev)
    dp = torch.stack(cols, dim=-1).reshape(*lead, n_pad)[..., :n]
    floor = 8 * torch.finfo(out_dtype).eps * d.to(f64).amax(dim=-1,
                                                            keepdim=True)
    dp = torch.maximum(dp, floor)
    e64 = e.to(f64)
    if n > 1:
        cut = (torch.arange(1, n, device=dev) % block) == 0
        e64 = torch.where(cut, torch.zeros_like(e64), e64)
    l = torch.cat([torch.zeros((*lead, 1), dtype=f64, device=dev),
                   e64 / dp[..., :-1]], dim=-1)
    return dp.to(out_dtype), l.to(out_dtype)


_K3_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_longlong]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    f"{fn}_{suffix}": args
    for fn, args in (
        ("tridiag_ldl", _K3_ARGS + [_PTR]),
        ("tridiag_ldl_blocked", _K3_ARGS + [_INT, _PTR]),
        ("tridiag_ldl_phases", _K3_ARGS + [_PTR, _PTR]),
        ("tridiag_ldl_blocked_phases", _K3_ARGS + [_INT, _PTR, _PTR]),
        ("tridiag_ldl_step_probe", [_PTR, _INT, _INT, ctypes.c_double,
                                    ctypes.c_double, _PTR]))
    for suffix in SUFFIX.values()}


def _on_card(name: str, d: torch.Tensor, e: torch.Tensor) -> bool:
    """Check the arguments; True when they lie on a CUDA device (launch the
    kernel), False when they lie on the CPU (run the plain version)."""
    n = d.shape[-1] if d.dim() in (1, 2) else 0
    if (n < 1 or e.dim() != d.dim() or e.shape[:-1] != d.shape[:-1]
            or e.shape[-1] != n - 1):
        raise ValueError(f"{name}: want d (n,) and e (n - 1,), or d (R, n) "
                         f"and e (R, n - 1), n >= 1; got {tuple(d.shape)}, "
                         f"{tuple(e.shape)}")
    if not d.is_cuda:
        if e.is_cuda:
            raise ValueError(f"{name}: tensors on different devices")
        return False
    if e.device != d.device:
        raise ValueError(f"{name}: tensors on different devices")
    check_kernel_args(name, d, e)
    return True


def check_kernel_args(name: str, d: torch.Tensor, e: torch.Tensor) -> None:
    """What the kernels take beyond the shapes: one dtype, float32 or
    float64, for d and e; each chain's rows contiguous (any lane stride);
    at least one lane; n and the lane offsets within the kernels' int and
    long long indices."""
    if d.dtype not in SUFFIX or e.dtype != d.dtype:
        arg, t = (("d", d) if d.dtype not in SUFFIX else ("e", e))
        raise TypeError(f"{name} kernel takes float32 or float64, the same "
                        f"for d and e; {arg} is {t.dtype} (d {d.dtype})")
    for arg, t in (("d", d), ("e", e)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} kernel: {arg} not contiguous along the "
                             "chain")
    if d.dim() == 2 and d.shape[0] < 1:
        raise ValueError(f"{name} kernel: no lanes")
    if d.shape[-1] >= 2 ** 31:
        raise ValueError(f"{name} kernel: n = {d.shape[-1]} past int32")


def _launch(fn: str, d, e, *extra):
    """Call the exported C function `fn` on d's device and PyTorch's current
    stream there; (dp, l), or an error for a non-zero cudaError_t."""
    call = _build.function("ldl", fn, _SIGNATURES)
    dp = torch.empty(d.shape, dtype=d.dtype, device=d.device)
    l = torch.empty_like(dp)
    lanes = d.shape[0] if d.dim() == 2 else 1
    dstride = d.stride(0) if d.dim() == 2 else 0
    estride = e.stride(0) if e.dim() == 2 else 0
    err = _build.launch(call, d.device, d.data_ptr(), e.data_ptr(),
                        dp.data_ptr(), l.data_ptr(), d.shape[-1], lanes,
                        dstride, estride, *extra)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    return dp, l


def phases(d: torch.Tensor, e: torch.Tensor, block=None):
    """One launch of K3 (block None) or K3b on CUDA tensors, in the build
    that stamps its phases: (dp, l, clk), clk (16,) int64 on the card with
    the first block's clock64() durations (clk[0] their count, clk[1:1 +
    clk[0]] the durations as csrc/ldl.cu names them, clk[14] the kernel's
    cycles, clk[15] its nanoseconds). Not counted as a launch: it
    measures, the paths never call it."""
    name = "tridiag_ldl" if block is None else "tridiag_ldl_blocked"
    if not _on_card(name, d, e):
        raise ValueError(f"{name}: the phase stamps need CUDA tensors")
    clk = torch.zeros(16, dtype=torch.int64, device=d.device)
    extra = () if block is None else (min(int(block), 2 ** 31 - 1),)
    dp, l = _launch(f"{name}_phases_{SUFFIX[d.dtype]}", d, e, *extra,
                    clk.data_ptr())
    return dp, l, clk


def step_probe(dtype, steps: int, which: int, out: torch.Tensor):
    """The chains alone on one thread (csrc/ldl.cu's step probe): K3b's
    pivot step (which 0) or K3's carry step (which 1), `steps` times, on
    operands (2.5, 1.0) that keep them in the normal range, in the
    instantiation of dtype's kernels; out, (2,) float64 on the card,
    receives the chain's last value and the loop's clock64() cycles. Not
    counted as a launch."""
    if not out.is_cuda:
        raise ValueError("tridiag_ldl_step_probe: the probe needs a CUDA "
                         "tensor")
    call = _build.function("ldl", f"tridiag_ldl_step_probe_{SUFFIX[dtype]}",
                           _SIGNATURES)
    err = _build.launch(call, out.device, out.data_ptr(), int(steps),
                        int(which), 2.5, 1.0)
    if err != 0:
        raise RuntimeError(f"tridiag_ldl_step_probe failed: cudaError {err}")


def tridiag_ldl(d: torch.Tensor, e: torch.Tensor):
    """K3: (dp, l) of the exact LDL^T factor, of one chain or of R lanes
    (see the module docstring). CUDA tensors: the hand-written kernel (one
    launch); CPU tensors: the plain version."""
    if not _on_card("tridiag_ldl", d, e):
        return tridiag_ldl_plain(d, e)
    out = _launch(f"tridiag_ldl_{SUFFIX[d.dtype]}", d, e)
    count_launch(tridiag_ldl, d.shape[0] if d.dim() == 2 else 1, d.dtype)
    return out


def tridiag_ldl_blocked(d: torch.Tensor, e: torch.Tensor, block: int = 1024):
    """K3b: (dp, l) of the factor decoupled into segments of `block` rows,
    of one chain or of R lanes. CUDA tensors: the hand-written kernel,
    bitwise equal to the plain version (one launch); CPU tensors: the
    plain version."""
    if int(block) < 1:
        raise ValueError(f"tridiag_ldl_blocked: block {block} < 1")
    if not _on_card("tridiag_ldl_blocked", d, e):
        return tridiag_ldl_blocked_plain(d, e, int(block))
    out = _launch(f"tridiag_ldl_blocked_{SUFFIX[d.dtype]}", d, e,
                  min(int(block), 2 ** 31 - 1))
    count_launch(tridiag_ldl_blocked, d.shape[0] if d.dim() == 2 else 1,
                 d.dtype)
    return out


reset_counts(tridiag_ldl, tridiag_ldl_blocked)

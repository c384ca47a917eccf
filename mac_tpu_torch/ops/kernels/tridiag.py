"""Kernel K1: the tridiagonal LDL^T solve (csrc/tridiag.cu).

Solves L diag(dp) L^T X = B with L unit lower bidiagonal (subdiagonal l),
for dp, l of shape (n,) and B of shape (n, q) -- the contract of the TPU
kernel it replaces, mac_tpu/ops/pallas/tridiag_kernel.py
(_tridiag_kernel via tridiag_solve_fused). `tridiag_solve` launches the
CUDA kernel for tensors on a CUDA device and runs `tridiag_solve_plain`,
its plain PyTorch version, for tensors on the CPU.
"""

import ctypes

import torch


def _scan_affine(coef: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of y_i = coef_i * y_{i-1} + val_i along axis 0 with
    y_{-1} = 0 (coef_0 does not reach the result), by recursive doubling of the
    affine maps: (c2, v2) after (c1, v1) = (c2 c1, v2 + c2 v1)."""
    c, v = coef, val
    n = v.shape[0]
    k = 1
    while k < n:
        v = torch.cat([v[:k], v[k:] + c[k:] * v[:-k]])
        c = torch.cat([c[:k], c[k:] * c[:-k]])
        k *= 2
    return v


def tridiag_solve_plain(dp: torch.Tensor, l: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: forward and backward affine
    scans around the diagonal scale (mac_tpu.ops.tridiag.
    tridiag_solve_factored)."""
    coef = torch.broadcast_to(-l[:, None], B.shape)
    y = _scan_affine(coef, B)
    z = y / dp[:, None]
    # Backward: x_i = z_i - l_{i+1} x_{i+1}, a forward scan of the reversal.
    lr = torch.cat([-l[1:], torch.zeros(1, dtype=l.dtype, device=l.device)])
    coef_r = torch.broadcast_to(lr[:, None], B.shape).flip(0)
    return _scan_affine(coef_r, z.flip(0)).flip(0)


_SIGNATURES = {"tridiag_solve_f32": [ctypes.c_void_p] * 4
               + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


def tridiag_solve(dp: torch.Tensor, l: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """X with L diag(dp) L^T X = B. CUDA tensors: the hand-written kernel
    (float32, contiguous, any n and q); CPU tensors: the plain version."""
    if B.dim() != 2 or dp.shape != (B.shape[0],) or l.shape != dp.shape:
        raise ValueError(f"tridiag_solve: want dp, l (n,) and B (n, q); got "
                         f"{tuple(dp.shape)}, {tuple(l.shape)}, "
                         f"{tuple(B.shape)}")
    if not B.is_cuda:
        if dp.is_cuda or l.is_cuda:
            raise ValueError("tridiag_solve: tensors on different devices")
        return tridiag_solve_plain(dp, l, B)
    if dp.device != B.device or l.device != B.device:
        raise ValueError("tridiag_solve: tensors on different devices")
    for name, t in (("dp", dp), ("l", l), ("B", B)):
        if t.dtype != torch.float32:
            raise TypeError(f"tridiag_solve kernel takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"tridiag_solve kernel: {name} not contiguous")
    from mac_tpu_torch.ops.kernels import _build

    lib = _build.load("tridiag", _SIGNATURES)
    n, q = B.shape
    X = torch.empty_like(B)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = lib.tridiag_solve_f32(dp.data_ptr(), l.data_ptr(), B.data_ptr(),
                                    X.data_ptr(), n, q, stream)
    if err != 0:
        raise RuntimeError(f"tridiag_solve kernel launch failed: cudaError "
                           f"{err}")
    tridiag_solve.launches += 1
    return X


tridiag_solve.launches = 0

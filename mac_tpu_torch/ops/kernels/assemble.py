"""Kernel K2/K2b: the banded Laplacian assembly (csrc/assemble.cu).

Builds the transposed upper block diagonals ut (half+1, nb, BS, BS),
ut[t][b][c][r] = L[BS b + r, BS (b + t) + c], from gathered slot weights --
the contract of the TPU kernels it replaces,
mac_tpu/ops/pallas/assemble_kernel.py (_assemble_kernel via
assemble_ut_fused, and _assemble_kernel_ov via assemble_ut_fused_ov). The
first table form is the second with no overflow entries.

`assemble_ut` launches the CUDA kernel for tensors on a CUDA device (weights
in float32 or float64, one instantiation of the kernel each) and runs
`assemble_ut_plain`, its plain PyTorch version (the sheared iota-compare
accumulation of mac_tpu.ops.banded._assemble_ut_xla), for CPU tensors. It
counts its launches as the tridiagonal wrappers do (`.launches`,
`.launches_by_lanes`, `.launches_by_dtype`).

Both also take R lanes in one call (the budget sweep): wu (R, du, nb*BS)
and ow (R, ov, nb) give ut (R, half+1, nb, BS, BS), lane r's assembly from
lane r's weights; the slot tables dcol, ocol and olane are every lane's.
"""

import ctypes

import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)

BS = 128


def assemble_ut_plain(dcol: torch.Tensor, wu: torch.Tensor,
                      ocol: torch.Tensor, olane: torch.Tensor,
                      ow: torch.Tensor, half: int, nb: int) -> torch.Tensor:
    """Materialise the sheared band Sh^T (W, n_pad), W = BS (half + 2), one
    iota-compare pass per dense slot, then add each overflow entry at its
    (column, lane), then slice the upper block diagonals out of it. Lanes
    (wu 3-d) are assembled one after another."""
    if wu.dim() == 3:
        return torch.stack([assemble_ut_plain(dcol, wu[r], ocol, olane, ow[r],
                                              half, nb)
                            for r in range(wu.shape[0])])
    n_pad = nb * BS
    W = BS * (half + 2)
    rows = torch.arange(W, dtype=dcol.dtype, device=wu.device)[:, None]
    sht = torch.zeros((W, n_pad), dtype=wu.dtype, device=wu.device)
    for k in range(wu.shape[0]):
        sht = sht + wu[k:k + 1, :] * (rows == dcol[k:k + 1, :])
    lanes = torch.arange(nb, device=wu.device) * BS
    for o in range(ow.shape[0]):
        # One entry per block in each table row: no repeated (col, lane).
        cols = ocol[o].long()
        inside = (cols >= 0) & (cols < W)
        sht[cols[inside], (lanes + olane[o].long())[inside]] += ow[o][inside]
    return torch.stack(
        [sht[BS * (t + 1): BS * (t + 2), :].reshape(BS, nb, BS).transpose(0, 1)
         for t in range(half + 1)], dim=0)


_SIGNATURES = {f"assemble_ut_{suffix}": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for suffix in SUFFIX.values()}


def assemble_ut(dcol: torch.Tensor, wu: torch.Tensor, ocol: torch.Tensor,
                olane: torch.Tensor, ow: torch.Tensor, half: int,
                nb: int) -> torch.Tensor:
    """ut (half+1, nb, BS, BS) from dense slot tables dcol/wu (du, nb*BS)
    and overflow tables ocol/olane/ow (ov, nb); ov may be 0. With lanes,
    wu (R, du, nb*BS) and ow (R, ov, nb) give ut (R, half+1, nb, BS, BS)."""
    lead = wu.shape[:1] if wu.dim() == 3 else ()
    lanes = wu.shape[0] if lead else 1
    du, n_pad = wu.shape[-2:]
    ov = ow.shape[-2]
    if (wu.dim() not in (2, 3) or dcol.shape != (du, n_pad)
            or n_pad != nb * BS or ocol.shape != (ov, nb)
            or olane.shape != (ov, nb) or ow.shape != (*lead, ov, nb)):
        raise ValueError(
            f"assemble_ut: want dcol (du, {nb * BS}), wu ([R,] du, "
            f"{nb * BS}), ocol/olane (ov, {nb}) and ow ([R,] ov, {nb}); got "
            f"{tuple(dcol.shape)}, {tuple(wu.shape)}, {tuple(ocol.shape)}, "
            f"{tuple(olane.shape)}, {tuple(ow.shape)}")
    tensors = (("dcol", dcol), ("wu", wu), ("ocol", ocol), ("olane", olane),
               ("ow", ow))
    if not wu.is_cuda:
        if any(t.is_cuda for _, t in tensors):
            raise ValueError("assemble_ut: tensors on different devices")
        return assemble_ut_plain(dcol, wu, ocol, olane, ow, half, nb)
    for name, t in tensors:
        if t.device != wu.device:
            raise ValueError("assemble_ut: tensors on different devices")
    check_kernel_args(tensors)
    call = _build.function("assemble", f"assemble_ut_{SUFFIX[wu.dtype]}",
                           _SIGNATURES)
    ut = torch.empty((*lead, half + 1, nb, BS, BS), dtype=wu.dtype,
                     device=wu.device)
    err = _build.launch(call, wu.device, dcol.data_ptr(), wu.data_ptr(), du,
                        ocol.data_ptr(), olane.data_ptr(), ow.data_ptr(), ov,
                        ut.data_ptr(), half, nb, lanes)
    if err != 0:
        raise RuntimeError(f"assemble_ut kernel launch failed: cudaError "
                           f"{err}")
    count_launch(assemble_ut, lanes, wu.dtype)
    return ut


def check_kernel_args(tensors) -> None:
    """What the kernel takes beyond the shapes: the slot tables as int32,
    the weights wu and ow both float32 or both float64, each contiguous.
    tensors: ((name, tensor), ...) of assemble_ut's arrays."""
    t = dict(tensors)
    if t["wu"].dtype not in SUFFIX or t["ow"].dtype != t["wu"].dtype:
        raise TypeError(f"assemble_ut kernel takes wu and ow as float32 or "
                        f"float64, the same; got {t['wu'].dtype} and "
                        f"{t['ow'].dtype}")
    for name in ("dcol", "ocol", "olane"):
        if t[name].dtype != torch.int32:
            raise TypeError(f"assemble_ut kernel takes {name} as int32; got "
                            f"{t[name].dtype}")
    for name, tensor in tensors:
        if not tensor.is_contiguous():
            raise ValueError(f"assemble_ut kernel: {name} not contiguous")


reset_counts(assemble_ut)

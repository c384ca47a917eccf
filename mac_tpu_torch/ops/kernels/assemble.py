"""Kernel K2/K2b: the banded Laplacian assembly (csrc/assemble.cu).

Builds the transposed upper block diagonals ut (half+1, nb, BS, BS),
ut[t][b][c][r] = L[BS b + r, BS (b + t) + c], from gathered slot weights --
the contract of the TPU kernels it replaces,
mac_tpu/ops/pallas/assemble_kernel.py (_assemble_kernel via
assemble_ut_fused, and _assemble_kernel_ov via assemble_ut_fused_ov). The
first table form is the second with no overflow entries.

`assemble_ut` launches the CUDA kernel for tensors on a CUDA device and runs
`assemble_ut_plain`, its plain PyTorch version (the sheared iota-compare
accumulation of mac_tpu.ops.banded._assemble_ut_xla), for CPU tensors.
"""

import ctypes

import torch

from mac_tpu_torch.ops.kernels import _build

BS = 128


def assemble_ut_plain(dcol: torch.Tensor, wu: torch.Tensor,
                      ocol: torch.Tensor, olane: torch.Tensor,
                      ow: torch.Tensor, half: int, nb: int) -> torch.Tensor:
    """Materialise the sheared band Sh^T (W, n_pad), W = BS (half + 2), one
    iota-compare pass per dense slot, then add each overflow entry at its
    (column, lane), then slice the upper block diagonals out of it."""
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


_SIGNATURES = {"assemble_ut_f32": [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]}


def assemble_ut(dcol: torch.Tensor, wu: torch.Tensor, ocol: torch.Tensor,
                olane: torch.Tensor, ow: torch.Tensor, half: int,
                nb: int) -> torch.Tensor:
    """ut (half+1, nb, BS, BS) from dense slot tables dcol/wu (du, nb*BS)
    and overflow tables ocol/olane/ow (ov, nb); ov may be 0."""
    du, n_pad = wu.shape
    ov = ow.shape[0]
    if (dcol.shape != wu.shape or n_pad != nb * BS
            or ocol.shape != (ov, nb) or olane.shape != (ov, nb)
            or ow.shape != (ov, nb)):
        raise ValueError(
            f"assemble_ut: want dcol/wu (du, {nb * BS}) and ocol/olane/ow "
            f"(ov, {nb}); got {tuple(dcol.shape)}, {tuple(wu.shape)}, "
            f"{tuple(ocol.shape)}, {tuple(olane.shape)}, {tuple(ow.shape)}")
    tensors = (("dcol", dcol), ("wu", wu), ("ocol", ocol), ("olane", olane),
               ("ow", ow))
    if not wu.is_cuda:
        if any(t.is_cuda for _, t in tensors):
            raise ValueError("assemble_ut: tensors on different devices")
        return assemble_ut_plain(dcol, wu, ocol, olane, ow, half, nb)
    for name, t in tensors:
        if t.device != wu.device:
            raise ValueError("assemble_ut: tensors on different devices")
        want = torch.float32 if name in ("wu", "ow") else torch.int32
        if t.dtype != want:
            raise TypeError(f"assemble_ut kernel takes {name} as {want}; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"assemble_ut kernel: {name} not contiguous")
    call = _build.function("assemble", "assemble_ut_f32", _SIGNATURES)
    ut = torch.empty((half + 1, nb, BS, BS), dtype=wu.dtype, device=wu.device)
    err = _build.launch(call, wu.device, dcol.data_ptr(), wu.data_ptr(), du,
                        ocol.data_ptr(), olane.data_ptr(), ow.data_ptr(), ov,
                        ut.data_ptr(), half, nb)
    if err != 0:
        raise RuntimeError(f"assemble_ut kernel launch failed: cudaError "
                           f"{err}")
    assemble_ut.launches += 1
    return ut


assemble_ut.launches = 0

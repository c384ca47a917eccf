"""Kernel K6: the update of TRACEMIN's inner PCG step (csrc/pcg.cu).

Stands for no Pallas kernel: the body of the reference's pcg_fixed
fori_loop (mac_tpu/ops/cg.py:52-62), which XLA fuses; ops.cg.pcg_fixed runs
it through these wrappers on CUDA tensors. Blocks are (n, q), or R lanes
(R, n, q); every column sum is (q,) or (R, q) float64.

  `col_sums(A)`            the column sums of A;
  `col_sums(A, M, msum)`   the column dots of A and M, M centred by its
                           column means msum / n when msum is given;
  `cg_update(X, R, P, AP, rz, pap)`
                           alpha = rz / pap (0 where |pap| <= tiny, in A's
                           type), X += alpha P and R -= alpha AP in place;
                           with sums=True the new R's column sums;
  `cg_direction_dots(P, R, Z, zsum, rz, init)`
                           rz_new = R . Z column by column (Z centred by
                           zsum / n when zsum is given; bitwise
                           col_sums(R, Z, zsum)), beta = rz_new / rz (0
                           where |rz| <= tiny), P = Z + beta P in place (P =
                           Z with init), then rz = rz_new in place; returns
                           (P's new column sums with sums=True, else None;
                           rz_new).

Every sum goes in a fixed order whatever the order in which the kernel's
blocks run and however many there are: the rows are cut into items of ROWS
rows (and groups of 4 columns, and lanes), each item's partial to a buffer,
then the block that takes the last ticket of an atomic counter sums the
partials in a fixed order (the counter is used for nothing else and is left
at 0; one counter per device, `ticket`, which the kernels that take tickets
share on one stream). So a replayed graph is bitwise the eager solve.
`block_sum_model` is a numpy model of that order (the last block's sum a
warp a column: `warp_sum_model`). cg_direction_dots's blocks meet at a grid
barrier on a word of their own (`barrier`) once the dots' partials are
written, then each sums the partials of its columns itself; so it is
launched cooperatively (every block resident at once).

Each wrapper launches its kernel for CUDA tensors (float32 or float64) and
runs its plain PyTorch version (`*_plain`) for CPU tensors, and counts its
launches as the other kernels' wrappers do (`.launches`,
`.launches_by_lanes`, `.launches_by_dtype`).
"""

import ctypes

import numpy as np
import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)

# The threads that sum an item of the kernels (csrc/pcg.cu's kThreads), a
# row each, or two past R2_ITEMS items of one row (kR2Items): rows_of.
THREADS = 128
R2_ITEMS = 160
ROWS = THREADS  # the most partials a column can have: ceil(n / ROWS)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {}
for _s in SUFFIX.values():
    # The last pointer of each is the stream.
    _SIGNATURES[f"pcg_colsum_{_s}"] = [_P, _P, _P, _I, _I, _I] + [_P] * 4
    _SIGNATURES[f"pcg_update_{_s}"] = [_P] * 6 + [_I] * 3 + [_P] * 4
    _SIGNATURES[f"pcg_direction_dots_{_s}"] = ([_P] * 5 + [_I] * 4
                                               + [_P] * 2 + [_I] + [_P] * 3)

_tickets = {}
_barriers = {}


def _word(words: dict, device: torch.device, what: str) -> torch.Tensor:
    t = words.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the kernels' {what} is first needed inside "
                               "a graph capture: run one step before")
        t = words[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def ticket(device: torch.device) -> torch.Tensor:
    """The device's ticket counter (one int32 at 0), made at its first use,
    which must not fall inside a CUDA graph's capture. A wrapper takes it
    before it allocates its scratch, and holds the scratch until its launch
    is queued: memory freed earlier could otherwise become the counter
    while a kernel queued later still writes there."""
    return _word(_tickets, device, "ticket counter")


def barrier(device: torch.device) -> torch.Tensor:
    """The device's grid-barrier word of cg_direction_dots (one int32 at 0,
    whose top bit each launch flips), made at its first use like ticket(),
    and used by nothing else."""
    return _word(_barriers, device, "barrier word")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _shape(A: torch.Tensor):
    """(lanes, n, q) of a block (n, q) or (R, n, q)."""
    if A.dim() == 2:
        return 1, A.shape[0], A.shape[1]
    if A.dim() == 3:
        return A.shape
    raise ValueError(f"K6 takes (n, q) or (R, n, q) blocks, got "
                     f"{tuple(A.shape)}")


def check_args(name: str, *arrays) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain): blocks of
    one shape, dtype (float32 or float64) and device, contiguous; sums
    float64 of the blocks' (lanes, q) size."""
    blocks = [a for a in arrays if a is not None]
    first = blocks[0]
    cuda = first.is_cuda
    if any(a.is_cuda != cuda or a.device != first.device for a in blocks):
        raise ValueError(f"{name}: tensors on different devices")
    if not cuda:
        return False
    if first.dtype not in SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or float64 blocks, "
                        f"not {first.dtype}")
    if any(not a.is_contiguous() for a in blocks):
        raise ValueError(f"{name} kernel: a block is not contiguous")
    return True


def _sums_like(A: torch.Tensor) -> torch.Tensor:
    return torch.empty((*A.shape[:-2], A.shape[-1]), dtype=torch.float64,
                       device=A.device)


def rows_of(n: int, q: int, lanes: int = 1) -> int:
    """The rows of an item of the kernels for blocks (lanes, n, q)
    (csrc/pcg.cu's rows_of): THREADS, or twice that past R2_ITEMS items."""
    items = -(-n // THREADS) * -(-q // 4) * lanes
    return THREADS * (2 if items > R2_ITEMS else 1)


def _part(A: torch.Tensor, sets: int = 1) -> torch.Tensor:
    """Scratch for `sets` sets of the items' column partials of A."""
    lanes, n, q = _shape(A)
    return torch.empty(sets * lanes * q * -(-n // ROWS), dtype=torch.float64,
                       device=A.device)


def _call(fn: str, dtype, device, *args) -> None:
    call = _build.function("pcg", f"{fn}_{SUFFIX[dtype]}", _SIGNATURES)
    err = _build.launch(call, device, *args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")


def _check_sum(name, s, A):
    if s is not None and (s.dtype != torch.float64 or s.device != A.device
                          or s.shape != (*A.shape[:-2], A.shape[-1])):
        raise ValueError(f"{name}: column sums must be float64 of shape "
                         f"{(*A.shape[:-2], A.shape[-1])}, got {s.dtype} "
                         f"{tuple(s.shape)}")


def _mean(msum: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """The means msum / n in dtype, shaped to broadcast over a block."""
    return (msum / n).to(dtype).unsqueeze(-2)


def col_sums_plain(A, M=None, msum=None) -> torch.Tensor:
    """Plain version of col_sums: float64 sums of A, or of A M (M - msum /
    n), the products in A's type."""
    if M is None:
        return A.double().sum(dim=-2)
    if msum is not None:
        M = M - _mean(msum, M.shape[-2], M.dtype)
    return (A * M).double().sum(dim=-2)


def col_sums(A: torch.Tensor, M: torch.Tensor = None,
             msum: torch.Tensor = None) -> torch.Tensor:
    """K6's column sums (see the module docstring): (q,) or (R, q)
    float64."""
    if M is not None and M.shape != A.shape:
        raise ValueError(f"col_sums: A {tuple(A.shape)} and M "
                         f"{tuple(M.shape)} differ")
    _check_sum("col_sums", msum, A)
    if not check_args("col_sums", A, M):
        return col_sums_plain(A, M, msum)
    lanes, n, q = _shape(A)
    tk = ticket(A.device)
    out, part = _sums_like(A), _part(A)  # held until the launch is queued
    _call("pcg_colsum", A.dtype, A.device, A.data_ptr(), _ptr(M), _ptr(msum),
          n, q, lanes, part.data_ptr(), out.data_ptr(), tk.data_ptr())
    count_launch(col_sums, lanes, A.dtype)
    return out


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b where |b| > tiny, else 0: exhausted columns stay inert rather
    than NaN (the kernels' and pcg_fixed's step sizes)."""
    big = b.abs() > torch.finfo(b.dtype).tiny
    return a / torch.where(big, b, torch.ones_like(b)) * big


def cg_update_plain(X, R, P, AP, rz, pap, sums=False):
    """Plain version of cg_update, in place on X and R."""
    alpha = safe_div(rz, pap.to(rz.dtype)).unsqueeze(-2)
    X.copy_(X + alpha * P)
    R.copy_(R - alpha * AP)
    return R.double().sum(dim=-2) if sums else None


def cg_update(X: torch.Tensor, R: torch.Tensor, P: torch.Tensor,
              AP: torch.Tensor, rz: torch.Tensor, pap: torch.Tensor,
              sums: bool = False):
    """K6's first pass (see the module docstring): X and R updated in
    place; R's new column sums (float64) with sums=True, else None. rz:
    (q,) or (R, q) in the blocks' type; pap: float64."""
    for a in (R, P, AP):
        if a.shape != X.shape:
            raise ValueError(f"cg_update: blocks of shapes {tuple(X.shape)} "
                             f"and {tuple(a.shape)}")
    _check_sum("cg_update", pap, X)
    if rz.shape != pap.shape or rz.dtype != X.dtype:
        raise ValueError("cg_update: rz must be of pap's shape and the "
                         "blocks' type")
    if not check_args("cg_update", X, R, P, AP, rz):
        return cg_update_plain(X, R, P, AP, rz, pap, sums)
    lanes, n, q = _shape(X)
    tk = ticket(X.device)
    out = _sums_like(X) if sums else None
    part = _part(X) if sums else None
    _call("pcg_update", X.dtype, X.device, X.data_ptr(), R.data_ptr(),
          P.data_ptr(), AP.data_ptr(), rz.data_ptr(), pap.data_ptr(), n, q,
          lanes, _ptr(part), _ptr(out), tk.data_ptr())
    count_launch(cg_update, lanes, X.dtype)
    return out


def cg_direction_plain(P, Z, zsum, rz, rz_new, init=False, sums=False):
    """The direction step with rz_new given (cg_direction_dots_plain's
    second half), in place on P and rz."""
    if zsum is not None:
        Z = Z - _mean(zsum, Z.shape[-2], Z.dtype)
    new = rz_new.to(rz.dtype)
    if init:
        P.copy_(Z)
    else:
        P.copy_(Z + safe_div(new, rz).unsqueeze(-2) * P)
    rz.copy_(new)
    return P.double().sum(dim=-2) if sums else None


def cg_direction_dots_plain(P, R, Z, zsum, rz, init=False, sums=False):
    """Plain version of cg_direction_dots: col_sums_plain, then
    cg_direction_plain."""
    rz_new = col_sums_plain(R, Z, zsum)
    return cg_direction_plain(P, Z, zsum, rz, rz_new, init, sums), rz_new


def cg_direction_dots(P: torch.Tensor, R: torch.Tensor, Z: torch.Tensor,
                      zsum, rz: torch.Tensor, init: bool = False,
                      sums: bool = False):
    """K6's second pass with the dots (see the module docstring): P and rz
    updated in place; returns (P's new column sums, float64, with
    sums=True, else None; rz_new = R . Z, float64, bitwise col_sums(R, Z,
    zsum)). zsum: Z's column sums (float64) to centre it by, or None."""
    for a in (R, Z):
        if a.shape != P.shape:
            raise ValueError(f"cg_direction_dots: P {tuple(P.shape)} and "
                             f"{tuple(a.shape)} differ")
    _check_sum("cg_direction_dots", zsum, P)
    if rz.shape != (*P.shape[:-2], P.shape[-1]) or rz.dtype != P.dtype:
        raise ValueError("cg_direction_dots: rz must be (lanes, q) in the "
                         "blocks' type")
    if not check_args("cg_direction_dots", P, R, Z, rz):
        return cg_direction_dots_plain(P, R, Z, zsum, rz, init, sums)
    lanes, n, q = _shape(P)
    tk, bar = ticket(P.device), barrier(P.device)
    out = torch.empty((2, *rz.shape), dtype=torch.float64, device=P.device)
    part = _part(P, 2)  # held until the launch is queued
    _call("pcg_direction_dots", P.dtype, P.device, P.data_ptr(),
          R.data_ptr(), Z.data_ptr(), _ptr(zsum), rz.data_ptr(),
          int(bool(init)), n, q, lanes, part.data_ptr(), out.data_ptr(),
          int(bool(sums)), tk.data_ptr(), bar.data_ptr())
    count_launch(cg_direction_dots, lanes, P.dtype)
    return (out[1] if sums else None), out[0]


def warp_sum_model(parts) -> float:
    """The last block's sum of one column's block partials (in numpy
    float64): lane l of a warp sums partials l, l + 32, ... in order, then
    the lanes' sums add in the butterfly the kernel's shuffles make (lane 0:
    at each step its sum plus that of the lane `off` away, off = 16, 8, 4,
    2, 1)."""
    lanes = [0.0] * 32
    for k, v in enumerate(parts):
        lanes[k % 32] += float(v)
    return _butterfly(lanes)


def _butterfly(lanes) -> float:
    """A warp's 32 values added by the kernels' xor butterfly (at each step
    lane i adds the value of lane i ^ off, off = 16, 8, 4, 2, 1): lane 0's
    result (every lane's)."""
    off = 16
    while off:
        lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
        off //= 2
    return lanes[0]


def block_sum_model(values: np.ndarray, rows: int = ROWS,
                    threads: int = THREADS) -> np.ndarray:
    """The kernels' order of a column sum, in numpy float64: values (n, q)
    (already rounded to the block's type; one lane of a block the kernels
    cut into items of `rows` rows, rows_of(n, q, lanes)). Each item:
    thread t adds rows t, t + threads, ... of it in order (from 0.0), each
    warp's 32 threads add by the kernels' xor butterfly (off = 16, 8, 4, 2,
    1), and the warps add in order (from 0.0); then the items' partials add
    as warp_sum_model orders them. Returns (q,)."""
    values = np.asarray(values, dtype=np.float64)
    n, q = values.shape
    out = np.zeros(q)
    for col in range(q):
        parts = []
        for r0 in range(0, n, rows):
            block = values[r0:min(n, r0 + rows), col]
            acc = [0.0] * threads
            for k, v in enumerate(block):
                acc[k % threads] += float(v)
            part = 0.0
            for w in range(0, threads, 32):
                part += _butterfly(acc[w:w + 32])
            parts.append(part)
        out[col] = warp_sum_model(parts)
    return out


reset_counts(col_sums, cg_update, cg_direction_dots)

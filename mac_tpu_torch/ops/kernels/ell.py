"""Kernel K8, the ELL product of the matrix-free route (csrc/ell.cu).

`ell_product(nbr, cnt, w_tbl, V, ...)` stands for the reference's
_ell_apply (mac_tpu/ops/laplacian.py:169-181, a gather and an einsum that
XLA fuses): L(w) V in the difference form (L V)_i = sum_k w_ik (V_i -
V_nbr_ik) over the padded adjacency tables of
ops.laplacian.GraphOperator, held slot-major: the neighbour table nbr
(dmax, n) int32 (`slot_nbr`), each row's filled slots cnt (n,) int32
(`slot_count`; the padding follows them) and the weight table w_tbl
(dmax, n) of ops.laplacian.lap_weight_table, with V (n, q), or R lanes: V
(R, n, q) and w_tbl (R, dmax, n) (the budget sweep's, a table per lane) or
one table (dmax, n) shared by the lanes. The kernel walks each row to its
count; the plain version walks every slot, the padding adding 0, so the
two agree bit for bit on finite V (csrc/ell.cu). Its forms, by keyword,
are K5's (ops.kernels.banded):
  * plain: L V;
  * inner (c, with sigma optional): (L V + (c / n) 1 1^T V) + sigma V, the
    shift's column means in float64 (ops.lobpcg._shift_term); the kernel
    takes V's column sums as `vsum` (float64; the plain version sums V
    itself);
  * residual (B): (B - mean(B)) - y, B centred when `bsum` is given (its
    column sums, float64; the plain version takes B's own mean);
  * dot=True: also the column dots of V and the output, float64, summed in
    a fixed order (returns (out, dot)); dot_model is that order in numpy.

The wrapper launches the kernel for CUDA tensors (float32 or float64, nbr
and cnt int32) and runs its plain PyTorch version (`ell_product_plain`:
the arithmetic of the gather on the (q, n) layout that ops.laplacian ran
before the kernel) for CPU tensors, and counts its launches as the other
kernels' wrappers do (`.launches`, `.launches_by_lanes`,
`.launches_by_dtype`). `occupancy(dtype)` reads the kernel's registers and
resident blocks a SM from the runtime and `grid_blocks` its grid, for the
report of chip_smoke.py's phase 3f.
"""

import ctypes

import numpy as np
import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.banded import _per_lane, one_lane_contiguous
from mac_tpu_torch.ops.kernels.pcg import _ptr, ticket, warp_sum_model
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)

# A block's threads (csrc/ell.cu's kThreads) and a thread's columns (kCols).
THREADS = 128
COLS = 4

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    f"ell_product_{_s}": ([_P, _P, _P, _L, _P, _L, _P, _P, _L, _P, _P, _P,
                           _L, _P, _L, _P, _P, _P] + [_I] * 4 + [_P])
    for _s in SUFFIX.values()}  # the last pointer is the stream
_SIGNATURES.update({f"ell_product_occupancy_{_s}": [
    ctypes.POINTER(_I), ctypes.POINTER(_I)] for _s in SUFFIX.values()})


def rows_per_block(q: int) -> int:
    """The rows of a block of the kernel for q columns: THREADS over the
    column groups of 4 (at most THREADS of them)."""
    return THREADS // min(-(-q // COLS), THREADS)


def dot_partials(n: int, q: int, lanes: int) -> int:
    """The float64 partials the column dots need: one per column and block
    of rows, of each lane."""
    return lanes * q * -(-n // rows_per_block(q))


def grid_blocks(n: int, q: int, lanes: int = 1) -> int:
    """The blocks of the kernel's grid for (lanes, n, q): blocks of
    rows_per_block(q) rows by column tiles of up to 4 * THREADS columns,
    for each lane."""
    groups = -(-q // COLS)
    return (-(-n // rows_per_block(q)) * -(-groups // min(groups, THREADS))
            * lanes)


def occupancy(dtype: torch.dtype, device: torch.device) -> tuple:
    """(registers a thread, resident blocks a SM) of the kernel's dtype
    instantiation on `device`, as the CUDA runtime reports them (no
    launch, no count)."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    call = _build.function("ell", f"ell_product_occupancy_{SUFFIX[dtype]}",
                           _SIGNATURES)
    with torch.cuda.device(device):
        err = call(ctypes.byref(regs), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ell_product occupancy query failed: cudaError "
                           f"{err}")
    return regs.value, blocks.value


def _gather_product(nbr: torch.Tensor, w_tbl: torch.Tensor,
                    V: torch.Tensor) -> torch.Tensor:
    # The gather runs on the (q, n) layout: gathering whole (n, q) rows of
    # q = 4 floats takes a PyTorch kernel with one thread block per row,
    # 17x slower on an H100 at n = 1e5 (PERF.md). The slot-major tables
    # give (..., q, dmax, n) terms, added over the slots in slot order.
    dmax, n = nbr.shape
    Vt = V.mT.contiguous()                                   # (..., q, n)
    Vd = Vt.unsqueeze(-2) - Vt.index_select(-1, nbr.reshape(-1)).reshape(
        *Vt.shape[:-1], dmax, n)
    return (Vd * w_tbl.unsqueeze(-3)).sum(dim=-2).mT.contiguous()


def ell_product_plain(nbr, cnt, w_tbl, V, *, B=None, bsum=None, vsum=None,
                      c=None, sigma=None, dot=False):
    """Plain version of K8 (the module docstring's forms): every slot of
    every row (the padding past cnt adds 0; cnt is not read); the shift
    takes V's own column means and the residual B's own (vsum and bsum
    only say that they are wanted)."""
    if V.shape[-2] != nbr.shape[1]:
        raise ValueError(f"ell_product: V has {V.shape[-2]} rows, the "
                         f"tables {nbr.shape[1]}")
    y = _gather_product(nbr, w_tbl, V)
    if c is not None:
        m64 = V.double().mean(dim=-2, keepdim=True)
        y = y + (_per_lane(c).double() * m64).to(V.dtype)
        if sigma is not None:
            y = y + _per_lane(sigma) * V
    if B is not None:
        if bsum is not None:
            B = B - B.mean(dim=-2, keepdim=True)
        y = B - y
    if dot:
        return y, (V * y).double().sum(dim=-2)
    return y


def _lane_stride(t: torch.Tensor, lanes: int) -> int:
    """The lane stride (elements) of a block or table t whose last two
    dimensions are one lane's: 0 without a lane dimension or when t is
    expanded over its lanes."""
    if t.dim() == 2:
        return 0
    if t.dim() != 3 or t.shape[0] != lanes:
        raise ValueError(f"ell_product: {tuple(t.shape)} does not hold "
                         f"{lanes} lanes")
    return t.stride(0)


def _on_card(nbr: torch.Tensor, cnt: torch.Tensor, w_tbl: torch.Tensor,
             V: torch.Tensor) -> bool:
    """True when V lies on a CUDA device (launch the kernel), False when
    it and the tables lie on the CPU (run the plain version)."""
    if V.is_cuda:
        return True
    if w_tbl.is_cuda or nbr.is_cuda or cnt.is_cuda:
        raise ValueError("ell_product: tensors on different devices")
    return False


def ell_product(nbr: torch.Tensor, cnt: torch.Tensor, w_tbl: torch.Tensor,
                V: torch.Tensor, *, B: torch.Tensor = None,
                bsum: torch.Tensor = None, vsum: torch.Tensor = None,
                c: torch.Tensor = None, sigma: torch.Tensor = None,
                dot: bool = False):
    """K8: L(w) V in the form the keywords ask for (module docstring): out
    (..., n, q), with dot=True (out, column dots (..., q) float64). CUDA
    tensors: the hand-written kernel, one launch (float32 or float64, the
    same for w_tbl, V, B, c and sigma; nbr (dmax, n) and cnt (n,) int32,
    contiguous; each lane of w_tbl, V and B contiguous, V and w_tbl may be
    expanded over the lanes); CPU tensors: the plain version."""
    if not _on_card(nbr, cnt, w_tbl, V):
        return ell_product_plain(nbr, cnt, w_tbl, V, B=B, bsum=bsum,
                                 vsum=vsum, c=c, sigma=sigma, dot=dot)
    dtype, dev = V.dtype, V.device
    dmax, n = nbr.shape
    q = V.shape[-1]
    lanes = V.shape[0] if V.dim() == 3 else (w_tbl.shape[0]
                                             if w_tbl.dim() == 3 else 1)
    arrays = [w_tbl, V] + [a for a in (B, c, sigma) if a is not None]
    if dtype not in SUFFIX or any(a.dtype != dtype for a in arrays):
        raise TypeError("ell_product kernel takes float32 or float64, the "
                        "same for w_tbl, V, B, c and sigma")
    if any(a.device != dev for a in arrays + [nbr, cnt]):
        raise ValueError("ell_product: tensors on different devices")
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           for t in (nbr, cnt)):
        raise ValueError("ell_product kernel: nbr and cnt must be int32 "
                         "and contiguous")
    if V.shape[-2] != n or w_tbl.shape[-2:] != (dmax, n) or \
            tuple(cnt.shape) != (n,) or \
            (B is not None and B.shape[-2:] != V.shape[-2:]):
        raise ValueError(f"ell_product: nbr {tuple(nbr.shape)}, cnt "
                         f"{tuple(cnt.shape)}, w_tbl {tuple(w_tbl.shape)}, "
                         f"V {tuple(V.shape)}")
    if not all(one_lane_contiguous(a, 2) for a in
               [w_tbl, V] + ([B] if B is not None else [])):
        raise ValueError("ell_product kernel: a lane of w_tbl, V or B is "
                         "not contiguous")
    if (c is None) != (vsum is None) or (sigma is not None and c is None):
        raise ValueError("ell_product: the inner form takes c and vsum (and "
                         "sigma optionally)")
    if bsum is not None and B is None:
        raise ValueError("ell_product: bsum centres B, which is missing")
    lead = (lanes,) if V.dim() == 3 or w_tbl.dim() == 3 else ()
    for s, name in ((vsum, "vsum"), (bsum, "bsum")):
        if s is not None and (s.dtype != torch.float64 or s.device != dev
                              or tuple(s.shape) != lead + (q,)):
            raise ValueError(f"ell_product: {name} must be float64 "
                             f"{lead + (q,)}")
    # The counter first, then the scratch, held until the launch is queued.
    tk = ticket(dev) if dot else None
    out = torch.empty(lead + (n, q), dtype=dtype, device=dev)
    part = dots = None
    if dot:
        part = torch.empty(dot_partials(n, q, lanes), dtype=torch.float64,
                           device=dev)
        dots = torch.empty(lead + (q,), dtype=torch.float64, device=dev)
    c_lane = 1 if c is not None and c.dim() == 1 else 0
    s_lane = 1 if sigma is not None and sigma.dim() == 1 else 0
    call = _build.function("ell", f"ell_product_{SUFFIX[dtype]}",
                           _SIGNATURES)
    err = _build.launch(
        call, dev, nbr.data_ptr(), cnt.data_ptr(), w_tbl.data_ptr(),
        _lane_stride(w_tbl, lanes), V.data_ptr(), _lane_stride(V, lanes),
        out.data_ptr(), _ptr(B), 0 if B is None else _lane_stride(B, lanes),
        _ptr(bsum), _ptr(vsum), _ptr(c), c_lane, _ptr(sigma), s_lane,
        _ptr(part), _ptr(dots), _ptr(tk), n, q, dmax, lanes)
    if err != 0:
        raise RuntimeError(f"ell_product kernel launch failed: cudaError "
                           f"{err}")
    count_launch(ell_product, lanes, dtype)
    return (out, dots) if dot else out


def dot_model(products: np.ndarray) -> np.ndarray:
    """The kernel's order of the column dots, in numpy float64: products
    (n, q), each row's V times out already rounded to the block's type, of
    one lane. Each block of rows_per_block(q) rows adds its rows as a warp
    adds the last block's partials in K6 (pcg.warp_sum_model: lane l the
    values l, l + 32, ... in order, then the xor butterfly) into a
    partial, then the partials add the same way in block order. Returns
    (q,)."""
    products = np.asarray(products, dtype=np.float64)
    n, q = products.shape
    rb = rows_per_block(q)
    out = np.zeros(q)
    for col in range(q):
        parts = [warp_sum_model(products[r0:r0 + rb, col])
                 for r0 in range(0, n, rb)]
        out[col] = warp_sum_model(parts)
    return out


reset_counts(ell_product)

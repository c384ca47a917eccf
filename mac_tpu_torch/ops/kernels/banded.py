"""Kernels K5, the block-banded product, and K7, the V-cycle's coarse
correction (csrc/banded.cu).

K5 `banded_product(ut, deg, V, n, ...)` stands for the reference's
banded_apply (mac_tpu/ops/banded.py:466-521, einsums that XLA fuses): L(w)
V for the transposed upper block diagonals ut (half+1, nb, BS, BS) and the
diagonal deg (nb, BS) of ops.banded.BDRep, with V (n, q), or R lanes (ut,
deg and V with a leading R; V may be one block expanded over the lanes).
Its forms, by keyword:
  * plain: L V;
  * inner (c, with sigma optional): (L V + (c / n) 1 1^T V) + sigma V, the
    shift's column means in float64 (ops.lobpcg._shift_term); the kernel
    takes V's column sums as `vsum` (float64; the plain version sums V
    itself);
  * residual (B): (B - mean(B)) - y, B centred when `bsum` is given (its
    column sums, float64; the plain version takes B's own mean);
  * dot=True: also the column dots of V and the output, float64, summed in
    a fixed order (returns (out, dot)).
K7 `coarse_correct(r, x, iperm, perm, Lc_inv, s)` stands for the coarse
correction of the reference's V-cycle (mac_tpu/ops/banded.py:793-800):
x + P Lc^-1 R r, R summing s consecutive original-order rows (through
iperm), P its transpose; the kernel adds into x in place (two launches,
the second overlapping the first).

Each wrapper launches its kernel for CUDA tensors (float32 or float64) and
runs its plain PyTorch version (`*_plain`: for K5 the arithmetic of
ops.banded.banded_apply, for K7 the restrict, product and prolong of the
cycle) for CPU tensors, and counts its launches as the other kernels'
wrappers do (K7 one count a call of its two launches).
"""

import ctypes

import numpy as np
import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.pcg import _ptr, ticket
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)

BS = 128
# K5's narrow body takes q up to this many columns (csrc/banded.cu's
# kNarrowMaxQ) in blocks of K5_NARROW_ROWS rows (kNarrowRows); the wide
# body in whole block rows.
K5_NARROW_MAX_Q = 16
K5_NARROW_ROWS = 32
# Past this many window entries per lane (q (2 half + 1) n_pad, as the
# reference gates it, mac_tpu/ops/banded.py:486) the window means come
# from a cumsum of per-block sums instead of the stacked window.
WINDOW_STACK_MAX = 64 * 1024 * 1024

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {}
for _s in SUFFIX.values():  # the last pointer of each is the stream
    _SIGNATURES[f"banded_product_{_s}"] = (
        [_P, _L, _P, _L, _P, _L, _P, _P, _L, _P, _P, _P, _L, _P, _L, _P, _P,
         _P, _P] + [_I] * 5 + [_P])
    _SIGNATURES[f"coarse_correct_{_s}"] = ([_P, _P, _P, _P, _L, _P]
                                           + [_I] * 5 + [_P])


def _padded_blocks(V: torch.Tensor, nb: int, half: int) -> torch.Tensor:
    """V (..., n, q) as (..., nb + 2 half, BS, q), zeros past its rows and
    `half` zero blocks at each end."""
    lead, (n, q) = V.shape[:-2], V.shape[-2:]
    n_pad = nb * BS
    if n_pad != n:
        V = torch.cat([V, V.new_zeros((*lead, n_pad - n, q))], dim=-2)
    Vb = V.reshape(*lead, nb, BS, q)
    zpad = Vb.new_zeros((*lead, half, BS, q))
    return torch.cat([zpad, Vb, zpad], dim=-3)


def stacked_window(V: torch.Tensor, nb: int, half: int) -> bool:
    """Whether the window means of V (n, q) or lanes (R, n, q) come from
    the stacked window (else from the cumsum): by the entries of one lane's
    window stack, as the reference gates them."""
    return V.shape[-1] * (2 * half + 1) * nb * BS <= WINDOW_STACK_MAX


def window_means_cumsum(V: torch.Tensor, nb: int, half: int) -> torch.Tensor:
    """The size-gated branch's window means (..., nb, q): per-block column
    sums, their cumsum, and the difference over each window
    (mac_tpu/ops/banded.py:486-493). A V expanded over lanes is summed
    once."""
    if V.dim() == 3 and V.stride(0) == 0:
        return window_means_cumsum(V[0], nb, half).expand(
            V.shape[0], nb, V.shape[-1])
    lead, q = V.shape[:-2], V.shape[-1]
    ndiag = 2 * half + 1
    S = _padded_blocks(V, nb, half).sum(dim=-2)  # (..., nb + 2 half, q)
    C = torch.cat([S.new_zeros((*lead, 1, q)), torch.cumsum(S, dim=-2)],
                  dim=-2)
    return (C[..., ndiag:, :] - C[..., :-ndiag, :]) / (ndiag * BS)


def _product_plain(ut: torch.Tensor, deg: torch.Tensor,
                   V: torch.Tensor) -> torch.Tensor:
    """L(w) V (ops.banded.banded_apply's arithmetic): per block row, the
    degree term, the diagonal block's strict upper part and its transpose,
    and each off block diagonal read directly at +t and transposed at -t,
    all against the window-centred input."""
    lead, (n, q) = V.shape[:-2], V.shape[-2:]
    half, nb = ut.shape[-4] - 1, ut.shape[-3]
    ndiag = 2 * half + 1
    Vp = _padded_blocks(V, nb, half)

    def blocks(o):  # the nb blocks of Vp from block o on
        return Vp[..., o:o + nb, :, :]

    if stacked_window(V, nb, half):
        win = torch.stack([blocks(o) for o in range(ndiag)], dim=0)
        cb = win.mean(dim=(0, -2)).unsqueeze(-2)
    else:
        cb = window_means_cumsum(V, nb, half).unsqueeze(-2)
    Vc0 = blocks(half) - cb
    ut0 = ut[..., 0, :, :, :]
    out = deg.unsqueeze(-1) * Vc0
    out = out + torch.matmul(ut0.transpose(-1, -2), Vc0)
    out = out + torch.matmul(ut0, Vc0)
    for t in range(1, half + 1):
        utt = ut[..., t, :, :, :]
        out = out + torch.matmul(utt.transpose(-1, -2), blocks(half + t) - cb)
        utsh = torch.cat([ut.new_zeros((*ut.shape[:-4], t, BS, BS)),
                          utt[..., : nb - t, :, :]], dim=-3)
        out = out + torch.matmul(utsh, blocks(half - t) - cb)
    return out.reshape(*lead, nb * BS, q)[..., :n, :]


def dot_partials(q: int, nb: int, lanes: int) -> int:
    """The float64 partials K5's column dots need: one per block of its
    grid and column (csrc/banded.cu: the narrow body's BS / K5_NARROW_ROWS
    blocks a block row, the wide body's one)."""
    return lanes * q * nb * (BS // K5_NARROW_ROWS if q <= K5_NARROW_MAX_Q
                             else 1)


def _per_lane(x: torch.Tensor) -> torch.Tensor:
    """A scalar per lane ((R,) or 0-d) shaped to broadcast over a block."""
    return x[:, None, None] if x.dim() == 1 else x


def banded_product_plain(ut, deg, V, n, *, B=None, bsum=None, vsum=None,
                         c=None, sigma=None, dot=False):
    """Plain version of K5 (the module docstring's forms): the shift takes
    V's own column means and the residual B's own (vsum and bsum only say
    that they are wanted)."""
    if V.shape[-2] != n:
        raise ValueError(f"banded_product: V has {V.shape[-2]} rows, want "
                         f"{n}")
    y = _product_plain(ut, deg, V)
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


def _lane_stride(t: torch.Tensor, dims: int, lanes: int) -> int:
    """The lane stride (elements) of t, whose last `dims` dimensions are
    one lane's and contiguous: 0 without a lane dimension or when t is
    expanded over its lanes."""
    if t.dim() == dims:
        return 0
    if t.dim() != dims + 1 or t.shape[0] != lanes:
        raise ValueError(f"banded_product: {tuple(t.shape)} does not hold "
                         f"{lanes} lanes")
    return t.stride(0)


def one_lane_contiguous(t: torch.Tensor, dims: int) -> bool:
    """Whether each lane of t (its last `dims` dimensions) is row-major
    and contiguous (a lane dimension may be expanded)."""
    inner = t if t.dim() == dims else t[0]
    return inner.is_contiguous()


def banded_product(ut: torch.Tensor, deg: torch.Tensor, V: torch.Tensor,
                   n: int, *, B: torch.Tensor = None,
                   bsum: torch.Tensor = None, vsum: torch.Tensor = None,
                   c: torch.Tensor = None, sigma: torch.Tensor = None,
                   dot: bool = False):
    """K5: L(w) V in the form the keywords ask for (module docstring):
    out (..., n, q), with dot=True (out, column dots (..., q) float64). CUDA
    tensors: the hand-written kernel, one launch (float32 or float64, each
    lane's ut, deg, V and B contiguous; V may be expanded over lanes); CPU
    tensors: the plain version."""
    half, nb = ut.shape[-4] - 1, ut.shape[-3]
    cb = None
    if not V.is_cuda:
        if ut.is_cuda:
            raise ValueError("banded_product: tensors on different devices")
        return banded_product_plain(ut, deg, V, n, B=B, bsum=bsum, vsum=vsum,
                                    c=c, sigma=sigma, dot=dot)
    dtype, dev = V.dtype, V.device
    lanes = V.shape[0] if V.dim() == 3 else (ut.shape[0] if ut.dim() == 5
                                             else 1)
    q = V.shape[-1]
    arrays = [ut, deg, V] + [a for a in (B, c, sigma) if a is not None]
    if dtype not in SUFFIX or any(a.dtype != dtype for a in arrays):
        raise TypeError("banded_product kernel takes float32 or float64, the "
                        "same for ut, deg, V, B, c and sigma")
    if any(a.device != dev for a in arrays):
        raise ValueError("banded_product: tensors on different devices")
    if V.shape[-2] != n or ut.shape[-2:] != (BS, BS) or \
            deg.shape[-2:] != (nb, BS) or n > nb * BS:
        raise ValueError(f"banded_product: ut {tuple(ut.shape)}, deg "
                         f"{tuple(deg.shape)}, V {tuple(V.shape)}, n {n}")
    if not all(one_lane_contiguous(a, d) for a, d in
               ((ut, 4), (deg, 2), (V, 2)) + (((B, 2),) if B is not None
                                               else ())):
        raise ValueError("banded_product kernel: a lane of ut, deg, V or B "
                         "is not contiguous")
    if (c is None) != (vsum is None) or (sigma is not None and c is None):
        raise ValueError("banded_product: the inner form takes c and vsum "
                         "(and sigma optionally)")
    if (bsum is not None) and B is None:
        raise ValueError("banded_product: bsum centres B, which is missing")
    if not stacked_window(V, nb, half):
        cb = window_means_cumsum(V, nb, half).to(dtype).contiguous()
        if cb.dim() == 2 and lanes > 1:
            cb = cb.expand(lanes, nb, q).contiguous()
    tk = ticket(dev) if dot else None
    lead = (lanes,) if V.dim() == 3 or ut.dim() == 5 else ()
    out = torch.empty(lead + (n, q), dtype=dtype, device=dev)
    part = dots = None
    if dot:
        part = torch.empty(dot_partials(q, nb, lanes), dtype=torch.float64,
                           device=dev)
        dots = torch.empty(lead + (q,), dtype=torch.float64, device=dev)
    c_lane = 1 if c is not None and c.dim() == 1 else 0
    s_lane = 1 if sigma is not None and sigma.dim() == 1 else 0
    call = _build.function("banded", f"banded_product_{SUFFIX[dtype]}",
                           _SIGNATURES)
    err = _build.launch(
        call, dev, ut.data_ptr(), _lane_stride(ut, 4, lanes), deg.data_ptr(),
        _lane_stride(deg, 2, lanes), V.data_ptr(),
        _lane_stride(V, 2, lanes), out.data_ptr(), _ptr(B),
        0 if B is None else _lane_stride(B, 2, lanes), _ptr(bsum),
        _ptr(vsum), _ptr(c), c_lane, _ptr(sigma), s_lane, _ptr(cb),
        _ptr(part), _ptr(dots), _ptr(tk), n, q, nb, half, lanes)
    if err != 0:
        raise RuntimeError(f"banded_product kernel launch failed: "
                           f"cudaError {err}")
    count_launch(banded_product, lanes, dtype)
    return (out, dots) if dot else out


def tf32(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as cvt.rna.tf32.f32 rounds them."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_product_model(A: np.ndarray, B: np.ndarray,
                        kc: int = 32) -> np.ndarray:
    """A numpy model of the wide body's float32 product on the tensor cores
    ("3xTF32", csrc/banded.cu): A (m, K) and B (K, p) float32 each split as
    hi = tf32(x), lo = tf32(x - hi); per chunk of kc columns of A the
    products lo hi + hi lo + hi hi in float32, each chunk's sum added to
    the result in float32."""
    A = np.asarray(A, dtype=np.float32)
    B = np.asarray(B, dtype=np.float32)
    Ah = tf32(A)
    Al = tf32(A - Ah)
    Bh = tf32(B)
    Bl = tf32(B - Bh)
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.float32)
    for k0 in range(0, A.shape[1], kc):
        k = slice(k0, k0 + kc)
        sub = Al[:, k] @ Bh[k]
        sub = sub + Ah[:, k] @ Bl[k]
        sub = sub + Ah[:, k] @ Bh[k]
        out = out + sub
    return out


def coarse_correct_plain(r, x, iperm, perm, Lc_inv, s):
    """Plain version of K7: x + prolong(Lc_inv @ restrict(r)) with the
    cycle's restrict (r's rows gathered through iperm into original order,
    padded to nc s rows, summed s at a time) and prolong (each aggregate's
    value repeated s times, the first n rows gathered through perm)."""
    lead, (n, q) = r.shape[:-2], r.shape[-2:]
    nc = Lc_inv.shape[-1]
    rn = r[..., iperm, :]
    rp = torch.cat([rn, rn.new_zeros((*lead, nc * s - n, q))], dim=-2)
    xc = Lc_inv @ rp.reshape(*lead, nc, s, q).sum(dim=-2)
    return x + torch.repeat_interleave(xc, s, dim=-2)[..., :n, :][..., perm, :]


def coarse_correct(r: torch.Tensor, x: torch.Tensor, iperm: torch.Tensor,
                   perm: torch.Tensor, Lc_inv: torch.Tensor,
                   s: int) -> torch.Tensor:
    """K7: x + P Lc_inv R r (module docstring), r and x (n, q) or (R, n, q)
    in the operator's order, Lc_inv (nc, nc) or one per lane (R, nc, nc).
    CUDA tensors: the hand-written kernel adds into x in place and returns
    it (two launches; float32 or float64, contiguous, iperm int32); CPU
    tensors: the plain version (a new tensor)."""
    if x.shape != r.shape:
        raise ValueError(f"coarse_correct: r {tuple(r.shape)} and x "
                         f"{tuple(x.shape)} differ")
    if not r.is_cuda:
        if x.is_cuda or Lc_inv.is_cuda:
            raise ValueError("coarse_correct: tensors on different devices")
        return coarse_correct_plain(r, x, iperm, perm, Lc_inv, s)
    lanes, n, q = (1, *r.shape) if r.dim() == 2 else r.shape
    nc = Lc_inv.shape[-1]
    if r.dtype not in SUFFIX or x.dtype != r.dtype or \
            Lc_inv.dtype != r.dtype:
        raise TypeError("coarse_correct kernel takes float32 or float64, the "
                        "same for r, x and Lc_inv")
    if iperm.dtype != torch.int32 or iperm.shape != (n,):
        raise ValueError("coarse_correct kernel: iperm must be int32 (n,)")
    if nc * s < n or Lc_inv.shape[-2] != nc:
        raise ValueError(f"coarse_correct: {nc} aggregates of {s} rows do "
                         f"not cover {n}")
    if not (r.is_contiguous() and x.is_contiguous()
            and one_lane_contiguous(Lc_inv, 2)):
        raise ValueError("coarse_correct kernel: r, x or Lc_inv not "
                         "contiguous")
    if any(a.device != r.device for a in (x, iperm, Lc_inv)):
        raise ValueError("coarse_correct: tensors on different devices")
    rc = torch.empty(lanes * nc * q, dtype=torch.float64, device=r.device)
    call = _build.function("banded", f"coarse_correct_{SUFFIX[r.dtype]}",
                           _SIGNATURES)
    err = _build.launch(call, r.device, r.data_ptr(), x.data_ptr(),
                        iperm.data_ptr(), Lc_inv.data_ptr(),
                        _lane_stride(Lc_inv, 2, lanes), rc.data_ptr(), n, q,
                        nc, int(s), lanes)
    if err != 0:
        raise RuntimeError(f"coarse_correct kernel launch failed: cudaError "
                           f"{err}")
    count_launch(coarse_correct, lanes, r.dtype)
    return x


reset_counts(banded_product, coarse_correct)

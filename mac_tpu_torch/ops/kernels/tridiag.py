"""Kernels K1 and K1b: the tridiagonal LDL^T solve (csrc/tridiag.cu).

Solves L diag(dp) L^T X = B with L unit lower bidiagonal (subdiagonal l),
for dp, l of shape (n,) and B of shape (n, q) -- the contract of the TPU
kernels they replace, mac_tpu/ops/pallas/tridiag_kernel.py:

  K1  `tridiag_solve` (tridiag_solve_fused): whole rows;
  K1b `tridiag_solve_blocked` (tridiag_solve_fused_blocked): segments of
      `block` rows, decoupled by taking l = 0 at each segment's first row;
  K1p `tridiag_solve_permuted`: the banded V-cycle's smoother with its
      gathers through the permutation (mac_tpu/ops/banded.py:793-800), on
      K1b's design for a factor decoupled every `seg` rows and on K1's for
      an exact factor (its two bodies, counted in `.launches_by_body`).

Both also take R lanes in one call: B of shape (R, n, q), with dp, l of
shape (R, n) (a factor per lane: the budget sweep) or (n,) (one factor
shared by every lane). Lane r's X is the solve of lane r's B with its
factor.

Each wrapper launches its CUDA kernel for tensors on a CUDA device (float32
or float64, one instantiation of the kernel each) and runs its plain
PyTorch version (`*_plain`) for tensors on the CPU, and counts its launches
in `.launches`, by lane count in `.launches_by_lanes` ({R: launches}) and
by dtype in `.launches_by_dtype` ({"float32": launches, "float64":
launches}).
"""

import ctypes

import numpy as np
import torch

from mac_tpu_torch.ops.kernels import _build


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


def _substitute(dp: torch.Tensor, l: torch.Tensor,
                B: torch.Tensor) -> torch.Tensor:
    """Forward affine scan, diagonal scale, backward affine scan along axis
    0 of B; dp and l broadcast against B."""
    y = _scan_affine(torch.broadcast_to(-l, B.shape), B)
    z = y / dp
    # Backward: x_i = z_i - l_{i+1} x_{i+1}, a forward scan of the reversal.
    lr = torch.cat([-l[1:], torch.zeros_like(l[:1])])
    coef_r = torch.broadcast_to(lr, B.shape).flip(0)
    return _scan_affine(coef_r, z.flip(0)).flip(0)


def _factor_lanes(dp: torch.Tensor, l: torch.Tensor, B: torch.Tensor):
    """dp and l of a lane block B (R, n, q) as (R, n) each (a shared factor
    (n,) broadcast to every lane, a view)."""
    R, n = B.shape[0], B.shape[1]
    return dp.expand(R, n), l.expand(R, n)


def tridiag_solve_plain(dp: torch.Tensor, l: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: forward and backward affine scans
    around the diagonal scale (mac_tpu.ops.tridiag.
    tridiag_solve_factored). Lanes run side by side in the scans, the row
    axis first."""
    if B.dim() == 2:
        return _substitute(dp[:, None], l[:, None], B)
    dp, l = _factor_lanes(dp, l, B)
    X = _substitute(dp.T[:, :, None], l.T[:, :, None], B.transpose(0, 1))
    return X.transpose(0, 1).contiguous()


def tridiag_solve_blocked_plain(dp: torch.Tensor, l: torch.Tensor,
                                B: torch.Tensor,
                                block: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K1b (mac_tpu/ops/pallas/tridiag_kernel.py,
    tridiag_solve_fused_blocked): rows padded to a multiple of `block` with
    l = 0, dp = 1, B = 0; l forced to 0 at every row % block == 0; each
    segment (of each lane) solved on its own, by the scans of the whole-row
    version run along the segment axis."""
    if B.dim() == 3:
        dp, l = _factor_lanes(dp, l, B)
    lead, (n, q) = B.shape[:-2], B.shape[-2:]
    nbl = -(-n // block)
    n_pad = nbl * block
    dp_p = torch.ones((*lead, n_pad), dtype=B.dtype, device=B.device)
    dp_p[..., :n] = dp
    l_p = torch.zeros((*lead, n_pad), dtype=B.dtype, device=B.device)
    l_p[..., :n] = l
    l_p[..., ::block] = 0.0  # decouple the segments
    B_p = torch.cat([B, B.new_zeros((*lead, n_pad - n, q))], dim=-2)
    # (block, ..., nbl, q): the scan axis first, one column of segments each.
    Bs = B_p.reshape(*lead, nbl, block, q).movedim(-2, 0)
    X = _substitute(dp_p.reshape(*lead, nbl, block).movedim(-1, 0)[..., None],
                    l_p.reshape(*lead, nbl, block).movedim(-1, 0)[..., None],
                    Bs)
    return X.movedim(0, -2).reshape(*lead, n_pad, q)[..., :n, :]


# The exported functions' suffix for each dtype the kernels take.
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_K1_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong]
_SIGNATURES = {
    f"{fn}_{suffix}": _K1_ARGS + extra
    for fn, extra in (("tridiag_solve", [ctypes.c_void_p]),
                      ("tridiag_solve_blocked", [ctypes.c_int,
                                                 ctypes.c_void_p]),
                      ("tridiag_solve_perm",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4),
                      ("tridiag_solve_perm_seg",
                       [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p] * 4))
    for suffix in SUFFIX.values()}


def _on_card(name: str, dp: torch.Tensor, l: torch.Tensor,
             B: torch.Tensor) -> bool:
    """Check the arguments; True when they lie on a CUDA device (launch the
    kernel), False when they lie on the CPU (run the plain version)."""
    n = B.shape[-2] if B.dim() in (2, 3) else -1
    shared = dp.shape == (n,)
    per_lane = B.dim() == 3 and dp.shape == (B.shape[0], n)
    if n < 0 or not (shared or per_lane) or l.shape != dp.shape:
        raise ValueError(f"{name}: want dp, l (n,) and B (n, q), or dp, l "
                         f"(R, n) or (n,) and B (R, n, q); got "
                         f"{tuple(dp.shape)}, {tuple(l.shape)}, "
                         f"{tuple(B.shape)}")
    if not B.is_cuda:
        if dp.is_cuda or l.is_cuda:
            raise ValueError(f"{name}: tensors on different devices")
        return False
    if dp.device != B.device or l.device != B.device:
        raise ValueError(f"{name}: tensors on different devices")
    check_kernel_args(name, dp, l, B)
    return True


def check_kernel_args(name: str, dp: torch.Tensor, l: torch.Tensor,
                      B: torch.Tensor) -> None:
    """What the kernels take beyond the shapes: one dtype, float32 or
    float64, for all three arrays, each contiguous."""
    if B.dtype not in SUFFIX or not dp.dtype == l.dtype == B.dtype:
        arg, t = next((arg, t) for arg, t in (("B", B), ("dp", dp), ("l", l))
                      if t.dtype not in SUFFIX or t.dtype != B.dtype)
        raise TypeError(f"{name} kernel takes float32 or float64, the same "
                        f"for dp, l and B; {arg} is {t.dtype} (B "
                        f"{B.dtype})")
    if not (dp.is_contiguous() and l.is_contiguous() and B.is_contiguous()):
        arg = next(arg for arg, t in (("dp", dp), ("l", l), ("B", B))
                   if not t.is_contiguous())
        raise ValueError(f"{name} kernel: {arg} not contiguous")


def _launch(fn: str, dp, l, B, *extra) -> torch.Tensor:
    """Call the exported C function `fn` on B's device and PyTorch's current
    stream there; X, or an error for a non-zero cudaError_t."""
    call = _build.function("tridiag", fn, _SIGNATURES)
    X = torch.empty_like(B)
    lanes = B.shape[0] if B.dim() == 3 else 1
    fstride = dp.shape[-1] if dp.dim() == 2 else 0
    err = _build.launch(call, B.device, dp.data_ptr(), l.data_ptr(),
                        B.data_ptr(), X.data_ptr(), B.shape[-2], B.shape[-1],
                        lanes, fstride, *extra)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    return X


# A wrapper's launch counts by key: lanes, dtype name and, for a kernel of
# several bodies, the body's name.
COUNT_DICTS = ("launches_by_lanes", "launches_by_dtype", "launches_by_body")


def count_launch(wrapper, lanes: int, dtype: torch.dtype,
                 body: str = None) -> None:
    """One launch of `wrapper`'s kernel on `lanes` lanes of `dtype` (and
    of its body `body`, if it has several)."""
    wrapper.launches += 1
    keys = (lanes, str(dtype).split(".")[-1], body)
    for name, key in zip(COUNT_DICTS, keys):
        if key is not None:
            counts = getattr(wrapper, name)
            counts[key] = counts.get(key, 0) + 1


def reset_counts(*wrappers) -> None:
    """Set every count of each kernel wrapper to 0."""
    for wrapper in wrappers:
        wrapper.launches = 0
        for name in COUNT_DICTS:
            setattr(wrapper, name, {})


def tridiag_solve(dp: torch.Tensor, l: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """K1: X with L diag(dp) L^T X = B, of one block or of R lanes (see
    the module docstring). CUDA tensors: the hand-written kernel (float32
    or float64, contiguous, any n, q and R; one launch); CPU tensors: the
    plain version."""
    if not _on_card("tridiag_solve", dp, l, B):
        return tridiag_solve_plain(dp, l, B)
    X = _launch(f"tridiag_solve_{SUFFIX[B.dtype]}", dp, l, B)
    count_launch(tridiag_solve, B.shape[0] if B.dim() == 3 else 1, B.dtype)
    return X


def tridiag_solve_blocked(dp: torch.Tensor, l: torch.Tensor, B: torch.Tensor,
                          block: int = 1024) -> torch.Tensor:
    """K1b: the solve with the segments of `block` rows decoupled (l taken
    as 0 at every row % block == 0), of one block or of R lanes. CUDA
    tensors: the hand-written kernel (float32 or float64, contiguous, block
    a multiple of 32 up to 1024; one launch); CPU tensors: the plain
    version."""
    if not _on_card("tridiag_solve_blocked", dp, l, B):
        return tridiag_solve_blocked_plain(dp, l, B, block)
    if not (32 <= block <= 1024 and block % 32 == 0):
        raise ValueError(f"tridiag_solve_blocked kernel: block {block} is "
                         "not a multiple of 32 in [32, 1024]")
    X = _launch(f"tridiag_solve_blocked_{SUFFIX[B.dtype]}", dp, l, B,
                int(block))
    count_launch(tridiag_solve_blocked, B.shape[0] if B.dim() == 3 else 1,
                 B.dtype)
    return X


def tridiag_solve_permuted_plain(dp, l, B, iperm, perm, *, bsum=None,
                                 X=None, sums=False, seg=None):
    """Plain version of K1p: the V-cycle's smoother with its gathers, as
    ops.banded's cycle runs it: B centred by its own column means when
    bsum is given (bsum only says so), its rows gathered into the original
    order (iperm), K1's plain solve, the rows gathered back (perm), added
    to X when X is given; with sums=True also the result's column sums
    (float64). With seg, l is taken as 0 at every seg-th row, as the
    segment body takes it: on a factor decoupled there (the blocked LDL^T)
    the whole-row solve is the segments' solve."""
    if bsum is not None:
        B = B - B.mean(dim=-2, keepdim=True)
    if seg is not None:
        l = l.clone()
        l[..., ::seg] = 0.0
    x = tridiag_solve_plain(dp, l, B[..., iperm, :])[..., perm, :]
    if X is not None:
        x = X + x
    return (x, x.double().sum(dim=-2)) if sums else x


def permuted_body(seg) -> str:
    """K1p's body for a factor: "segment" (K1b's design) for one
    decoupled every `seg` rows, "cluster" (K1's) for an exact factor (seg
    None)."""
    return "cluster" if seg is None else "segment"


# K1p's cluster body: blocks of a cluster, each with its column sums' partial.
K1P_CLUSTER = 16


# K1p's segment body: threads a block where it takes the column sums
# (csrc/tridiag.cu's kSegThreads).
K1P_SEG_THREADS = 128


def k1p_segment_sum_model(values: np.ndarray, seg: int) -> np.ndarray:
    """The segment body's order of X's column sums, in numpy float64:
    values (n, q) (already rounded to the solve's type); per segment of seg
    rows, thread t adds rows 4t .. 4t + 3 in order, each warp's 32 threads
    by the xor butterfly 16, 8, 4, 2, 1, the warps in order; a block (of
    K1P_SEG_THREADS threads, or a segment's threads past them) adds its
    segments' sums in order, then the blocks' partials add in block order.
    Returns (q,)."""
    values = np.asarray(values, dtype=np.float64)
    n, q = values.shape
    threads = (-(-seg // 4) + 31) // 32 * 32  # a segment's (K1b's)
    per_block = max(1, K1P_SEG_THREADS // threads) * seg
    lanes = np.arange(32)
    out = np.zeros(q)
    for col in range(q):
        total = 0.0
        for b0 in range(0, n, per_block):
            block_part = 0.0
            for s0 in range(b0, min(n, b0 + per_block), seg):
                block = values[s0:min(n, s0 + seg), col]
                tsum = np.zeros(threads)
                for t in range(threads):
                    acc = 0.0
                    for v in block[4 * t:4 * t + 4]:
                        acc += v
                    tsum[t] = acc
                part = 0.0
                for w in range(threads // 32):
                    v = tsum[32 * w:32 * w + 32]
                    for k in (16, 8, 4, 2, 1):
                        v = v + v[lanes ^ k]
                    part += v[0]
                block_part += part
            total += block_part
        out[col] = total
    return out


def tridiag_solve_permuted(dp: torch.Tensor, l: torch.Tensor,
                           B: torch.Tensor, iperm: torch.Tensor,
                           perm: torch.Tensor, *, bsum: torch.Tensor = None,
                           X: torch.Tensor = None, sums: bool = False,
                           seg: int = None):
    """K1p, K1's permuted entry: x with x[iperm[j]] the solve's row j of
    (B - bsum / n)[iperm] (the centring when bsum, B's column sums in
    float64, is given), added into X in place when X is given; with
    sums=True also x's column sums (float64), summed in a fixed order.
    B, X (n, q) or (R, n, q) in the operator's (RCM) order, the factor in
    the original order as K1 takes it; seg: the factor is decoupled every
    seg rows (l taken as 0 there; a multiple of 32 up to 1024), or None for
    an exact factor. CUDA tensors: one launch of the body permuted_body
    picks, the segment body (K1b's solve a segment) or the cluster body
    (K1's, any n: rows past shared memory go through a natural-order
    scratch); CPU tensors: the plain version."""
    if not _on_card("tridiag_solve_permuted", dp, l, B):
        return tridiag_solve_permuted_plain(dp, l, B, iperm, perm, bsum=bsum,
                                            X=X, sums=sums, seg=seg)
    lead, (n, q) = B.shape[:-2], B.shape[-2:]
    lanes = B.shape[0] if B.dim() == 3 else 1
    if iperm.dtype != torch.int32 or iperm.shape != (n,) or \
            iperm.device != B.device:
        raise ValueError("tridiag_solve_permuted kernel: iperm must be int32 "
                         "(n,) on B's device")
    want = (*lead, q)
    if bsum is not None and (bsum.dtype != torch.float64
                             or bsum.shape != want):
        raise ValueError(f"tridiag_solve_permuted: bsum must be float64 "
                         f"{want}")
    if X is not None and (X.shape != B.shape or X.dtype != B.dtype
                          or not X.is_contiguous()):
        raise ValueError("tridiag_solve_permuted kernel: X must be "
                         "contiguous, of B's shape and type")
    body = permuted_body(seg)
    if body == "segment" and not (32 <= seg <= 1024 and seg % 32 == 0):
        raise ValueError(f"tridiag_solve_permuted kernel: seg {seg} is not "
                         "a multiple of 32 in [32, 1024]")
    from mac_tpu_torch.ops.kernels.pcg import ticket

    tk = ticket(B.device) if sums else None
    out = torch.empty_like(B) if X is None else X
    # The segment body's partials, one a block: at most one a segment.
    blocks = -(-n // seg) if body == "segment" else K1P_CLUSTER
    part = osum = None
    if sums:
        part = torch.empty(lanes * q * blocks, dtype=torch.float64,
                           device=B.device)
        osum = torch.empty(want, dtype=torch.float64, device=B.device)
    fstride = dp.shape[-1] if dp.dim() == 2 else 0
    args = [dp.data_ptr(), l.data_ptr(), B.data_ptr(), out.data_ptr(), n, q,
            lanes, fstride]
    sums_args = [0 if part is None else part.data_ptr(),
                 0 if osum is None else osum.data_ptr(),
                 0 if tk is None else tk.data_ptr()]
    bsum_ptr = 0 if bsum is None else bsum.data_ptr()
    if body == "segment":
        fn = f"tridiag_solve_perm_seg_{SUFFIX[B.dtype]}"
        args += [int(seg), iperm.data_ptr(), bsum_ptr, int(X is not None)]
    else:
        fn = f"tridiag_solve_perm_{SUFFIX[B.dtype]}"
        Z = torch.empty_like(B)
        args += [iperm.data_ptr(), bsum_ptr, Z.data_ptr(), int(X is not None)]
    err = _build.launch(_build.function("tridiag", fn, _SIGNATURES),
                        B.device, *args, *sums_args)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    count_launch(tridiag_solve_permuted, lanes, B.dtype, body)
    return (out, osum) if sums else out


reset_counts(tridiag_solve, tridiag_solve_blocked, tridiag_solve_permuted)

"""Kernel K4: the eigenpairs of symmetric matrices (csrc/syev.cu).

sym_eig(H) -> (evals, V) for H of shape (..., k, k), any k >= 1, float32
or float64, computed in H's dtype by cyclic Jacobi rotations in the
parallel (round-robin) order: evals (..., k) ascending, ties in index
order, and V (..., k, k) with V[..., :, j] the unit eigenvector of
evals[..., j], scaled so that its entry of largest magnitude (the first on
ties) is positive. H is read as symmetric (both triangles are used);
TRACEMIN hands it (H + H^T) / 2.

It stands for jnp.linalg.eigh in the JAX package's TRACEMIN (the
Rayleigh-Ritz eigensolves of a q-column block, q x q at the entry and
3q x 3q in every outer iteration, mac_tpu/ops/lobpcg.py:354, :371, :443,
under vmap for its lanes), as torch.linalg.eigh, which on a CUDA tensor
reads its error code back to the host and so cannot sit inside a captured
CUDA graph.

The wrapper launches a CUDA kernel for a CUDA tensor (one launch, no host
read) and runs the plain PyTorch version (`sym_eig_plain`: the same rounds
in the same order, the same rotation formulas and the same stop rule,
vectorised over a round's k / 2 pairs and over the batch) for a CPU
tensor. The kernel has two bodies, picked by `body_for(k, dtype)`:
"warp" for k <= 32 (a warp a matrix, the matrix in registers), and past
it K4w, a cluster of two thread blocks a matrix on neighbouring SMs. Its
A block keeps A by slots, twice: each round reads one copy and writes the
other at the next round's slots, so that every 2 x 2 block (the two rows
of one pair by the two columns of another) is four entries at fixed,
conflict-free places; a thread loads a block once, rotates its rows and
then its columns in registers and stores it once, one block barrier a
round. Its pusher warps compute the next round's parameters once a pair,
from the blocks of this round they read before anyone writes, and
publish them in shared memory, while the other threads rotate. Its V
block holds V^T and applies each round's rotations as the A block hands
them over, through a ring of slots in the V block's shared memory
written across the cluster by asynchronous stores (st.async) and
signalled by mbarriers, so V's rotations are off A's chain. Each entry
of A and V sees the roundings of the three-pass K4w (commit 9f43cf3: rows
of A and V^T, then columns of A) in the same order, so its outputs are
that kernel's bit for bit.
A and V^T sit in the blocks' shared memory while
`wide_smem_bytes` fits SMEM_LIMIT ("wide_shared"; k up to 168 in float32,
118 in float64) and in a workspace the wrapper allocates with torch.empty
on H's device otherwise ("wide_workspace", `wide_scratch_bytes` a matrix;
inside a CUDA graph capture it comes from the graph's pool). On a CUDA
tensor the wrapper raises for what the kernels do not take (a dtype other
than float32 and float64, a non-contiguous tensor, a batch past 2^30 in
K4w, past int32 in the warp body); nothing falls back to
torch.linalg.eigh. It counts its launches in `.launches`,
`.launches_by_lanes` (by the number of matrices), `.launches_by_dtype` and
`.launches_by_body` (by body_for's names), as the other kernels' wrappers
do. `wide_phases` runs K4w with clock64() stamps of its phases.
"""

import ctypes
from functools import lru_cache

import torch

from mac_tpu_torch.ops.kernels import _build
from mac_tpu_torch.ops.kernels.tridiag import (SUFFIX, count_launch,
                                               reset_counts)

# The largest order the warp body takes; past it K4w runs.
WARP_MAX_K = 32
# Bytes of dynamic shared memory a block may opt into (H100, H200): K4w
# keeps A and V there while its scratch fits.
SMEM_LIMIT = 232448
BODIES = ("warp", "wide_shared", "wide_workspace")
# Slots of K4w's ring, through which its A block hands each round's
# rotations to its V block.
RING = 8
# Sweeps at most; the stop test (off-diagonal Frobenius norm at most
# eps ||H||_F) ends the loop before every sweep, on the card and here.
MAX_SWEEPS = 30


@lru_cache(maxsize=None)
def _rounds(m: int):
    """The round-robin schedule of a sweep over m (even) indices, as the
    kernel walks it: in round r slot 0 holds index 0 and slot j >= 1 index
    ((j - 1 + r) mod (m - 1)) + 1, and slot i pairs with slot m - 1 - i.
    Per round: the flat indices of (p, p), (q, q), (p, q) of its m / 2
    pairs p < q; each index's partner; each index's pair; each index's
    sign, -1 at p and +1 at q; the flat indices of (p, p), (q, q), (p, q),
    (q, p)."""
    out = []
    for r in range(m - 1):
        slot = [0] + [((j - 1 + r) % (m - 1)) + 1 for j in range(1, m)]
        pairs = [sorted((slot[i], slot[m - 1 - i])) for i in range(m // 2)]
        P = torch.tensor([p for p, _ in pairs])
        Q = torch.tensor([q for _, q in pairs])
        partner = torch.empty(m, dtype=torch.long)
        partner[P], partner[Q] = Q, P
        pair = torch.empty(m, dtype=torch.long)
        pair[P] = pair[Q] = torch.arange(m // 2)
        sign = torch.ones(m, dtype=torch.float64)
        sign[P] = -1.0
        out.append((torch.cat([P * m + P, Q * m + Q, P * m + Q]), partner,
                    pair, sign,
                    torch.cat([P * m + P, Q * m + Q, P * m + Q, Q * m + P])))
    return tuple(out)


def sym_eig_plain(H: torch.Tensor):
    """Plain PyTorch version of K4: (evals, V) of H (..., k, k) by the
    kernel's Jacobi (see csrc/syev.cu), on any device."""
    return _jacobi(H)[:2]


def jacobi_sweeps(H: torch.Tensor) -> int:
    """The sweeps the Jacobi takes on H (the most over a batch): how much
    work this H needs, for a bound on the kernel's time."""
    return _jacobi(H)[2]


def _jacobi(H: torch.Tensor):
    """(evals, V, sweeps) of the plain version. A and V are held
    stacked, W = [A; V] (b, 2m, m), so that one column update takes both;
    with sigma -1 at p and +1 at q, the rotation of rows p and q (x_p - s
    (x_q + tau x_p), x_q + s (x_p - tau x_q)) reads x + sigma s (y - sigma
    tau x) for a row x and its partner y: the kernel's roundings."""
    lead, k = H.shape[:-2], H.shape[-1]
    dtype, dev = H.dtype, H.device
    m = k + (k & 1)
    A = H.reshape(-1, k, k)
    b = A.shape[0]
    if m != k:  # a zero row and column pad an odd k
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    eye = torch.eye(m, dtype=dtype, device=dev)
    W = torch.cat([A, eye.expand(b, m, m)], dim=1)
    tol = torch.finfo(dtype).eps * torch.sqrt((A * A).sum(dim=(-2, -1)))
    off = 1 - eye
    one = torch.ones((), dtype=dtype, device=dev)
    h = m // 2
    schedule = [(g3, partner.to(dev), pair.to(dev), sign.to(dev, dtype), s4)
                for g3, partner, pair, sign, s4 in _rounds(m)]
    schedule = [(g3.to(dev), *rest[:3], rest[3].to(dev))
                for g3, *rest in schedule]
    sweeps = 0
    for sweeps in range(MAX_SWEEPS + 1):
        A = W[:, :m]
        act = ~(torch.sqrt((A * A * off).sum(dim=(-2, -1))) <= tol)
        if sweeps == MAX_SWEEPS or not bool(act.any()):
            break
        act = act.to(dtype)[:, None]
        for gather3, partner, pair, sign, scatter4 in schedule:
            app, aqq, apq = W.view(b, 2 * m * m).index_select(
                1, gather3).view(b, 3, h).unbind(1)
            # Rutishauser's t = sign(theta) / (|theta| + hypot(theta, 1)),
            # theta = (a_qq - a_pp) / (2 a_pq), written as 2 a_pq / (d +
            # sign(d) hypot(d, 2 a_pq)) with d = a_qq - a_pp; 0 where
            # a_pq = 0 (0 / 0 where d is 0 too) and in a matrix that has
            # stopped.
            d = aqq - app
            a2 = apq + apq
            t = a2 / (d + torch.copysign(torch.hypot(d, a2), d))
            t = torch.nan_to_num(t, nan=0.0) * act
            c = 1 / torch.hypot(t, one)
            s = t * c
            tau = s / (1 + c)
            st = torch.stack([s, tau]).index_select(2, pair) * sign
            Ar = W[:, :m]
            Ar = Ar + st[0, :, :, None] * (Ar.index_select(1, partner)
                                           - st[1, :, :, None] * Ar)
            W = torch.cat([Ar, W[:, m:]], dim=1)
            W = W + st[0, :, None, :] * (W.index_select(2, partner)
                                         - st[1, :, None, :] * W)
            ta = t * apq
            pq = apq * (1 - act)
            W.view(b, 2 * m * m).index_copy_(
                1, scatter4, torch.cat([app - ta, aqq + ta, pq, pq], dim=1))
    evals = torch.diagonal(W[:, :k, :k], dim1=-2, dim2=-1)
    V = W[:, m:m + k, :k]
    imax = V.abs().argmax(dim=-2, keepdim=True)
    V = V * torch.where(V.gather(-2, imax) < 0, -1.0, 1.0).to(dtype)
    evals, idx = torch.sort(evals, dim=-1, stable=True)
    V = V.gather(-1, idx[:, None, :].expand(b, k, k))
    return evals.reshape(*lead, k), V.reshape(*lead, k, k), sweeps


def _wide_region_bytes(m: int, itemsize: int) -> int:
    """Bytes of K4w's A block region at even order m: A twice (by slots,
    the round's layout and the next one's), then two buffers of per pair
    s, tau and the new diagonal pair and 32 partial sums in elements of
    `itemsize` bytes, and two buffers of an int per pair (act) and per
    pair the moves of its rows and columns (four ints), rounded up to 16
    (syev.cu's wide_region_bytes)."""
    return 2 * m * m * itemsize + ((4 * m + 32) * itemsize + 6 * (m // 2) * 4
                                   + 15) // 16 * 16


def wide_scratch_bytes(k: int, itemsize: int) -> int:
    """Bytes of K4w's workspace for one matrix of order k (syev.cu's
    wide_scratch_bytes at m = k rounded up to even): the A block's region,
    then V^T (m rows of m + 1), rounded up to 16; more than the three-pass
    K4w's, so that an A/B against that kernel fits its workspace too."""
    m = k + (k & 1)
    return _wide_region_bytes(m, itemsize) + (m * (m + 1) * itemsize
                                              + 15) // 16 * 16


def wide_smem_bytes(k: int, itemsize: int) -> int:
    """Bytes of dynamic shared memory each block of K4w's shared-memory
    form takes at order k (syev.cu's wide_smem_bytes): the ring (a 144-byte
    head of mbarriers, then as many slots of m / 2 rotations of 4 elements
    as fit beside the region, at most RING, at least one), then the A
    block's region; more than SMEM_LIMIT where that form cannot take k."""
    m = k + (k & 1)
    region = _wide_region_bytes(m, itemsize)
    slot = (m // 2) * 4 * itemsize
    slots = min(RING, max(1, (SMEM_LIMIT - 144 - region) // slot))
    return 144 + slots * slot + region


def body_for(k: int, dtype: torch.dtype) -> str:
    """The kernel body that sym_eig runs for order k in dtype on the card:
    "warp" up to WARP_MAX_K, then "wide_shared" while K4w's blocks fit
    SMEM_LIMIT (k up to 168 in float32, 118 in float64), else
    "wide_workspace"."""
    if k <= WARP_MAX_K:
        return "warp"
    itemsize = torch.empty((), dtype=dtype).element_size()
    return ("wide_shared" if wide_smem_bytes(k, itemsize) <= SMEM_LIMIT
            else "wide_workspace")


_SIGNATURES = {
    **{f"sym_eig_{suffix}": [ctypes.c_void_p] * 3
       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
       for suffix in SUFFIX.values()},
    **{f"sym_eig_wide_{suffix}": [ctypes.c_void_p] * 4
       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
       for suffix in SUFFIX.values()},
    **{f"sym_eig_wide_phases_{suffix}": [ctypes.c_void_p] * 4
       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
       for suffix in SUFFIX.values()}}


def check_kernel_args(H: torch.Tensor) -> None:
    """What the kernels take: a (..., k, k) float32 or float64 tensor, any
    k >= 1, contiguous, fewer than 2^31 matrices."""
    if H.dim() < 2 or H.shape[-1] != H.shape[-2] or H.shape[-1] < 1:
        raise ValueError(f"sym_eig: want H (..., k, k), k >= 1; got "
                         f"{tuple(H.shape)}")
    if H.dtype not in SUFFIX:
        raise TypeError(f"sym_eig kernel takes float32 or float64, not "
                        f"{H.dtype}")
    if not H.is_contiguous():
        raise ValueError("sym_eig kernel: H is not contiguous")
    if H.numel() // (H.shape[-1] ** 2) >= 2 ** 31:
        raise ValueError("sym_eig kernel: batch past int32")


def sym_eig(H: torch.Tensor, body: str = None):
    """K4: (evals, V) of the symmetric matrices H (..., k, k) (see the
    module docstring). CUDA tensors: the hand-written kernel, one launch
    of the body body_for(k, dtype) names; `body` forces one of BODIES
    instead (the two storage forms of K4w, or K4w on a small matrix, for
    comparison). CPU tensors: the plain version."""
    if not H.is_cuda:
        if H.dim() < 2 or H.shape[-1] != H.shape[-2] or H.shape[-1] < 1:
            raise ValueError(f"sym_eig: want H (..., k, k), k >= 1; got "
                             f"{tuple(H.shape)}")
        return sym_eig_plain(H)
    body = _kernel_body(H, body)
    if body == "warp":
        k = H.shape[-1]
        evals = torch.empty(H.shape[:-1], dtype=H.dtype, device=H.device)
        V = torch.empty_like(H)
        call = _build.function("syev", f"sym_eig_{SUFFIX[H.dtype]}",
                               _SIGNATURES)
        err = _build.launch(call, H.device, H.data_ptr(), evals.data_ptr(),
                            V.data_ptr(), k, H.numel() // (k * k))
        if err != 0:
            raise RuntimeError(f"sym_eig kernel ({body}) launch failed: "
                               f"cudaError {err}")
    else:
        evals, V = _launch_wide(H, body, "sym_eig_wide")
    count_launch(sym_eig, H.numel() // H.shape[-1] ** 2, H.dtype, body)
    return evals, V


def wide_phases(H: torch.Tensor, body: str = None):
    """One launch of K4w on the CUDA tensor H (..., k, k) in the build
    that stamps its phases (sym_eig_wide_phases_*; `body` as sym_eig's,
    "wide_shared" or "wide_workspace"): (evals, V, clk), clk (16,) int64 on
    the card with the first matrix's clock64() durations as csrc/syev.cu's
    wide_body lays them out (clk[0] their count, clk[13] the body that
    stamped them). Not counted as a launch: it measures, the paths never
    call it."""
    if not H.is_cuda:
        raise ValueError("sym_eig_wide_phases: the phase stamps need a CUDA "
                         "tensor")
    body = _kernel_body(H, body or ("wide_shared" if body_for(
        H.shape[-1], H.dtype) == "warp" else None))
    if body == "warp":
        raise ValueError("sym_eig_wide_phases: stamps K4w, not the warp body")
    clk = torch.zeros(16, dtype=torch.int64, device=H.device)
    evals, V = _launch_wide(H, body, "sym_eig_wide_phases", clk.data_ptr())
    return evals, V, clk


def _kernel_body(H: torch.Tensor, body):
    """The body a launch on the CUDA tensor H takes: body_for's, or the
    forced `body`, after the kernels' checks."""
    check_kernel_args(H)
    k = H.shape[-1]
    body = body_for(k, H.dtype) if body is None else body
    if body not in BODIES:
        raise ValueError(f"sym_eig: body {body!r} is none of {BODIES}")
    if body == "warp" and k > WARP_MAX_K:
        raise ValueError(f"sym_eig: the warp body takes k up to "
                         f"{WARP_MAX_K}, not {k}")
    return body


def _launch_wide(H: torch.Tensor, body: str, name: str, *extra):
    """One launch of K4w's exported `name`_{f32,f64} on H in the storage
    form `body` names (the workspace allocated here); (evals, V)."""
    k = H.shape[-1]
    batch = H.numel() // (k * k)
    evals = torch.empty(H.shape[:-1], dtype=H.dtype, device=H.device)
    V = torch.empty_like(H)
    work = None
    if body == "wide_workspace":
        work = torch.empty(batch * wide_scratch_bytes(k, H.element_size()),
                           dtype=torch.uint8, device=H.device)
    call = _build.function("syev", f"{name}_{SUFFIX[H.dtype]}", _SIGNATURES)
    err = _build.launch(call, H.device, H.data_ptr(), evals.data_ptr(),
                        V.data_ptr(), None if work is None else work.data_ptr(),
                        k, batch, *extra)
    if err != 0:
        raise RuntimeError(f"sym_eig kernel ({body}) launch failed: "
                           f"cudaError {err}")
    return evals, V


reset_counts(sym_eig)

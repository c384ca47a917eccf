"""ctypes bindings of the native runtime components in native/: the g2o
parser (g2o_parser.c) and GreedyESP's lazy-greedy selection cores
(esp_lazy.cc: closed-form chain Gram entries, entries from a float32 or
float64 solve matrix Z, or a dense Gram matrix).

The shared library native/libmac_native.so is built from the repository's
sources with `make -C native` (build(), or on first use when it is
missing). When it cannot be built or loaded, each function returns None
and the caller falls back to Python. MAC_TPU_NO_NATIVE=1 forces that
fallback (the same switch as mac_tpu's).
"""

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libmac_native.so"
_lib = None
_tried = False


def build(quiet: bool = True) -> bool:
    """Build the shared library in-tree with `make -C native` (its output
    captured when quiet); whether the library exists afterwards."""
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=quiet)
    except (OSError, subprocess.CalledProcessError):
        return False
    return _SO.exists()


def lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use if necessary) the native library; None
    when MAC_TPU_NO_NATIVE is set or the library cannot be built or
    loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MAC_TPU_NO_NATIVE"):
        return None
    if not _SO.exists() and not build():
        return None
    try:
        L = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    L.g2o_count_se2.restype = ctypes.c_long
    L.g2o_count_se2.argtypes = [ctypes.c_char_p]
    L.g2o_count_se3.restype = ctypes.c_long
    L.g2o_count_se3.argtypes = [ctypes.c_char_p]
    L.g2o_parse.restype = ctypes.c_long
    L.g2o_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    tail = [i64p, i64p, f64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
    signatures = {
        # (G (m, m), w, m, ks, nks, order)
        "esp_lazy_select": [f64p, f64p, ctypes.c_int64, i64p,
                            ctypes.c_int64, i64p],
        # (rcum, lo, hi, w, m, ks, nks, order)
        "esp_lazy_select_chain": [f64p] + tail,
        # (Z (n, m), u, v, w, m, ks, nks, order)
        "esp_lazy_select_zd": [f64p] + tail,
        "esp_lazy_select_zf": [ctypes.POINTER(ctypes.c_float)] + tail,
    }
    for name, argtypes in signatures.items():
        fn = getattr(L, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _lib = L
    return _lib


def g2o_parse_arrays(path: str):
    """Native g2o parse: returns (se2 (n,11) f64, se3 (n,30) f64) or None."""
    L = lib()
    if L is None:
        return None
    p = str(path).encode()
    n2 = L.g2o_count_se2(p)
    n3 = L.g2o_count_se3(p)
    if n2 < 0 or n3 < 0:
        return None
    se2 = np.zeros((max(n2, 1), 11), dtype=np.float64)
    se3 = np.zeros((max(n3, 1), 30), dtype=np.float64)
    rc = L.g2o_parse(
        p,
        se2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n2,
        se3.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n3,
    )
    if rc < 0:
        return None
    return se2[:n2], se3[:n3]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _select(fn, first: np.ndarray, first_ctype, arrays, m: int,
            ks) -> Optional[np.ndarray]:
    """Call one selection core: (first, *arrays, m, ks, len(ks), order);
    the (kmax,) selection order, or None on a non-zero return. Each of
    `arrays` holds one entry per candidate and the budgets are nested
    within 1..m, checked here: the C code trusts them."""
    ks_arr = np.ascontiguousarray(ks, dtype=np.int64)
    if any(a.shape != (m,) for a in arrays):
        raise ValueError(f"per-candidate arrays must have shape ({m},)")
    if not (ks_arr.size and ks_arr[0] > 0 and ks_arr[-1] <= m
            and np.all(np.diff(ks_arr) >= 0)):
        raise ValueError(f"budgets {ks_arr.tolist()} not nested in 1..{m}")
    order = np.zeros(int(ks_arr[-1]), dtype=np.int64)
    args = [_ptr(first, first_ctype)]
    for a in arrays:
        args.append(_ptr(a, ctypes.c_int64 if a.dtype == np.int64
                         else ctypes.c_double))
    rc = fn(*args, m, _ptr(ks_arr, ctypes.c_int64), len(ks_arr),
            _ptr(order, ctypes.c_int64))
    return order if rc == 0 else None


def esp_lazy_select_chain(rcum: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                          w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Lazy-greedy k-ESP+ selection with closed-form chain Gram entries
    max(0, rcum[min(hi_p, hi_e)] - rcum[max(lo_p, lo_e)]) for the nested
    budgets ks: the (ks[-1],) selection order, or None when the library
    is unavailable."""
    L = lib()
    if L is None:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    if len(lo) and not (0 <= lo.min() and hi.max() < len(rcum)):
        raise ValueError("chain endpoints outside the cumulative resistances")
    return _select(L.esp_lazy_select_chain,
                   np.ascontiguousarray(rcum, dtype=np.float64),
                   ctypes.c_double,
                   [lo, hi, np.ascontiguousarray(w, dtype=np.float64)],
                   len(lo), ks)


def esp_lazy_select_z(Z: np.ndarray, u: np.ndarray, v: np.ndarray,
                      w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Lazy-greedy selection with Gram entries G[p, e] = Z[u_p, e] -
    Z[v_p, e] from the (n, m) solve matrix Z, float32 or float64 (the
    score algebra is float64 either way): the selection order, or None
    when the library is unavailable."""
    L = lib()
    if L is None:
        return None
    if Z.dtype == np.float32:
        fn, ctype = L.esp_lazy_select_zf, ctypes.c_float
    else:
        fn, ctype = L.esp_lazy_select_zd, ctypes.c_double
    Z = np.ascontiguousarray(Z, dtype=np.float32 if ctype is ctypes.c_float
                             else np.float64)
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    if len(u) and not (0 <= min(u.min(), v.min())
                       and max(u.max(), v.max()) < Z.shape[0]):
        raise ValueError("candidate endpoints outside Z's rows")
    return _select(fn, Z, ctype,
                   [u, v, np.ascontiguousarray(w, dtype=np.float64)],
                   Z.shape[1], ks)


def esp_lazy_select(G: np.ndarray, w: np.ndarray, ks) -> Optional[np.ndarray]:
    """Lazy-greedy selection over the dense (m, m) Gram matrix G: the
    selection order, or None when the library is unavailable."""
    L = lib()
    if L is None:
        return None
    G = np.ascontiguousarray(G, dtype=np.float64)
    if G.ndim != 2 or G.shape[0] != G.shape[1]:
        raise ValueError(f"G has shape {G.shape}, want (m, m)")
    return _select(L.esp_lazy_select, G, ctypes.c_double,
                   [np.ascontiguousarray(w, dtype=np.float64)],
                   G.shape[0], ks)

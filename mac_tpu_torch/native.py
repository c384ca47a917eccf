"""ctypes binding of the native g2o parser (native/g2o_parser.c).

The shared library native/libmac_native.so is built from the repository's
C source with `make -C native` (on first use when it is missing). When it
cannot be built or loaded, `g2o_parse_arrays` returns None and the caller
parses in Python.
"""

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libmac_native.so"
_lib = None
_tried = False


def lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use if necessary) the native library."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SO.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError):
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

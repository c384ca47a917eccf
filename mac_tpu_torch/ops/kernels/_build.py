"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source in mac_tpu_torch/csrc/ has a plain C interface, so it compiles
in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/mac_tpu_torch/lib<name>-<hash>.so <name>.cu

The library goes to build/mac_tpu_torch/ beside the package, named by a hash
of its source and flags, and is built at first use and reused after; nvcc's
report (ptxas's registers, stack frame and spills per kernel) is kept beside
it as lib<name>-<hash>.ptxas.txt, so a reused library still has its report
(ptxas_log). Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "mac_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}
_functions = {}  # (name, exported function) -> its ctypes function
build_log = []  # (name, seconds, nvcc stderr) per build in this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of mac_tpu_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def report_path(name: str) -> Path:
    """Where nvcc's report of library_path(name)'s build is kept."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source and its
    report exist. nvcc's stderr (the -Xptxas -v register and shared-memory
    report) is written to report_path(name) and kept in build_log."""
    out, report = library_path(name), report_path(name)
    if out.exists() and report.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, out)
    build_log.append((name, time.perf_counter() - t0, proc.stderr))
    return out


def ptxas_log(name: str) -> str:
    """nvcc's report of the library build(name) returns, built now or by an
    earlier process."""
    build(name)
    return report_path(name).read_text()


def load(name: str, signatures, path=None) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; `signatures` maps each
    exported C function to its ctypes argtypes (every function returns the
    int cudaError_t of its launch). With `path`, load that library instead
    (another build exporting the same functions, as kernel_ab.py's A/B
    does) and make it the one the wrappers call from then on: the handles
    that `function` keeps for `name` are dropped."""
    lib = None if path is not None else _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name) if path is None else path))
        for fn, argtypes in signatures.items():
            if not hasattr(lib, fn):  # an older build without this export
                continue
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
        for key in [key for key in _functions if key[0] == name]:
            del _functions[key]
    return lib


def loaded_files() -> tuple:
    """((source name, library file), ...) of the libraries loaded now."""
    return tuple(sorted((name, lib._name) for name, lib in _loaded.items()))


def function(name: str, fn: str, signatures):
    """The exported C function `fn` of csrc/<name>.cu as a ctypes function,
    resolved at its first call and kept: a wrapper's launch costs one dict
    lookup here. It follows `load(name, signatures, path)`."""
    call = _functions.get((name, fn))
    if call is None:
        call = _functions[(name, fn)] = getattr(load(name, signatures), fn)
    return call


def launch(call, device: torch.device, *args) -> int:
    """Call the ctypes function `call` with `args` and, as its last
    argument, PyTorch's current stream on the CUDA device `device`, with
    that device current: it is switched only when it is not already. The
    function's cudaError_t."""
    if device.index == torch.cuda.current_device():
        return call(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return call(*args, torch.cuda.current_stream().cuda_stream)

#!/usr/bin/env python3
"""A/B of the port's CUDA kernels against an older copy of their sources,
in one process on one NVIDIA GPU.

    mkdir -p build/ab_old
    git show <commit>:mac_tpu_torch/csrc/tridiag.cu > build/ab_old/tridiag.cu
    git show <commit>:mac_tpu_torch/csrc/assemble.cu > build/ab_old/assemble.cu
    python3 kernel_ab.py build/ab_old

The older sources must export the same C functions. Both versions are built
with the package's nvcc flags and loaded by _build.load(name, signatures,
path), so both run behind the same wrappers, checks and allocations. In
turns old, new, new, old, at the main paths' shapes (chip_smoke.py's):
  1. K1 tridiag_solve at city10000's chain factor (10000, 4); K2b
     assemble_ut at city10000's tables and K2 at the n = 700 graph, beside
     the same scatter as one index_add_ into a zeroed ut; K1b
     tridiag_solve_blocked at the n = 100000 two-grid chain factor (q 4):
     each with its device time (chip_smoke.device_ms), the time of one call
     with its host work (chip_smoke.call_ms) and its error against the
     plain version;
  2. K1's error against a float64 solve of city10000's chain factor, for
     the old and new kernels and the plain version in float32;
  3. one warm city10000 solve per turn: wall (unprofiled) and the relaxed
     lambda_2's gap to the reference optimum; then the same solve with K1's
     plain version in the kernel's place on the card, and on the CPU (every
     kernel's plain version): how far the float32 trajectory moves when
     only the summation order of the chain solve changes;
  4. one warm solve per version under torch.profiler with CUDA activity
     alone: the device time of K1 and K2b in that solve and the whole
     device busy time.
Every timing line names the card and its power limit.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

from chip_smoke import (REFERENCE_LAM2_UNROUNDED, SCALE_N, call_ms, card_line,
                        city10000_inputs, device_ms, fail,
                        index_add_assembly, k2_args, pose_graph, synthetic)

TURNS = ("old", "new", "new", "old")


def build_old(old_dir: Path) -> dict:
    """nvcc each older source into build/ab/; {name: path of the library}."""
    from mac_tpu_torch.ops.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("tridiag", "assemble"):
        out = out_dir / f"lib{name}-old.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(old_dir / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            fail(f"nvcc failed for the older {name}.cu:\n{proc.stderr}")
        print(f"old {name}.cu: " + " | ".join(
            ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "smem" in ln), flush=True)
        libs[name] = out
    return libs


def main():
    import numpy as np
    import torch

    if len(sys.argv) != 2:
        fail("usage: python3 kernel_ab.py OLD_CSRC_DIR")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    card = card_line()
    print(card, flush=True)
    from mac_tpu_torch.ops import banded, laplacian
    from mac_tpu_torch.ops import tridiag as ops_tridiag
    from mac_tpu_torch.ops.kernels import _build, assemble, tridiag
    from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
    from mac_tpu_torch.ops.kernels.tridiag import (
        tridiag_solve, tridiag_solve_blocked, tridiag_solve_blocked_plain,
        tridiag_solve_plain)
    from mac_tpu_torch.ops.tridiag import tridiag_ldl_auto
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    sigs = {"tridiag": tridiag._SIGNATURES, "assemble": assemble._SIGNATURES}
    libs = {"old": build_old(Path(sys.argv[1])),
            "new": {name: _build.build(name) for name in sigs}}
    for src, secs, log in _build.build_log:
        print(f"new {src}.cu: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "smem" in ln), flush=True)

    def use(version):
        for name, path in libs[version].items():
            _build.load(name, sigs[name], path)

    dev = torch.device("cuda")
    (_, n, fixed, cands, k, x_init, bop, w, dp1, l1,
     B1) = city10000_inputs(dev)
    args_b = k2_args(bop, w)
    idx_s, w_s, n_s = pose_graph(700, 120, 40, 3)
    bop_s = banded.build_banded_rcm(idx_s, n_s)[0].to(dev)
    args_s = k2_args(bop_s, torch.as_tensor(w_s, dtype=torch.float32,
                                            device=dev))
    fi5, wf5, ci5, wc5 = synthetic(SCALE_N, seed=0, local=False)
    x5 = np.zeros(len(wc5))
    x5[np.argpartition(wc5, -(len(wc5) // 4))[-(len(wc5) // 4):]] = 1.0
    op5 = laplacian.build_operator(np.concatenate([fi5, ci5]), SCALE_N).to(dev)
    w5 = torch.as_tensor(np.concatenate([wf5, x5 * wc5]), dtype=torch.float32,
                         device=dev)
    d5, e5 = laplacian.lap_tridiagonal_part(op5, w5)
    f5 = tridiag_ldl_auto(d5 + 100 * torch.finfo(torch.float32).eps * d5.max(),
                          e5)
    dp5, l5 = f5.dp.float().contiguous(), f5.l.float().contiguous()
    B5 = torch.randn((SCALE_N, 4),
                     generator=torch.Generator().manual_seed(0)).to(dev)

    # ---- 1. kernel times, in turns
    cases = [
        ("K1 tridiag_solve (10000, 4)", lambda: tridiag_solve(dp1, l1, B1),
         lambda: tridiag_solve_plain(dp1, l1, B1), None),
        ("K2b assemble_ut city10000", lambda: assemble_ut(*args_b),
         lambda: assemble_ut_plain(*args_b), index_add_assembly(args_b)),
        ("K2 assemble_ut n 700", lambda: assemble_ut(*args_s),
         lambda: assemble_ut_plain(*args_s), index_add_assembly(args_s)),
        (f"K1b tridiag_solve_blocked ({SCALE_N}, 4)",
         lambda: tridiag_solve_blocked(dp5, l5, B5),
         lambda: tridiag_solve_blocked_plain(dp5, l5, B5), None),
    ]
    results = {}
    for label, kern, plain, library in cases:
        ref = plain()
        for version in TURNS:
            use(version)
            got = kern()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            ok = (torch.equal(got, ref) if "assemble" in label
                  else torch.allclose(got, ref, rtol=2e-4, atol=2e-4))
            if not ok:
                fail(f"{version} {label} disagrees with its plain version "
                     f"({err:.3e})")
            dms, cms = device_ms(kern), call_ms(kern)
            results.setdefault(label, {}).setdefault(version, []).append(dms)
            print(f"{version} {label}: device {dms:.5f} ms, call {cms:.4f} "
                  f"ms, max|kernel - plain| {err:.2e} ({card})", flush=True)
        if library is not None:
            print(f"index_add_ yardstick for {label}: device "
                  f"{device_ms(library):.5f} ms, call {call_ms(library):.4f} "
                  f"ms ({card})", flush=True)
    for label, by in results.items():
        old, new = statistics.median(by["old"]), statistics.median(by["new"])
        print(f"summary {label}: device old {old:.5f} ms, new {new:.5f} ms, "
              f"new/old {new / old:.3f} ({card})", flush=True)

    # ---- 2. K1's error against float64 on city10000's chain factor
    X64 = tridiag_solve_plain(dp1.double(), l1.double(), B1.double())
    scale = float(X64.abs().max())
    for label, version in (("old K1", "old"), ("new K1", "new"),
                           ("plain version (float32)", None)):
        if version is None:
            X = tridiag_solve_plain(dp1, l1, B1)
        else:
            use(version)
            X = tridiag_solve(dp1, l1, B1)
        err = float((X.double() - X64).abs().max())
        print(f"{label} at (10000, 4) against float64: max abs error "
              f"{err:.3e}, relative to max|X| {err / scale:.3e}", flush=True)

    # ---- 3. warm city10000 solves: wall and the relaxed gap
    mac = MAC(fixed, cands, n, device="cuda")

    def solve(m=mac):
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, unrounded, _ = m.solve(k, x_init, rounding="nearest",
                                  use_cache=True)
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lam2 = scipy_lam2(m.laplacian(unrounded))
        return (wall, lam2,
                (lam2 - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED)

    for version in ("old", "new"):
        use(version)
        solve()  # warms the caches of this version
    for version in TURNS:
        use(version)
        wall, lam2, gap = solve()
        print(f"{version} city10000 warm solve: wall {wall:.4f} s unprofiled;"
              f" relaxed lambda_2 {lam2:.10g}, gap {gap:+.4e} ({card})",
              flush=True)
    with mock.patch.object(ops_tridiag, "tridiag_solve", tridiag_solve_plain):
        _, lam2, gap = solve()
    print(f"K1's plain version on the card, city10000 solve: relaxed "
          f"lambda_2 {lam2:.10g}, gap {gap:+.4e}", flush=True)
    _, lam2, gap = solve(MAC(fixed, cands, n, device="cpu"))
    print(f"the port on the CPU (every plain version), city10000 solve: "
          f"relaxed lambda_2 {lam2:.10g}, gap {gap:+.4e}", flush=True)

    # ---- 4. the device time of the kernels in one profiled warm solve
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for version in ("old", "new"):
        use(version)
        t1, t2 = tridiag_solve.launches, assemble_ut.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pwall = solve()[0]
        sums = {"tridiag_solve_kernel": [0.0, 0], "assemble_ut_kernel": [0.0, 0],
                "busy": [0.0, 0]}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
            sums["busy"][0] += us
            sums["busy"][1] += 1
            for key in ("tridiag_solve_kernel", "assemble_ut_kernel"):
                if key in e.name and "blocked" not in e.name:
                    sums[key][0] += us
                    sums[key][1] += 1
        print(f"{version} city10000 warm solve profiled: wall {pwall:.4f} s;"
              f" device busy {sums['busy'][0] / 1e3:.2f}"
              f" ms over {sums['busy'][1]} kernels and copies; K1 "
              f"{sums['tridiag_solve_kernel'][0] / 1e3:.3f} ms over "
              f"{sums['tridiag_solve_kernel'][1]} launches (wrapper counted "
              f"{tridiag_solve.launches - t1}); K2b "
              f"{sums['assemble_ut_kernel'][0] / 1e3:.3f} ms over "
              f"{sums['assemble_ut_kernel'][1]} launches (wrapper counted "
              f"{assemble_ut.launches - t2}) ({card})", flush=True)


if __name__ == "__main__":
    main()

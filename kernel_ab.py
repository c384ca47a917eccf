#!/usr/bin/env python3
"""A/B of the port's CUDA kernels against an older copy of their sources,
in one process on one NVIDIA GPU.

    mkdir -p build/ab_old
    git show <commit>:mac_tpu_torch/csrc/tridiag.cu > build/ab_old/tridiag.cu
    git show <commit>:mac_tpu_torch/csrc/assemble.cu > build/ab_old/assemble.cu
    python3 kernel_ab.py [--kernels-only | --syev-only | --banded-only |
        --cg-only] build/ab_old [VARIANT_DIR ...]
    python3 kernel_ab.py --ell-only build/ab_old

(and, to time the chain factor's kernels too, the older ldl.cu beside
them: git show <commit>:mac_tpu_torch/csrc/ldl.cu > build/ab_old/ldl.cu;
the Rayleigh-Ritz eigensolver K4 likewise with the older syev.cu, the
banded product K5 with the older banded.cu; --ell-only takes the older
ell.cu alone).

The older sources must export the same C functions. Both versions are
built at once (one nvcc a source) with the package's nvcc flags and loaded
by _build.load(name, signatures, path), so both run behind the same
wrappers, checks and allocations: the wrappers keep the C functions they
resolved (_build.function), and _build.load with a path drops those
handles, so the next call of a wrapper goes to the library loaded last.
In turns old, new, new, old, at the main paths' shapes (chip_smoke.py's):
  1. K1 tridiag_solve at city10000's chain factor (10000, 4); K2b
     assemble_ut at city10000's tables and K2 at the n = 700 graph, beside
     the same scatter as one index_add_ into a zeroed ut; K1b
     tridiag_solve_blocked at the n = 100000 two-grid chain factor (q 4 and
     q 32) and at (1024, 1), the smallest launch its wrapper can make (the
     launch floor of this way of timing); where the older directory holds
     ldl.cu, K3b tridiag_ldl_blocked at city10000's chain factor (block
     128, float32 and float64), the n = 100000 two-grid chain (block
     1024) and the sweeps' lanes (8, 10000) and (2, 100000), and K3
     tridiag_ldl at sphere2500's (float32 and float64) and at 32768 rows:
     each with its device time
     (chip_smoke.device_ms), the time of one call with its host work
     (chip_smoke.call_ms) and its error against the plain version
     (K3b bitwise), then the new build's chain probe (one step of K3b's
     pivot chain and of K3's carry, chip_smoke.ldl_step_ns) and each
     factor case's phases (chip_smoke.ldl_phases). Where
     the older directory also holds tridiag.py, an older copy of
     mac_tpu_torch/ops/kernels/tridiag.py, the call times of K1 and K1b
     through that module's wrappers stand beside the current wrappers', on
     the new kernels. Where the older directory holds syev.cu, K4
     sym_eig on phase 3e's four Rayleigh-Ritz matrices of TRACEMIN, the
     lanes' batches (8, 12, 12) float32 and (64, 12, 12) float64, and
     random symmetric matrices of every k from 1 to 32 in both types, and
     K4w on TRACEMIN's 33 x 33 at city10000's start weights (q = 11, both
     types), random (96, 96) in both types, the lanes' (2, 36, 36) (q =
     12), random (2, k, k) for k 33 to 64 and (120, 120) in both types,
     and (170, 170) float32 and (130, 130) float64 on the workspace form
     (past the three-pass kernel's shared-memory orders, 168 and 118, both
     versions take
     the workspace): the number of matrices whose eigenvalues or vectors
     are not bitwise the older kernel's (by K4 and K4w), device and call
     times in turns, torch.linalg.eigh's device time (kernels_ms) beside
     them, each library's launch floor (a 1 x 1 matrix), one round of the
     irreducible chain (the new library's one-warp probe, k4_round_ms)
     and K4w's round with its two barriers (the block probe at the new
     blocks' threads), the new K4w instantiations' frames
     (k4w_frame_gate), and K4w's round by phase (k4w_phases) at 33 and 96
     in both types for each version: an older syev.cu without stamps of
     its own is built with ab_fixtures/syev_three_pass_phases.cu appended
     (the three-pass K4w of commit 9f43cf3, stamped); each build's
     registers, stack frame and spills per K4 and K4w instantiation are
     printed at the build. With
     --syev-only only syev.cu is built (old and new) and only this runs.
     Where the older directory holds banded.cu, K5 banded_product at every
     shape of chip_smoke.py's phase 3f (chip_smoke.k5_cases, the same
     inputs): each version's two calls bitwise equal and its error
     against the plain version, device and call times in turns, the
     bound and the BSR torch.sparse.mm yardstick, old / new per shape
     (the older kernel's dot partials fit the current wrapper's scratch
     in its narrow body, and phase 3f's wide cases take no dots), then
     at (10000, 4) (inner and plain) and float64 plain each version's
     time after a 64 MB memset that leaves ut out of L2; with
     --banded-only only banded.cu is built and only this runs;
  2. K1's error against a float64 solve of city10000's chain factor, and
     K1b's against a float64 blocked solve of the n = 100000 chain factor,
     for the old and new kernels and the plain version in float32;
  3. one warm city10000 solve per turn: wall (unprofiled) and the relaxed
     lambda_2's gap to the reference optimum; then the same solve with K1's
     plain version in the kernel's place on the card, and on the CPU (every
     kernel's plain version): how far the float32 trajectory moves when
     only the summation order of the chain solve changes; then the same for
     the matrix-free path: one warm n = 100000 solve(K, x_init,
     max_iters=10) per turn with its wall and the gap of evaluate_objective
     to the reference library's lambda_2, and once with K1b's plain version
     in the kernel's place on the card; with syev.cu or ldl.cu in the
     older directory also sphere2500 (MAC(fixed, cands, n)) and the banded
     float64 city10000 (max_iters=20) per turn. Each version solves with a
     MAC of its own: a solve replays CUDA graphs captured at its first
     call, which hold the kernels of the library loaded then; the solves
     with a plain version in a kernel's place run eagerly
     (chip_smoke.SolvePath("eager")) so that the plain version runs;
  4. one warm solve per version and path under torch.profiler with CUDA
     activity alone: the device time of K1, K2b, K4 and K3b (city10000),
     of K1b, K4 and K3b (n = 100000) and of K3, K1 and K4 (sphere2500,
     with ldl.cu or syev.cu in the older directory) in that solve and the
     whole device busy time.
Each further VARIANT_DIR holds another tridiag.cu (a step of a design, a
tuning constant edited, a part of the kernel taken out to see what it
costs): its K1b is timed after the turns of part 1 and its error printed in
part 2, and nothing else runs on it; a variant that disagrees with the
plain version is marked and timed all the same. --kernels-only stops after
part 2. With --banded-only each VARIANT_DIR holds another banded.cu
instead, timed at every K5 shape after that shape's turns (the read-once
narrow bodies of ab_fixtures/k5_read_once_tma and
ab_fixtures/k5_read_once_cp_async take a scratch of terms, which this
script hands them).
With --cg-only the older directory holds tridiag.cu and banded.cu (K1p's
and K7's sources), pcg.cu (K6's), or all three, and only they are built
and only this runs. With tridiag.cu and banded.cu: K1p
tridiag_solve_permuted and K7 coarse_correct at every shape of
chip_smoke.py's phase 3f (chip_smoke.k1p_cases, k7_cases, the same
inputs), in turns old, new, new, old: each version's two calls bitwise
equal, its error against the plain version, whether its output is bitwise
the older version's, device and call times, the bound, old / new per
shape; the older K1p runs its cluster body on every factor (the only body
before the segment body), the new one the body of the factor's seg; an
older K7 whose export takes a float64 scratch (its earlier two launches) is
called through an adapter that hands it one. Then each version's launch
floors (chip_smoke.launch_floors) and, at (10000, 4), each version's time
after a 64 MB memset that leaves its inputs out of L2. Each VARIANT_DIR
then holds another tridiag.cu, banded.cu or both, whose K1p or K7 is timed
at every shape of its kernel after that shape's turns, its output held
bitwise to the new version's (ab_fixtures/k7_cluster: K7 as one launch of
a thread-block cluster). With pcg.cu: K6 at phase 3f's shapes
(chip_smoke.k6_cases: (10000, 4) float32 and float64, (8, 10000, 4)) in
turns old, new, new, old: col_sums (the dots R . Z, Z centred), cg_update
with R's sums, and the second pass with the dots and P's sums (the new
cg_direction_dots, one cooperative launch, against the older library's
col_sums and cg_direction, two launches, whose export this script calls
itself; in float32 also the first step's form): each version's two calls
bitwise equal, its error against the plain version, whether its output is
bitwise the older version's, whether its rz_new is bitwise its own
col_sums(R, Z, zsum), device and call times, new / old per shape; then
each version's launch floors (chip_smoke.k6_floors) and, at (10000, 4)
float32, each version's time after a 64 MB memset that leaves its inputs
out of L2.
With --ell-only the older directory holds ell.cu (K8, the matrix-free
route's ELL product), and only it is built (old and new at once, each
build's registers and spills printed): at every shape of chip_smoke.py's
phase 3f (chip_smoke.k8_cases on chip_smoke.ell_inputs, the same inputs),
in turns old, new, new, old, each version on the tables in its own
layout: an older ell.cu whose export takes no row counts (before the
slot-major tables) is called here on the operator's row-major tables,
nbr_tbl as int32 (n, dmax) and the weight table transposed to (n, dmax),
both made once a shape, with the current wrapper's scratch; each
version's device and call times, new / old (medians of the turns),
whether the new outputs and dots are bitwise the old version's, the
error against the plain version, the restated bound (chip_smoke.k8_cases'
least bytes of the work); then the plain version's and CSR
torch.sparse.mm's device times (the plain version's at 20 calls a
timing, its kernels filling the launch queue sooner); each version's
launch floor (n 1, q 1, one slot) and, at (100000, 4) in the plain form
and the inner form with the dots, each version's time after a 64 MB
memset that leaves the tables and V out of L2. Each VARIANT_DIR then
holds another ell.cu with the current export (a design step), timed at
every shape after that shape's turns, its outputs held bitwise to the
new version's.
Every timing line names the card and its power limit.
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

from chip_smoke import (BUNDLED, REFERENCE_LAM2_SCALE,
                        REFERENCE_LAM2_UNROUNDED, SCALE_N, SolvePath, call_ms,
                        card_line, dataset_inputs, device_ms, fail,
                        index_add_assembly, k2_args, k4_instances,
                        k4_round_ms, k4w_frame_gate, k4w_instances,
                        k4w_phase_line, k4w_phases, kernels_ms, ldl_phases,
                        ldl_step_ns, pose_graph, ptxas_report,
                        rayleigh_ritz_matrices, synthetic)

TURNS = ("old", "new", "new", "old")


# The stamps of the three-pass K4w (its shared-memory form), compiled onto an
# older syev.cu that has none of its own (see the file).
THREE_PASS_STAMPS = Path(__file__).resolve().parent / "ab_fixtures" / (
    "syev_three_pass_phases.cu")


def build_one(src_dir: Path, tag: str, name: str):
    """nvcc src_dir/<name>.cu into build/ab/ (an older syev.cu without
    sym_eig_wide_phases_* with THREE_PASS_STAMPS appended); (path of the
    library, nvcc's report)."""
    from mac_tpu_torch.ops.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}-{tag}.so"
    src = (src_dir / f"{name}.cu").resolve()
    if name == "syev" and "sym_eig_wide_phases_" not in src.read_text():
        stamped = out_dir / f"syev-{tag}-stamped.cu"
        stamped.write_text(f'#include "{src}"\n'
                           f'#include "{THREE_PASS_STAMPS}"\n')
        src = stamped
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc failed for {src}:\n{proc.stderr}")
    return out, proc.stderr


def build_all(old_dir: Path, names, variant_dirs, vname="tridiag"):
    """The older sources' libraries, the current ones (_build.build) and
    each variant's <vname>.cu, one nvcc each, all at once; {version: {name:
    library}}, each build's report printed."""
    from concurrent.futures import ThreadPoolExecutor

    from mac_tpu_torch.ops.kernels import _build

    with ThreadPoolExecutor(2 * len(names) + len(variant_dirs)) as pool:
        old = {name: pool.submit(build_one, old_dir, "old", name)
               for name in names}
        new = {name: pool.submit(_build.build, name) for name in names}
        var = {f"variant {Path(d).name}": pool.submit(
            build_one, Path(d), f"variant-{Path(d).name}", vname)
            for d in variant_dirs}
        libs = {"old": {name: f.result()[0] for name, f in old.items()},
                "new": {name: f.result() for name, f in new.items()}}
        libs.update({tag: {vname: f.result()[0]}
                     for tag, f in var.items()})
    for name, f in old.items():
        print_ptxas("old", name, f.result()[1])
    for src, secs, _ in _build.build_log:
        print(f"new {src}.cu built in {secs:.1f} s", flush=True)
    for name in names:
        print_ptxas("new", name, _build.ptxas_log(name))
    for tag, f in var.items():
        print_ptxas(tag, vname, f.result()[1])
    return libs


def print_ptxas(tag: str, name: str, log: str) -> None:
    """A build's registers, stack frame and spills per entry function
    (per K4 instantiation, by type and even size m, and per K4w one, by
    type and storage form, for syev.cu)."""
    if k4_instances(log):
        print(f"{tag} syev.cu (registers, stack frame bytes, spill stores, "
              f"spill loads): " + ", ".join(
                  f"{dt} m {m}: {v}"
                  for (dt, m), v in sorted(k4_instances(log).items()))
              + "; K4w " + ", ".join(
                  f"{dt} {form}: {v}"
                  for (dt, form), v in sorted(k4w_instances(log).items())),
              flush=True)
        return
    print(f"{tag} {name}.cu: " + " | ".join(
        f"{fn[-40:]}: {regs} registers, stack {stack}, spills {st}/{ld}"
        for fn, regs, stack, st, ld in ptxas_report(log)), flush=True)


def enqueue_us(fn, reps: int = 2000) -> float:
    """Host microseconds to enqueue one call of fn(): `reps` calls back to
    back on the host clock with no synchronisation between them (the
    device, faster than the host here, never fills its queue)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def device_profile(run, keys):
    """run() under torch.profiler with CUDA activity alone: its return
    value and {key: [device microseconds, events]} for each kernel-name
    test in keys (name -> predicate) and for "busy", every device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
    sums = {key: [0.0, 0] for key in (*keys, "busy")}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        for key in sums:
            if key == "busy" or keys[key](e.name):
                sums[key][0] += us
                sums[key][1] += 1
    return out, sums


# The orders up to which the three-pass K4w took its shared-memory form; past
# them an A/B against a build of that source runs both versions on the
# workspace (body "wide_workspace"), so that each input takes one form in
# both.
THREE_PASS_SHARED_MAX = {"float32": 168, "float64": 118}


def k4_ab(use, card, bop, w, dev):
    """K4 and K4w old against new in turns (part 1 of the module
    docstring)."""
    import numpy as np
    import torch

    from mac_tpu_torch.ops.kernels import _build, syev

    use("new")
    mats = rayleigh_ritz_matrices(bop, w, dev)
    rng = np.random.RandomState(14)
    main_cases = [(f"TRACEMIN's {k}x{k} {dt}", mats[(k, dt)], None)
                  for dt in ("float32", "float64") for k in (4, 12)]

    def perturbed(H, R):
        A = torch.as_tensor(rng.normal(size=(R,) + tuple(H.shape)),
                            dtype=H.dtype, device=dev)
        return (H + 1e-2 * float(torch.linalg.matrix_norm(H))
                * (A + A.mT) / 2).contiguous()

    for R, dt in ((8, "float32"), (64, "float64")):
        main_cases.append((f"lanes ({R}, 12, 12) {dt}",
                           perturbed(mats[(12, dt)], R), None))
    # K4w: TRACEMIN's 33 x 33 (q = 11), random 96 x 96, the lanes' (2, 36,
    # 36) at q = 12.
    mats11 = rayleigh_ritz_matrices(bop, w, dev, q=11)
    mats12 = rayleigh_ritz_matrices(bop, w, dev, q=12)
    wide_main = [(f"K4w TRACEMIN's 33x33 {dt} (q = 11)", mats11[(33, dt)],
                  None) for dt in ("float32", "float64")]
    for dt in (torch.float32, torch.float64):
        A = rng.normal(size=(96, 96))
        wide_main.append((f"K4w random (96, 96) {str(dt)[6:]}",
                          torch.as_tensor(A + A.T, dtype=dt, device=dev),
                          None))
    wide_main.append(("K4w lanes (2, 36, 36) float32",
                      perturbed(mats12[(36, "float32")], 2), None))
    main_cases += wide_main
    main_labels = {label for label, _, _ in main_cases}
    cases = list(main_cases)
    for dt in (torch.float32, torch.float64):
        for k in range(1, 33):
            A = rng.normal(size=(3, k, k))
            cases.append((f"random (3, {k}, {k}) {str(dt)[6:]}",
                          torch.as_tensor(A + A.transpose(0, 2, 1),
                                          dtype=dt, device=dev), None))
    for dt, ws in ((torch.float32, 170), (torch.float64, 130)):
        for k in list(range(33, 65)) + [120, ws]:
            A = rng.normal(size=(2, k, k) if k <= 64 else (k, k))
            H = torch.as_tensor(A + np.swapaxes(A, -1, -2), dtype=dt,
                                device=dev)
            forced = k == ws or k > THREE_PASS_SHARED_MAX[str(dt)[6:]]
            cases.append((f"K4w random {tuple(H.shape)} {str(dt)[6:]}"
                          + (" on the workspace" if forced else ""), H,
                          "wide_workspace" if forced else None))
    one = torch.zeros(1, 1, device=dev)
    out, dev_ms, call = {}, {}, {}
    for version in TURNS:
        use(version)
        floor = device_ms(lambda: syev.sym_eig(one))
        print(f"{version} K4 launch floor (1 x 1): {floor:.5f} ms ({card})",
              flush=True)
        for label, H, body in cases:
            got = syev.sym_eig(H, body=body)
            torch.cuda.synchronize()
            out.setdefault(label, {}).setdefault(version, got)
            main = label in main_labels
            dms = device_ms(lambda: syev.sym_eig(H, body=body),
                            reps=100 if main else 20, rounds=5 if main else 3)
            dev_ms.setdefault(label, {}).setdefault(version, []).append(dms)
            if main:
                cms = call_ms(lambda: syev.sym_eig(H, body=body))
                call.setdefault(label, {}).setdefault(version, []).append(
                    cms)
                print(f"{version} K4 {label}: device {dms:.5f} ms, call "
                      f"{cms:.4f} ms ({card})", flush=True)
    use("new")
    lib = _build.load("syev", syev._SIGNATURES)
    threads = sorted({lib.sym_eig_wide_threads(k) for k in (33, 36, 96)})
    for dt in (torch.float32, torch.float64):
        print(f"K4 round of the irreducible chain, {dt}: "
              f"{1e6 * k4_round_ms(dt):.1f} ns; K4w's round with its two "
              f"barriers (block probe) at the new blocks' threads " + ", ".join(
                  f"{t} {1e6 * k4_round_ms(dt, t):.1f} ns" for t in threads)
              + f" ({card})", flush=True)
    differ = {"K4": [0, 0], "K4w": [0, 0]}
    for label, H, body in cases:
        (eo, Vo), (en, Vn) = out[label]["old"], out[label]["new"]
        b = H.numel() // H.shape[-1] ** 2
        same = [bool(torch.equal(eo.reshape(b, -1)[i], en.reshape(b, -1)[i])
                     and torch.equal(Vo.reshape(b, -1)[i],
                                     Vn.reshape(b, -1)[i]))
                for i in range(b)]
        group = differ["K4w" if H.shape[-1] > syev.WARP_MAX_K else "K4"]
        group[0] += same.count(False)
        group[1] += b
        old = statistics.median(dev_ms[label]["old"])
        new = statistics.median(dev_ms[label]["new"])
        more = ""
        if label in main_labels:
            more = (f", call old {statistics.median(call[label]['old']):.4f}"
                    f" ms, new {statistics.median(call[label]['new']):.4f} "
                    f"ms, torch.linalg.eigh device "
                    f"{kernels_ms(lambda: torch.linalg.eigh(H)):.5f} ms")
        print(f"summary K4 {label}: device old {old:.5f} ms, new {new:.5f} "
              f"ms, new/old {new / old:.3f}{more}; matrices not bitwise the "
              f"old kernel's {same.count(False)} of {b} ({card})",
              flush=True)
    for group, (n_differ, n_total) in differ.items():
        print(f"{group} outputs not bitwise the old kernel's: {n_differ} of "
              f"{n_total} matrices", flush=True)
    # K4w's round by phase, each version's stamped build (the older one
    # through THREE_PASS_STAMPS where its source has no stamps).
    for version in ("old", "new"):
        use(version)
        for label, H, _ in wide_main[:4]:
            print(f"{version} " + k4w_phase_line(label, k4w_phases(H), card),
                  flush=True)
    regs = k4w_frame_gate(_build.ptxas_log("syev"))
    print("new K4w instantiations (registers, stack frame bytes, spill "
          "stores, spill loads): " + ", ".join(
              f"{dt} {form}: {v}" for (dt, form), v in sorted(regs.items()))
          + " (the shared-memory form: 0-byte stack, no spills)", flush=True)


def use_banded_variant(path: Path, src: Path) -> None:
    """Load the library at `path`, built from the variant banded.cu `src`,
    behind the current K5 and K7 wrappers. A variant whose
    banded_product_* takes a scratch of terms after the ticket (the
    read-once narrow bodies in ab_fixtures/: lanes * nb * (2 half + 2) *
    split * 128 * q values, split at most 8, for q <= 16) is called
    through an adapter that hands it that scratch, allocated here at the
    first call of each size."""
    import ctypes

    import torch

    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import banded as kb

    if "T* terms" not in src.read_text():
        _build.load("banded", kb._SIGNATURES, path)
        return
    sigs = {fn: (types[:19] + [ctypes.c_void_p] + types[19:]
                 if fn.startswith("banded_product_") else types)
            for fn, types in kb._SIGNATURES.items()}
    lib = _build.load("banded", sigs, path)
    scratch = {}
    for fn in sigs:
        if not fn.startswith("banded_product_"):
            continue
        itemsize = 4 if fn.endswith("f32") else 8

        def call(*args, raw=getattr(lib, fn), itemsize=itemsize):
            n, q, nb, half, lanes = args[19:24]
            size = lanes * nb * (2 * half + 2) * 8 * 128 * q * itemsize
            ptr = 0
            if q <= kb.K5_NARROW_MAX_Q:
                if size not in scratch:
                    scratch[size] = torch.empty(size, dtype=torch.uint8,
                                                device="cuda")
                ptr = scratch[size].data_ptr()
            return raw(*args[:19], ptr, *args[19:])

        _build._functions[("banded", fn)] = call


def k5_ab(use, card, dev, bop, w, variants):
    """K5 (banded_product) old against new in turns at every phase-3f K5
    shape (chip_smoke.k5_cases, their inputs drawn as phase 3f draws
    them): each version's two calls bitwise equal and within phase 3f's
    tolerance of the plain version (a version that fails is marked, not
    fatal, so that both are timed), device and call times, the bound and
    the library call's device time, then old / new medians per shape;
    each variant ({tag: (library, source)}, use_banded_variant) timed
    after the
    turns the same way, with its time over new's; last, three shapes with
    ut cold in L2 (after a 64 MB memset)."""
    import numpy as np
    import torch

    from chip_smoke import bound, cg_inputs, k5_cases, rel_norm

    (_, _, _, _, _, _, bop_sp, w_sp, _, _, _) = dataset_inputs(
        dev, "sphere2500")
    use("new")
    rng = np.random.RandomState(18)
    cases = k5_cases(dev, bop, bop_sp, cg_inputs(dev, bop, w, bop_sp, w_sp,
                                                 rng), rng)
    times = {}
    for _, label, kern, plain, nbytes, flops, it, tol, lib, rate in cases:
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for version in TURNS + tuple(variants):
            if version in variants:
                use_banded_variant(*variants[version])
            else:
                use(version)
            a, b = kern(), kern()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            err = max(rel_norm(x, y) for x, y in zip(a, ref))
            dms, cms = device_ms(kern), call_ms(kern)
            times.setdefault(label, {}).setdefault(version, []).append(dms)
            print(f"{version} K5 {label}: device {dms:.5f} ms, call "
                  f"{cms:.4f} ms; relative error {err:.3e}, two calls "
                  f"bitwise {same}"
                  + ("" if same and err <= tol else " (FAILS phase 3f)")
                  + f" ({card})", flush=True)
        use("new")
        bms, by = bound(nbytes, flops, it, rate)
        print(f"K5 {label}: bound {bms:.5f} ms ({by})"
              + ("" if lib is None else
                 f", library (BSR torch.sparse.mm) device "
                 f"{device_ms(lib):.5f} ms") + f" ({card})", flush=True)
    for label, by in times.items():
        old, new = statistics.median(by["old"]), statistics.median(by["new"])
        print(f"summary K5 {label}: device old {old:.5f} ms, new {new:.5f} "
              f"ms, new/old {new / old:.3f}"
              + "".join(f", {v} {by[v][0]:.5f} ms ({by[v][0] / new:.3f} of "
                        f"new)" for v in variants)
              + f" ({card})", flush=True)
    # ut cold: each call after a 64 MB memset (past the 50 MB L2), the
    # memset's own device time taken off.
    flush = torch.empty(16 * 1024 * 1024, device=dev)
    memset_ms = device_ms(flush.zero_, reps=50)
    for key, label, kern, *_ in cases:
        if key not in ("K5", "K5_plain", "K5_f64_plain"):
            continue
        for version in TURNS:
            use(version)
            warm = device_ms(kern, reps=50)
            cold = device_ms(lambda: (flush.zero_(), kern()),
                             reps=50) - memset_ms
            print(f"{version} K5 {label}: device {warm:.5f} ms back to "
                  f"back, {cold:.5f} ms after a 64 MB memset (ut out of "
                  f"L2; the memset's {memset_ms:.5f} ms taken off) "
                  f"({card})", flush=True)


def use_old_k7(lib) -> None:
    """Call an older banded.cu's coarse_correct_* whose float64 scratch
    after lc_lane is larger (its earlier two launches: lanes * ceil(nc /
    16) * nc * q values) through an adapter that hands it one of that size
    in place of the current wrapper's."""
    import ctypes

    import torch

    from mac_tpu_torch.ops.kernels import _build

    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in ("coarse_correct_f32", "coarse_correct_f64"):
        raw = getattr(lib, fn)
        raw.argtypes = [P, P, P, P, L, P] + [I] * 5 + [P]
        raw.restype = ctypes.c_int

        def call(r, x, iperm, lc, lc_lane, rc, n, q, nc, s, lanes, stream,
                 raw=raw):
            xcp = torch.empty(lanes * -(-nc // 16) * nc * q,
                              dtype=torch.float64, device="cuda")
            return raw(r, x, iperm, lc, lc_lane, xcp.data_ptr(), n, q, nc, s,
                       lanes, stream)

        _build._functions[("banded", fn)] = call


def cg_ab(use, card, dev, bop, w, variants):
    """K1p and K7 old against new in turns at phase 3f's shapes (the
    module docstring's --cg-only); each variant ({tag: {source name:
    library}}) times the K1p cases (with a tridiag.cu) or the K7 cases
    (with a banded.cu) after their turns, its output held bitwise to the
    new version's."""
    import numpy as np
    import torch

    from chip_smoke import (bound, cg_inputs, k1p_cases, k7_cases,
                            launch_floors, rel_norm)
    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import banded as kbanded
    from mac_tpu_torch.ops.kernels import tridiag

    sigs = {"banded": kbanded._SIGNATURES, "tridiag": tridiag._SIGNATURES}

    (_, _, _, _, _, _, bop_sp, w_sp, _, _, _) = dataset_inputs(
        dev, "sphere2500")
    use("new")
    bds = cg_inputs(dev, bop, w, bop_sp, w_sp, np.random.RandomState(18))
    cases = k1p_cases(dev, bop, bop_sp, bds) + k7_cases(dev, bop, bop_sp,
                                                         bds)

    def runner(c, version):
        seg = c["seg"] if version == "new" else None
        return lambda: c["kernel"](seg)

    def checked(c, run):
        if c["fresh"] is not None:
            c["fresh"]()
        got = run()
        got = got if isinstance(got, tuple) else (got,)
        return tuple(t.clone() for t in got)

    times = {}
    for c in cases:
        if c["fresh"] is not None:
            c["fresh"]()
        ref = c["plain"]()
        ref = ref if isinstance(ref, tuple) else (ref,)
        first = {}
        for version in TURNS:
            use(version)
            run = runner(c, version)
            a, b = checked(c, run), checked(c, run)
            first.setdefault(version, a)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            err = max(rel_norm(x, y) for x, y in zip(a, ref))
            as_old = all(torch.equal(x, y) for x, y in zip(a, first["old"]))
            dms, cms = device_ms(run), call_ms(run)
            times.setdefault(c["label"], {}).setdefault(version, []).append(
                dms)
            body = (c["body"] if version == "new" or c["body"] is None
                    else "cluster")
            print(f"{version} {c['label']}" + (f" [{body} body]" if body
                                               else "")
                  + f": device {dms:.5f} ms, call {cms:.4f} ms; relative "
                  f"error {err:.3e}, two calls bitwise {same}, bitwise the "
                  f"old version's {as_old}"
                  + ("" if same and err <= c["tol"] else " (FAILS phase 3f)")
                  + f" ({card})", flush=True)
        src = "banded" if c["name"] == "coarse_correct" else "tridiag"
        for tag, libs in variants.items():
            if src not in libs:
                continue
            use("new")
            _build.load(src, sigs[src], libs[src])
            run = runner(c, "new")
            a, b = checked(c, run), checked(c, run)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            as_new = all(torch.equal(x, y) for x, y in zip(a, first["new"]))
            dms = device_ms(run)
            times[c["label"]].setdefault(tag, []).append(dms)
            print(f"{tag} {c['label']}: device {dms:.5f} ms; two calls "
                  f"bitwise {same}, bitwise the new version's {as_new} "
                  f"({card})", flush=True)
        use("new")
        bms, by = bound(c["bytes"], c["flops"], c["itemsize"])
        print(f"{c['label']}: bound {bms:.5f} ms ({by}) ({card})",
              flush=True)
    for label, by in times.items():
        old, new = statistics.median(by["old"]), statistics.median(by["new"])
        print(f"summary {label}: device old {old:.5f} ms, new {new:.5f} ms, "
              f"new/old {new / old:.3f}"
              + "".join(f", {v} {by[v][0]:.5f} ms ({by[v][0] / old:.3f} of "
                        f"old)" for v in variants if v in by)
              + f" ({card})", flush=True)
    for version in ("old", "new"):
        use(version)
        floors = launch_floors(dev, segment=version == "new")
        print(f"{version} launch floors: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in floors.items()) + f" ({card})",
            flush=True)
    # Inputs cold: each call after a 64 MB memset (past the 50 MB L2), the
    # memset's own device time taken off.
    flush = torch.empty(16 * 1024 * 1024, device=dev)
    memset_ms = device_ms(flush.zero_, reps=50)
    for c in cases:
        if c["key"] not in ("K1p", "K1p_add", "K1p_sphere", "K7", "K7_f64"):
            continue
        for version in TURNS:
            use(version)
            run = runner(c, version)
            warm = device_ms(run, reps=50)
            cold = device_ms(lambda: (flush.zero_(), run()),
                             reps=50) - memset_ms
            print(f"{version} {c['label']}: device {warm:.5f} ms back to "
                  f"back, {cold:.5f} ms after a 64 MB memset (inputs out of "
                  f"L2; the memset's {memset_ms:.5f} ms taken off) "
                  f"({card})", flush=True)


def old_k6_dots(lib):
    """The second pass with the dots on an older pcg.cu, which has no fused
    pass: its col_sums (the dots R . Z) through the current wrapper, then
    its pcg_direction_*, called here with the current wrapper's scratch
    (both partial buffers hold lanes * q * ceil(n / 256) values); the
    signature of chip_smoke.k6_floors' `dots`: (P's sums or None,
    rz_new)."""
    import ctypes

    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import pcg as kp
    from mac_tpu_torch.ops.kernels.tridiag import SUFFIX

    P, I = ctypes.c_void_p, ctypes.c_int
    raw = {}
    for dtype, sfx in SUFFIX.items():
        raw[dtype] = getattr(lib, f"pcg_direction_{sfx}")
        raw[dtype].argtypes = [P] * 5 + [I] * 4 + [P] * 4
        raw[dtype].restype = ctypes.c_int

    def dots(P, R, Z, zsum, rz, init=False, sums=False):
        rz_new = kp.col_sums(R, Z, zsum)
        lanes, n, q = kp._shape(P)
        tk = kp.ticket(P.device)
        out = kp._sums_like(P) if sums else None
        part = kp._part(P) if sums else None
        err = _build.launch(raw[P.dtype], P.device, P.data_ptr(),
                            Z.data_ptr(), kp._ptr(zsum), rz.data_ptr(),
                            rz_new.data_ptr(), int(bool(init)), n, q, lanes,
                            kp._ptr(part), kp._ptr(out), tk.data_ptr())
        if err != 0:
            raise RuntimeError(f"the older pcg_direction failed: {err}")
        return out, rz_new

    return dots


def k6_ab(use, card, dev, n, dots_of):
    """K6 old against new in turns at phase 3f's shapes (the module
    docstring's --cg-only with pcg.cu); dots_of: {version: the second pass
    with the dots}."""
    import numpy as np
    import torch

    from chip_smoke import bound, k6_cases, k6_floors, rel_norm

    use("new")
    cases = k6_cases(dev, n, np.random.RandomState(18))

    def runner(c, version):
        if c["kind"] not in ("dots", "dots_init"):
            return c["kernel"]
        a = c["inputs"]
        return lambda: (a["P"], a["rz"], *dots_of[version](
            a["P"], a["R"], a["Z"], a["zsum"], a["rz"], a["init"], True))

    def checked(c, run):
        if c["fresh"] is not None:
            c["fresh"]()
        got = run()
        got = got if isinstance(got, tuple) else (got,)
        return tuple(t.clone() for t in got)

    times = {}
    for c in cases:
        ref = checked(c, c["plain"])
        first = {}
        for version in TURNS:
            use(version)
            run = runner(c, version)
            a, b = checked(c, run), checked(c, run)
            first.setdefault(version, a)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            err = max(rel_norm(x, y) for x, y in zip(a, ref))
            as_old = all(torch.equal(x, y) for x, y in zip(a, first["old"]))
            extra = ""
            if c["kind"].startswith("dots"):
                i = c["inputs"]
                extra = (", rz_new bitwise its col_sums(R, Z, zsum) "
                         f"{torch.equal(a[3], kp_col_sums(i))}")
            dms, cms = device_ms(run), call_ms(run)
            times.setdefault(c["label"], {}).setdefault(version, []).append(
                dms)
            print(f"{version} {c['label']}: device {dms:.5f} ms, call "
                  f"{cms:.4f} ms; relative error {err:.3e}, two calls "
                  f"bitwise {same}, bitwise the old version's {as_old}"
                  f"{extra}"
                  + ("" if same and err <= c["tol"] else " (FAILS phase 3f)")
                  + f" ({card})", flush=True)
        use("new")
        bms, by = bound(c["bytes"], c["flops"], c["itemsize"])
        print(f"{c['label']}: bound {bms:.5f} ms ({by}) ({card})",
              flush=True)
    for label, by in times.items():
        old, new = statistics.median(by["old"]), statistics.median(by["new"])
        print(f"summary {label}: device old {old:.5f} ms, new {new:.5f} ms, "
              f"new/old {new / old:.3f} ({card})", flush=True)
    for version in TURNS[:2]:
        use(version)
        floors = k6_floors(dev, dots_of[version])
        print(f"{version} K6 launch floors: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in floors.items()) + f" ({card})",
            flush=True)
    # Inputs cold: each call after a 64 MB memset (past the 50 MB L2), the
    # memset's own device time taken off.
    flush = torch.empty(16 * 1024 * 1024, device=dev)
    memset_ms = device_ms(flush.zero_, reps=50)
    for c in cases:
        if c["key"] not in ("K6_colsum", "K6_update", "K6_direction_dots"):
            continue
        for version in TURNS:
            use(version)
            run = runner(c, version)
            warm = device_ms(run, reps=50)
            cold = device_ms(lambda: (flush.zero_(), run()),
                             reps=50) - memset_ms
            print(f"{version} {c['label']}: device {warm:.5f} ms back to "
                  f"back, {cold:.5f} ms after a 64 MB memset (inputs out of "
                  f"L2; the memset's {memset_ms:.5f} ms taken off) "
                  f"({card})", flush=True)


def kp_col_sums(inputs):
    """col_sums(R, Z, zsum) of a K6 dots case's inputs, on the library
    loaded now."""
    from mac_tpu_torch.ops.kernels import pcg as kp

    return kp.col_sums(inputs["R"], inputs["Z"], inputs["zsum"])


def ldl_report(use, card, factor_args):
    """The new build's chain probe (ns a step of K3b's pivot chain and K3's
    carry, float32 and float64 instantiations) and each factor case's phase
    breakdown (ldl.cu's clock64() stamps, chip_smoke.ldl_phases)."""
    import torch

    use("new")
    for dt in (torch.float32, torch.float64):
        got = ldl_step_ns(dt)
        print(f"ldl step probe {str(dt)[6:]}: floor {got['floor_ms']:.5f} "
              "ms; " + "; ".join(
                  f"{chain} {got[chain]['ns']:.2f} ns a step (R 128: "
                  f"{got[chain]['ns_at'][128]:.2f}, R 1024: "
                  f"{got[chain]['ns_at'][1024]:.2f} ns less the floor), "
                  f"{got[chain]['cycles']:.1f} cycles"
                  for chain in ("K3b", "K3")) + f" ({card})", flush=True)
    for label, kern, _, args in factor_args:
        rows = ldl_phases(kern.__name__, args)
        print(f"phases {label}: " + ", ".join(
            f"{name} {cyc} cycles {ns / 1e3:.3f} us" for name, cyc, ns in rows)
            + f" ({card})", flush=True)


def old_k8(lib):
    """run(case) -> a call of an older ell.cu's K8 (row-major tables, no
    row counts: its export's arguments are the current ones less cnt) on
    k8_cases' case inputs, with the row-major tables made here once and the
    current wrapper's scratch; the call returns what ell_product would."""
    import ctypes

    import torch

    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import ell as k8
    from mac_tpu_torch.ops.kernels.pcg import _ptr, ticket
    from mac_tpu_torch.ops.kernels.tridiag import SUFFIX

    raw = {}
    for dtype, sfx in SUFFIX.items():
        raw[dtype] = getattr(lib, f"ell_product_{sfx}")
        sig = k8._SIGNATURES[f"ell_product_{sfx}"]
        raw[dtype].argtypes = sig[:1] + sig[2:]
        raw[dtype].restype = ctypes.c_int

    def run(case):
        i = case["inputs"]
        nbr = i["nbr_tbl"].to(torch.int32).contiguous()
        w_tbl, V, kw = i["w_tbl"].mT.contiguous(), i["V"], i["kw"]
        n, dmax = nbr.shape
        q, dev = V.shape[-1], V.device
        lanes = V.shape[0] if V.dim() == 3 else (
            w_tbl.shape[0] if w_tbl.dim() == 3 else 1)
        lead = (lanes,) if V.dim() == 3 or w_tbl.dim() == 3 else ()
        B, c, sigma = kw.get("B"), kw.get("c"), kw.get("sigma")
        dot = kw.get("dot", False)

        def call():
            tk = ticket(dev) if dot else None
            out = torch.empty(lead + (n, q), dtype=V.dtype, device=dev)
            part = dots = None
            if dot:
                part = torch.empty(k8.dot_partials(n, q, lanes),
                                   dtype=torch.float64, device=dev)
                dots = torch.empty(lead + (q,), dtype=torch.float64,
                                   device=dev)
            err = _build.launch(
                raw[V.dtype], dev, nbr.data_ptr(), w_tbl.data_ptr(),
                k8._lane_stride(w_tbl, lanes), V.data_ptr(),
                k8._lane_stride(V, lanes), out.data_ptr(), _ptr(B),
                0 if B is None else k8._lane_stride(B, lanes),
                _ptr(kw.get("bsum")), _ptr(kw.get("vsum")), _ptr(c),
                1 if c is not None and c.dim() == 1 else 0, _ptr(sigma),
                1 if sigma is not None and sigma.dim() == 1 else 0,
                _ptr(part), _ptr(dots), _ptr(tk), n, q, dmax, lanes)
            if err != 0:
                raise RuntimeError(f"the older ell_product failed: {err}")
            return (out, dots) if dot else out

        return call

    return run


def ell_ab(card, dev, old_dir: Path, variant_dirs=()):
    """--ell-only (the module docstring); each of variant_dirs holds an
    ell.cu with the current export, timed at every shape after its
    turns through the current wrapper."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from chip_smoke import (bound, ell_inputs, k8_cases, launch_floors,
                            rel_norm)
    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels import ell as k8

    with ThreadPoolExecutor(2 + len(variant_dirs)) as pool:
        old_job = pool.submit(build_one, old_dir, "old", "ell")
        var_jobs = {Path(d).name: pool.submit(
            build_one, Path(d), f"variant-{Path(d).name}", "ell")
            for d in variant_dirs}
        new_path = pool.submit(_build.build, "ell").result()
        old_path, old_log = old_job.result()
        variants = {name: job.result() for name, job in var_jobs.items()}
    print_ptxas("old", "ell", old_log)
    print_ptxas("new", "ell", _build.ptxas_log("ell"))
    for name, (_, log) in variants.items():
        print_ptxas(f"variant {name}", "ell", log)
    old_run = old_k8(ctypes.CDLL(str(old_path)))
    ell = ell_inputs(dev, Path(__file__).resolve().parent / "data"
                     / "city10000.g2o")
    floors = {"new": launch_floors(dev)["K8"]}
    one = {"inputs": {
        "nbr_tbl": torch.zeros((1, 1), dtype=torch.int64, device=dev),
        "w_tbl": torch.ones((1, 1), device=dev),
        "V": torch.zeros((1, 1), device=dev), "kw": {}}}
    floors["old"] = device_ms(old_run(one))
    print(f"K8 launch floors (n 1, q 1, one slot): old {floors['old']:.5f} "
          f"ms, new {floors['new']:.5f} ms ({card})", flush=True)

    def outs(fn):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        return tuple(t.clone() for t in got)

    cases = k8_cases(dev, *ell)
    runs = {}
    for c in cases:
        runs[c["key"]] = {"old": old_run(c), "new": c["kernel"]}
        ref = outs(c["plain"])
        first, times = {}, {"old": [], "new": []}
        for version in TURNS:
            run = runs[c["key"]][version]
            a, b = outs(run), outs(run)
            first.setdefault(version, a)
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            err = max(rel_norm(x, y) for x, y in zip(a, ref))
            as_old = all(torch.equal(x, y) for x, y in zip(a, first["old"]))
            dms, cms = device_ms(run), call_ms(run)
            times[version].append(dms)
            print(f"{version} {c['label']}: device {dms:.5f} ms, call "
                  f"{cms:.4f} ms; relative error {err:.3e}, two calls "
                  f"bitwise {same}, bitwise the old version's (outputs"
                  f"{' and dots' if len(a) > 1 else ''}) {as_old}"
                  + ("" if same and err <= c["tol"] else " (FAILS phase 3f)")
                  + f" ({card})", flush=True)
        old, new = (statistics.median(times[v]) for v in ("old", "new"))
        bms, by = bound(c["bytes"], c["flops"], c["itemsize"])
        plain_ms = device_ms(c["plain"], reps=20)
        lib_ms = (None if c["library"] is None else statistics.median(
            [device_ms(c["library"]) for _ in range(2)]))
        print(f"summary {c['label']}: device old {old:.5f} ms, new "
              f"{new:.5f} ms, new/old {new / old:.3f}; restated bound "
              f"{bms:.5f} ms ({by}), new / bound {new / bms:.2f}; plain "
              f"device {plain_ms:.5f} ms, CSR "
              + ("none" if lib_ms is None else f"{lib_ms:.5f} ms")
              + f" ({card})", flush=True)
        for name, (path, _) in variants.items():
            _build.load("ell", k8._SIGNATURES, path)
            a = outs(c["kernel"])
            as_new = all(torch.equal(x, y) for x, y in zip(a, first["new"]))
            vms = statistics.median([device_ms(c["kernel"])
                                     for _ in range(2)])
            print(f"variant {name} {c['label']}: device {vms:.5f} ms, "
                  f"variant/new {vms / new:.3f}, bitwise the new "
                  f"version's {as_new} ({card})", flush=True)
        if variants:
            _build.load("ell", k8._SIGNATURES, new_path)
    # Inputs cold: each call after a 64 MB memset (past the 50 MB L2), the
    # memset's own device time taken off.
    flush = torch.empty(16 * 1024 * 1024, device=dev)
    memset_ms = device_ms(flush.zero_, reps=50)
    for c in cases:
        if c["key"] not in ("K8", "K8_plain"):
            continue
        for version in TURNS:
            run = runs[c["key"]][version]
            cold = device_ms(lambda: (flush.zero_(), run()),
                             reps=50) - memset_ms
            print(f"{version} {c['label']}: {cold:.5f} ms after a 64 MB "
                  f"memset (inputs out of L2; the memset's {memset_ms:.5f} "
                  f"ms taken off) ({card})", flush=True)


def main():
    import importlib.util

    import numpy as np
    import torch

    flags = {"--kernels-only", "--syev-only", "--banded-only", "--cg-only",
             "--ell-only"}
    argv = [a for a in sys.argv[1:] if a not in flags]
    kernels_only = "--kernels-only" in sys.argv[1:]
    syev_only = "--syev-only" in sys.argv[1:]
    banded_only = "--banded-only" in sys.argv[1:]
    cg_only = "--cg-only" in sys.argv[1:]
    if not argv:
        fail("usage: python3 kernel_ab.py [--kernels-only | --syev-only | "
             "--banded-only | --cg-only | --ell-only] OLD_CSRC_DIR "
             "[VARIANT_DIR ...]")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    card = card_line()
    print(card, flush=True)
    if "--ell-only" in sys.argv[1:]:
        if not (Path(argv[0]) / "ell.cu").exists():
            fail(f"--ell-only: no ell.cu in {argv[0]}")
        ell_ab(card, torch.device("cuda"), Path(argv[0]), argv[1:])
        return
    from mac_tpu_torch.ops import banded, laplacian
    from mac_tpu_torch.ops import tridiag as ops_tridiag
    from mac_tpu_torch.ops.kernels import _build, assemble, ldl, syev, tridiag
    from mac_tpu_torch.ops.kernels import banded as kbanded
    from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
    from mac_tpu_torch.ops.kernels.tridiag import (
        tridiag_solve, tridiag_solve_blocked, tridiag_solve_blocked_plain,
        tridiag_solve_plain)
    from mac_tpu_torch.ops.tridiag import tridiag_ldl_auto
    from mac_tpu_torch.solvers import MAC
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    old_dir = Path(argv[0])
    sigs = {"tridiag": tridiag._SIGNATURES, "assemble": assemble._SIGNATURES}
    if (old_dir / "ldl.cu").exists():
        sigs["ldl"] = ldl._SIGNATURES
    if (old_dir / "syev.cu").exists():
        sigs["syev"] = syev._SIGNATURES
    if (old_dir / "banded.cu").exists():
        sigs["banded"] = kbanded._SIGNATURES
    if syev_only:
        if "syev" not in sigs:
            fail(f"--syev-only: no syev.cu in {old_dir}")
        sigs = {"syev": syev._SIGNATURES}
    if banded_only:
        if "banded" not in sigs:
            fail(f"--banded-only: no banded.cu in {old_dir}")
        sigs = {"banded": kbanded._SIGNATURES}
    if cg_only:
        from mac_tpu_torch.ops.kernels import pcg as kpcg

        sigs = {name: sig for name, sig in (
            ("tridiag", tridiag._SIGNATURES), ("banded", kbanded._SIGNATURES),
            ("pcg", kpcg._SIGNATURES)) if (old_dir / f"{name}.cu").exists()}
        if not ({"tridiag", "banded"} <= set(sigs) or "pcg" in sigs):
            fail(f"--cg-only: neither tridiag.cu and banded.cu nor pcg.cu "
                 f"in {old_dir}")
    variants = [f"variant {Path(d).name}" for d in argv[1:]]
    libs = build_all(old_dir, sigs,
                     [] if syev_only or cg_only else argv[1:],
                     "banded" if banded_only else "tridiag")
    old_k7 = "double* xcp" in (old_dir / "banded.cu").read_text() if (
        old_dir / "banded.cu").exists() else False

    dots_of = {}

    def use(version):
        for name, path in libs[version].items():
            lib = _build.load(name, sigs[name], path)
            if name == "banded" and version == "old" and old_k7:
                use_old_k7(lib)
            if name == "pcg" and version == "old" and "old" not in dots_of:
                dots_of["old"] = old_k6_dots(lib)

    dev = torch.device("cuda")
    (dataset, n, fixed, cands, k, x_init, bop, w, dp1, l1,
     B1) = dataset_inputs(dev)
    if syev_only:
        k4_ab(use, card, bop, w, dev)
        return
    if cg_only:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2 * len(variants) + 1) as pool:
            jobs = {(tag, name): pool.submit(build_one, Path(d),
                                             f"variant-{Path(d).name}", name)
                    for tag, d in zip(variants, argv[1:])
                    for name in ("tridiag", "banded")
                    if (Path(d) / f"{name}.cu").exists()}
            built = {key: job.result() for key, job in jobs.items()}
        for (tag, name), (_, log) in built.items():
            print_ptxas(tag, name, log)
        if "pcg" in sigs:
            from mac_tpu_torch.ops.kernels import pcg as kpcg

            use("old")
            dots_of["new"] = kpcg.cg_direction_dots
            k6_ab(use, card, dev, bop.n, dots_of)
        if {"tridiag", "banded"} <= set(sigs):
            cg_ab(use, card, dev, bop, w,
                  {tag: {name: path for (t, name), (path, _) in built.items()
                         if t == tag} for tag in variants})
        return
    if banded_only:
        k5_ab(use, card, dev, bop, w,
              {tag: (libs[tag]["banded"], Path(d) / "banded.cu")
               for tag, d in zip(variants, argv[1:])})
        return
    args_b = k2_args(bop, w)
    idx_s, w_s, n_s = pose_graph(700, 120, 40, 3)
    bop_s = banded.build_banded_rcm(idx_s, n_s)[0].to(dev)
    args_s = k2_args(bop_s, torch.as_tensor(w_s, dtype=torch.float32,
                                            device=dev))
    fi5, wf5, ci5, wc5 = synthetic(SCALE_N, seed=0, local=False)
    k5 = len(wc5) // 4
    x5 = np.zeros(len(wc5))
    x5[np.argpartition(wc5, -k5)[-k5:]] = 1.0
    op5 = laplacian.build_operator(np.concatenate([fi5, ci5]), SCALE_N).to(dev)
    w5 = torch.as_tensor(np.concatenate([wf5, x5 * wc5]), dtype=torch.float32,
                         device=dev)
    d5, e5 = laplacian.lap_tridiagonal_part(op5, w5)
    f5 = tridiag_ldl_auto(d5 + 100 * torch.finfo(torch.float32).eps * d5.max(),
                          e5)
    dp5, l5 = f5.dp.float().contiguous(), f5.l.float().contiguous()
    gen = torch.Generator().manual_seed(0)
    B5 = torch.randn((SCALE_N, 4), generator=gen).to(dev)
    B5w = torch.randn((SCALE_N, 32), generator=gen).to(dev)

    # ---- 1. kernel times, in turns
    k1b_cases = [
        (f"K1b tridiag_solve_blocked ({SCALE_N}, 4)",
         lambda: tridiag_solve_blocked(dp5, l5, B5),
         lambda: tridiag_solve_blocked_plain(dp5, l5, B5), None),
        (f"K1b tridiag_solve_blocked ({SCALE_N}, 32)",
         lambda: tridiag_solve_blocked(dp5, l5, B5w),
         lambda: tridiag_solve_blocked_plain(dp5, l5, B5w), None),
        ("K1b launch floor (1024, 1)",
         lambda: tridiag_solve_blocked(dp5[:1024], l5[:1024], B5w[:32].view(
             1024, 1)),
         lambda: tridiag_solve_blocked_plain(dp5[:1024], l5[:1024],
                                             B5w[:32].view(1024, 1)), None),
    ]
    factor_cases, factor_args = [], ()
    if "ldl" in sigs:
        from chip_smoke import captured_args

        (_, _, _, _, _, _, bop_sp, w_sp, _, _, _) = dataset_inputs(
            dev, "sphere2500")
        city = captured_args(banded, "tridiag_ldl_blocked",
                             lambda: banded.chain_factor(
                                 bop, banded.assemble_bd(bop, w), w))
        sphere = captured_args(banded, "tridiag_ldl_auto",
                               lambda: banded.chain_factor(
                                   bop_sp, banded.assemble_bd(bop_sp, w_sp),
                                   w_sp))
        d5l = d5 + 100 * torch.finfo(torch.float32).eps * d5.max()
        factor_args = (
            ("K3b tridiag_ldl_blocked city10000 (10000,), block 128",
             ldl.tridiag_ldl_blocked, ldl.tridiag_ldl_blocked_plain, city),
            ("K3b tridiag_ldl_blocked float64 city10000, block 128",
             ldl.tridiag_ldl_blocked, ldl.tridiag_ldl_blocked_plain,
             (city[0].double(), city[1].double(), 128)),
            (f"K3b tridiag_ldl_blocked ({SCALE_N},), block 1024",
             ldl.tridiag_ldl_blocked, ldl.tridiag_ldl_blocked_plain,
             (d5l, e5, 1024)),
            ("K3 tridiag_ldl sphere2500 (2500,)", ldl.tridiag_ldl,
             ldl.tridiag_ldl_plain, sphere),
            ("K3 tridiag_ldl float64 sphere2500", ldl.tridiag_ldl,
             ldl.tridiag_ldl_plain,
             (sphere[0].double(), sphere[1].double())),
            ("K3 tridiag_ldl (32768,)", ldl.tridiag_ldl,
             ldl.tridiag_ldl_plain, (d5l[:32768], e5[:32767])),
            ("K3b tridiag_ldl_blocked lanes (8, 10000), block 128",
             ldl.tridiag_ldl_blocked, ldl.tridiag_ldl_blocked_plain,
             (torch.stack([city[0] * (1 + 0.01 * r) for r in range(8)]),
              city[1].expand(8, -1), 128)),
            (f"K3b tridiag_ldl_blocked lanes (2, {SCALE_N}), block 1024",
             ldl.tridiag_ldl_blocked, ldl.tridiag_ldl_blocked_plain,
             (torch.stack([d5l, d5l * 1.01]), e5.expand(2, -1), 1024)))
        for label, kern, plain, args in factor_args:
            factor_cases.append((
                label, lambda kern=kern, args=args: kern(*args),
                lambda plain=plain, args=args: plain(*args), None))
    cases = [
        ("K1 tridiag_solve (10000, 4)", lambda: tridiag_solve(dp1, l1, B1),
         lambda: tridiag_solve_plain(dp1, l1, B1), None),
        ("K2b assemble_ut city10000", lambda: assemble_ut(*args_b),
         lambda: assemble_ut_plain(*args_b), index_add_assembly(args_b)),
        ("K2 assemble_ut n 700", lambda: assemble_ut(*args_s),
         lambda: assemble_ut_plain(*args_s), index_add_assembly(args_s)),
    ] + k1b_cases + factor_cases
    results = {}

    def flat(out):
        """A kernel's output as one tensor (the factor kernels return dp
        and l)."""
        return (torch.cat([t.reshape(-1) for t in out])
                if isinstance(out, tuple) else out)

    def time_case(version, label, kern, ref):
        use(version)
        got = flat(kern())
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = (torch.equal(got, ref) if "assemble" in label or "K3b" in label
              else torch.allclose(got, ref, rtol=2e-4, atol=2e-4))
        if not ok and version in TURNS:
            fail(f"{version} {label} disagrees with its plain version "
                 f"({err:.3e})")
        dms, cms = device_ms(kern), call_ms(kern)
        results.setdefault(label, {}).setdefault(version, []).append(dms)
        print(f"{version} {label}: device {dms:.5f} ms, call {cms:.4f} "
              f"ms, max|kernel - plain| {err:.2e}"
              f"{'' if ok else ' (DISAGREES)'} ({card})", flush=True)

    for label, kern, plain, library in cases:
        ref = flat(plain())
        for version in TURNS:
            time_case(version, label, kern, ref)
        if library is not None:
            print(f"index_add_ yardstick for {label}: device "
                  f"{device_ms(library):.5f} ms, call {call_ms(library):.4f} "
                  f"ms ({card})", flush=True)
    for label, kern, plain, _ in k1b_cases:
        ref = flat(plain())
        for version in variants:
            time_case(version, label, kern, ref)
    for label, by in results.items():
        old, new = statistics.median(by["old"]), statistics.median(by["new"])
        print(f"summary {label}: device old {old:.5f} ms, new {new:.5f} ms, "
              f"new/old {new / old:.3f}" + "".join(
                  f", {v} {by[v][0]:.5f} ms" for v in variants if v in by)
              + f" ({card})", flush=True)
    if factor_args:
        ldl_report(use, card, factor_args)
    if "syev" in sigs:
        k4_ab(use, card, bop, w, dev)
    if "banded" in sigs:
        k5_ab(use, card, dev, bop, w, {})
    # The wrappers of an older copy of ops/kernels/tridiag.py, on the new
    # kernels: what the host side of a call costs, before and after.
    if (old_dir / "tridiag.py").exists():
        spec = importlib.util.spec_from_file_location(
            "older_tridiag_wrappers", old_dir / "tridiag.py")
        older = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(older)
        use("new")
        pairs = (
            ("K1 (10000, 4)", lambda: older.tridiag_solve(dp1, l1, B1),
             lambda: tridiag_solve(dp1, l1, B1)),
            (f"K1b ({SCALE_N}, 4)",
             lambda: older.tridiag_solve_blocked(dp5, l5, B5),
             lambda: tridiag_solve_blocked(dp5, l5, B5)))
        for label, old_call, new_call in pairs:
            if not torch.equal(old_call(), new_call()):
                fail(f"the older wrapper of {label} returns another result")
            turns = (old_call, new_call, new_call, old_call)
            ms = [call_ms(fn) for fn in turns]
            us = [enqueue_us(fn) for fn in turns]
            print(f"wrapper of {label} on the new kernel, in turns older, "
                  f"current, current, older: call_ms "
                  + ", ".join(f"{t:.4f}" for t in ms) + " ms; host time to "
                  "enqueue one call " + ", ".join(f"{t:.2f}" for t in us)
                  + f" us ({card})", flush=True)

    # ---- 2. errors against float64 on the paths' chain factors
    def f64_errors(label, kern, plain, plain64, versions):
        X64 = plain64()
        scale = float(X64.abs().max())
        for version in (*versions, None):
            if version is not None:
                use(version)
            X = plain() if version is None else kern()
            err = float((X.double() - X64).abs().max())
            print(f"{version or 'plain version (float32)'} {label} against "
                  f"float64: max abs error {err:.3e}, relative to max|X| "
                  f"{err / scale:.3e}", flush=True)

    f64_errors("K1 at (10000, 4)", cases[0][1], cases[0][2],
               lambda: tridiag_solve_plain(dp1.double(), l1.double(),
                                           B1.double()), ("old", "new"))
    f64_errors(f"K1b at ({SCALE_N}, 4)", k1b_cases[0][1], k1b_cases[0][2],
               lambda: tridiag_solve_blocked_plain(dp5.double(), l5.double(),
                                                   B5.double()),
               ("old", "new", *variants))

    if kernels_only:
        return

    # ---- 3. warm solves: wall and the relaxed gap. A MAC per version:
    # its cold solve captures the graphs its warm solves replay, with the
    # kernels of the library loaded at the capture.
    def timed_solve(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def city_gap(m, unrounded):
        lam2 = scipy_lam2(m.laplacian(unrounded))
        return lam2, (lam2 - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED

    def per_version(make):
        """{version: solver}, each built and solved cold with its library
        loaded."""
        built = {}
        for version in ("old", "new"):
            use(version)
            built[version] = make()
        return built

    def city_run(m):
        return m.solve(k, x_init, rounding="nearest", use_cache=True)

    macs = per_version(lambda: MAC(fixed, cands, n, device="cuda"))
    for version in ("old", "new"):
        use(version)
        city_run(macs[version])  # the cold solve: captures its graphs
    for version in TURNS:
        use(version)
        (_, unrounded, _), wall = timed_solve(lambda: city_run(macs[version]))
        lam2, gap = city_gap(macs[version], unrounded)
        print(f"{version} city10000 warm solve: wall {wall:.4f} s unprofiled;"
              f" relaxed lambda_2 {lam2:.10g}, gap {gap:+.4e} ({card})",
              flush=True)
    use("new")
    with SolvePath("eager"), mock.patch.object(
            ops_tridiag._kernels, "tridiag_solve", tridiag_solve_plain):
        _, unrounded, _ = city_run(macs["new"])
    lam2, gap = city_gap(macs["new"], unrounded)
    print(f"K1's plain version on the card (eager solve), city10000 solve: "
          f"relaxed lambda_2 {lam2:.10g}, gap {gap:+.4e}", flush=True)
    mac_cpu = MAC(fixed, cands, n, device="cpu")
    lam2, gap = city_gap(mac_cpu, city_run(mac_cpu)[1])
    print(f"the port on the CPU (every plain version), city10000 solve: "
          f"relaxed lambda_2 {lam2:.10g}, gap {gap:+.4e}", flush=True)

    # The matrix-free path, as chip_smoke.py's phase 5 drives it.
    def solve5(m):
        (_, unrounded, _), wall = timed_solve(
            lambda: m.solve(k5, x5, max_iters=10, use_cache=True))
        lam2 = m.evaluate_objective(unrounded)
        return (wall, lam2,
                (lam2 - REFERENCE_LAM2_SCALE) / REFERENCE_LAM2_SCALE)

    macs5 = per_version(lambda: MAC(
        (fi5, wf5), (ci5, wc5), SCALE_N, fiedler_inner_iters=10,
        fiedler_maxiter=60, fiedler_tol=6e-4, device="cuda"))
    for version in ("old", "new"):
        use(version)
        solve5(macs5[version])
    for version in TURNS:
        use(version)
        before = tridiag_solve_blocked.launches
        wall, lam2, gap = solve5(macs5[version])
        print(f"{version} n {SCALE_N} warm solve: wall {wall:.4f} s "
              f"unprofiled; relaxed lambda_2 (evaluate_objective) "
              f"{lam2:.12g}, gap {gap:+.4e}; K1b launches "
              f"{tridiag_solve_blocked.launches - before}, fiedler "
              f"iterations "
              f"{macs5[version].last_solve_stats.get('fiedler_iterations')}"
              f" ({card})", flush=True)
    use("new")
    with SolvePath("eager"), mock.patch.object(
            ops_tridiag._kernels, "tridiag_solve_blocked",
            tridiag_solve_blocked_plain):
        _, lam2, gap = solve5(macs5["new"])
    print(f"K1b's plain version on the card (eager solve), n {SCALE_N} "
          f"solve: relaxed lambda_2 {lam2:.12g}, gap {gap:+.4e}", flush=True)

    # K4's and K3's other cells: sphere2500 (K3, the exact factor) and the
    # banded float64 city10000 (K3b float64).
    cells = {}
    if "syev" in sigs or "ldl" in sigs:
        from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                                   split_edges)
        from mac_tpu_torch.solvers import NaiveGreedy

        meas, n_s = read_g2o_file(str(dataset.parent / "sphere2500.g2o"))
        fixed_s, cands_s = split_edges(rpm_to_mac(meas))
        k_s = len(cands_s) // 2
        x_s = NaiveGreedy(cands_s).subset(k_s)
        cells = {
            "sphere2500": (per_version(lambda: MAC(fixed_s, cands_s, n_s)),
                           lambda m: m.solve(k_s, x_s, use_cache=True),
                           BUNDLED["sphere2500"][0]),
            "city10000 banded float64": (
                per_version(lambda: MAC(fixed, cands, n, use_banded=True,
                                        dtype=torch.float64,
                                        device="cuda")),
                lambda m: m.solve(k, x_init, max_iters=20),
                REFERENCE_LAM2_UNROUNDED)}
        for cell, (ms, run, ref) in cells.items():
            for version in ("old", "new"):
                use(version)
                run(ms[version])
            for version in TURNS:
                use(version)
                (_, unrounded, _), wall = timed_solve(
                    lambda: run(ms[version]))
                lam2 = scipy_lam2(ms[version].laplacian(unrounded))
                print(f"{version} {cell} warm solve: wall {wall:.4f} s "
                      f"unprofiled; relaxed lambda_2 {lam2:.12g}, gap "
                      f"{(lam2 - ref) / ref:+.4e} ({card})", flush=True)

    # ---- 4. the device time of the kernels in one profiled warm solve
    k3_key = lambda nm: "ldl_kernel" in nm  # noqa: E731
    k3b_key = lambda nm: "ldl_blocked_kernel" in nm  # noqa: E731
    k1_keys = {"K1": lambda nm: ("tridiag_solve_kernel" in nm
                                 and "blocked" not in nm
                                 and "true>" not in nm),
               # K1p: K1's body with the permuted entry (the banded cycle's)
               "K1p": lambda nm: ("tridiag_solve_kernel" in nm
                                  and "true>" in nm),
               "K2b": lambda nm: "assemble_ut_kernel" in nm,
               "K4": lambda nm: "sym_eig_kernel" in nm, "K3b": k3b_key}
    k1b_keys = {"K1b": lambda nm: "tridiag_solve_blocked_kernel" in nm,
                "K4": lambda nm: "sym_eig_kernel" in nm, "K3b": k3b_key}
    for version in ("old", "new"):
        use(version)
        t1, t2 = tridiag_solve.launches, assemble_ut.launches
        (_, pwall), sums = device_profile(
            lambda: timed_solve(lambda: city_run(macs[version])), k1_keys)
        print(f"{version} city10000 warm solve profiled: wall {pwall:.4f} s;"
              f" device busy {sums['busy'][0] / 1e3:.2f}"
              f" ms over {sums['busy'][1]} kernels and copies; K1 "
              f"{sums['K1'][0] / 1e3:.3f} ms over {sums['K1'][1]} launches "
              f"(wrapper counted {tridiag_solve.launches - t1}); K2b "
              f"{sums['K2b'][0] / 1e3:.3f} ms over {sums['K2b'][1]} launches "
              f"(wrapper counted {assemble_ut.launches - t2}); K4 "
              f"{sums['K4'][0] / 1e3:.3f} ms over {sums['K4'][1]} launches; "
              f"K3b {sums['K3b'][0] / 1e3:.3f} ms over {sums['K3b'][1]} "
              f"launches ({card})", flush=True)
    for version in ("old", "new"):
        use(version)
        t1 = tridiag_solve_blocked.launches
        (pwall, _, _), sums = device_profile(lambda: solve5(macs5[version]),
                                             k1b_keys)
        print(f"{version} n {SCALE_N} warm solve profiled: wall {pwall:.4f} "
              f"s; device busy {sums['busy'][0] / 1e3:.2f} ms over "
              f"{sums['busy'][1]} kernels and copies; K1b "
              f"{sums['K1b'][0] / 1e3:.3f} ms over {sums['K1b'][1]} launches "
              f"(wrapper counted {tridiag_solve_blocked.launches - t1}); K4 "
              f"{sums['K4'][0] / 1e3:.3f} ms over {sums['K4'][1]} launches; "
              f"K3b {sums['K3b'][0] / 1e3:.3f} ms over {sums['K3b'][1]} "
              f"launches ({card})", flush=True)
    if "sphere2500" in cells:  # K3's cell
        ms, run, _ = cells["sphere2500"]
        for version in ("old", "new"):
            use(version)
            _, sums = device_profile(
                lambda: timed_solve(lambda: run(ms[version])),
                {"K3": k3_key, "K1": k1_keys["K1"], "K4": k1_keys["K4"]})
            print(f"{version} sphere2500 warm solve profiled: device busy "
                  f"{sums['busy'][0] / 1e3:.2f} ms over {sums['busy'][1]} "
                  f"kernels and copies; K3 {sums['K3'][0] / 1e3:.3f} ms over "
                  f"{sums['K3'][1]} launches; K1 {sums['K1'][0] / 1e3:.3f} ms;"
                  f" K4 {sums['K4'][0] / 1e3:.3f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()

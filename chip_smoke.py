#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. require CUDA; print the card (nvidia-smi name and power limit) and the
     TF32 flags;
  2. build the hand-written CUDA kernels from mac_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, and time both with CUDA events:
       tridiag_solve (K1) on city10000's chain factor (n = 10000, q = 4) and
       on an exact factor (n = 4000), rtol/atol 2e-4 (the JAX package's
       tolerance for its own kernel);
       assemble_ut (K2/K2b) on city10000's split tables and on a graph
       without a split, bitwise equal;
  4. the main path: read data/city10000.g2o, NaiveGreedy x_init, build
     MAC(..., device="cuda"), one cold and three warm solves at K = 50% of
     the loop closures; every kernel must have launched; the relaxed
     lambda_2 (scipy float64 referee) must sit within -1e-3 relative of the
     reference optimum 0.06944591018149751, and the rounded selection must
     hold exactly K edges.
The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REFERENCE_LAM2_UNROUNDED = 0.06944591018149751  # reference relaxed optimum
GAP_FLOOR = -1e-3
K1_TOL = 2e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pose_graph(n, n_loops, span, seed):
    """Odometry chain plus short-range loop closures (banded after RCM)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    chain = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    loops = set()
    while len(loops) < n_loops:
        i = rng.randint(0, n - 2)
        j = min(n - 1, i + 2 + rng.randint(span))
        if j - i > 1:
            loops.add((i, j))
    idx = np.concatenate([chain, np.array(sorted(loops))]).astype(np.int64)
    return idx, 0.5 + rng.rand(len(idx)), n


def main():
    import numpy as np
    import torch

    # ---- 1. the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = card_line()
    print(card, flush=True)
    try:
        import mac_tpu_torch  # noqa: F401 (sets the numerics policy)
    except ImportError as exc:
        fail(f"the mac_tpu_torch package is not importable here: {exc}")
    from mac_tpu_torch.ops import banded
    from mac_tpu_torch.ops.kernels import _build
    from mac_tpu_torch.ops.kernels.assemble import assemble_ut, assemble_ut_plain
    from mac_tpu_torch.ops.kernels.tridiag import tridiag_solve, tridiag_solve_plain
    from mac_tpu_torch.ops.tridiag import tridiag_ldl
    from mac_tpu_torch.slam.pose_graph import read_g2o_file, rpm_to_mac, split_edges
    from mac_tpu_torch.solvers import MAC, NaiveGreedy
    from mac_tpu_torch.utils.fiedler import scipy_lam2

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on; the port's numerics policy wants full float32")

    # ---- 2. build the kernels
    t0 = time.perf_counter()
    for src in ("tridiag", "assemble"):
        _build.build(src)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for src, secs, log in _build.build_log:
        print(f"  nvcc {src}.cu {secs:.2f} s: "
              + " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "smem" in ln), flush=True)

    # ---- 3. kernels against their plain versions on the card
    repo = Path(mac_tpu_torch.__file__).resolve().parent.parent
    dataset = repo / "data" / "city10000.g2o"
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    k = len(cands) // 2
    x_init = NaiveGreedy(cands).subset(k)
    idx = np.array([[e.i, e.j] for e in fixed + cands])
    w_all = np.concatenate([[e.weight for e in fixed],
                            x_init * np.array([e.weight for e in cands])])
    bop, _ = banded.build_banded_rcm(idx, n)
    bop = bop.to(dev)
    print(f"city10000: n {n}, {len(fixed)} fixed, {len(cands)} candidates, "
          f"K {k}; nb {bop.nb} half {bop.half} du {bop.ueid_tbl.shape[0]} "
          f"du_dense {bop.du_dense} ov_rows {bop.ov_rows} coarse "
          f"{bop.coarse_nc} x {bop.coarse_s}", flush=True)
    w = torch.as_tensor(w_all, dtype=torch.float32, device=dev)
    BD = banded.assemble_bd(bop, w)
    fac = banded.chain_factor(bop, BD, w)
    gen = torch.Generator().manual_seed(0)
    B = torch.randn((n, 4), generator=gen).to(dev)

    def k1_check(dp, l, B, label):
        got = tridiag_solve(dp, l, B)
        ref = tridiag_solve_plain(dp, l, B)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, ref, rtol=K1_TOL, atol=K1_TOL)
        print(f"K1 tridiag_solve {label}: max|kernel - plain| {err:.3e} "
              f"(max|X| {float(ref.abs().max()):.3e}) -> "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"tridiag_solve kernel disagrees with its plain version on "
                 f"{label}")
        return err

    dp32, l32 = fac.dp.float().contiguous(), fac.l.float().contiguous()
    k1_err = k1_check(dp32, l32, B, "city10000 chain factor (n 10000, q 4)")
    rng = np.random.RandomState(1)
    n_ex = 4000
    e = -(0.5 + rng.rand(n_ex - 1))
    d = 0.1 + rng.rand(n_ex) - np.concatenate([[0], e]) - np.concatenate([e, [0]])
    f_ex = tridiag_ldl(torch.as_tensor(d, dtype=torch.float32, device=dev),
                       torch.as_tensor(e, dtype=torch.float32, device=dev))
    B_ex = torch.as_tensor(rng.normal(size=(n_ex, 4)), dtype=torch.float32,
                           device=dev)
    k1_err = max(k1_err, k1_check(f_ex.dp, f_ex.l, B_ex,
                                  "exact factor (n 4000, q 4)"))
    k1_ms = cuda_ms(lambda: tridiag_solve(dp32, l32, B))
    k1_plain_ms = cuda_ms(lambda: tridiag_solve_plain(dp32, l32, B))
    print(f"K1 time at (10000, 4): kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms ({card})", flush=True)

    def k2_args(bop, w):
        w_pad = torch.cat([-w, w.new_zeros(1)])
        dd = bop.du_dense
        return (bop.dcol_tbl[:dd].contiguous(),
                w_pad[bop.ueid_tbl[:dd]].contiguous(), bop.ocol_tbl,
                bop.olane_tbl, w_pad[bop.oeid_tbl].contiguous(), bop.half,
                bop.nb)

    idx_s, w_s, n_s = pose_graph(700, 120, 40, 3)
    bop_s, _ = banded.build_banded_rcm(idx_s, n_s)
    bop_s = bop_s.to(dev)
    if bop_s.ov_rows != 0:
        fail("the no-split assembly case picked a split")
    k2_err = 0.0
    for label, b_, w_ in (
            ("city10000 (split: du_dense 5, ov 5)", bop, w),
            ("n 700 graph without a split", bop_s,
             torch.as_tensor(w_s, dtype=torch.float32, device=dev))):
        args = k2_args(b_, w_)
        got = assemble_ut(*args)
        ref = assemble_ut_plain(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k2_err = max(k2_err, err)
        same = torch.equal(got, ref)
        print(f"K2 assemble_ut {label}: shape {tuple(got.shape)}, max|kernel "
              f"- plain| {err:.3e} -> {'bitwise equal' if same else 'MISMATCH'}",
              flush=True)
        if not same:
            fail(f"assemble_ut kernel differs from its plain version on {label}")
    args_s = k2_args(bop_s, torch.as_tensor(w_s, dtype=torch.float32,
                                            device=dev))
    print(f"K2 time without a split (n 700): kernel "
          f"{cuda_ms(lambda: assemble_ut(*args_s)):.4f} ms, plain "
          f"{cuda_ms(lambda: assemble_ut_plain(*args_s)):.4f} ms ({card})",
          flush=True)
    args = k2_args(bop, w)
    k2_ms = cuda_ms(lambda: assemble_ut(*args))
    k2_plain_ms = cuda_ms(lambda: assemble_ut_plain(*args))
    print(f"K2b time at city10000: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms ({card})", flush=True)

    # ---- 4. the main path, through the user's entry points
    t0 = time.perf_counter()
    meas, n = read_g2o_file(str(dataset))
    fixed, cands = split_edges(rpm_to_mac(meas))
    x_init = NaiveGreedy(cands).subset(k)
    mac = MAC(fixed, cands, n, device="cuda")
    print(f"setup (read, NaiveGreedy, MAC ctor with its host probe): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    tridiag_solve.launches = 0
    assemble_ut.launches = 0
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounded, unrounded, upper = mac.solve(k, x_init, rounding="nearest",
                                              use_cache=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"tridiag_solve": tridiag_solve.launches,
                "assemble_ut": assemble_ut.launches}
    print(f"solve: cold {times[0]:.4f} s, warm {[round(t, 4) for t in times[1:]]}"
          f" s, warm median {statistics.median(times[1:]):.4f} s ({card})",
          flush=True)
    print(f"last_solve_stats: {mac.last_solve_stats}", flush=True)
    print(f"kernel launches in the 4 solves: {launches}", flush=True)
    for kname, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched {kname}")
    if not (np.all(np.isfinite(unrounded)) and np.isfinite(upper)
            and np.all(np.isfinite(rounded))):
        fail("non-finite solve output")
    if rounded.shape != (len(cands),) or int(rounded.sum()) != k:
        fail(f"rounded selection holds {rounded.sum()} edges, want {k}")
    lam2 = scipy_lam2(mac.laplacian(unrounded))
    gap = (lam2 - REFERENCE_LAM2_UNROUNDED) / REFERENCE_LAM2_UNROUNDED
    print(f"relaxed lambda_2 (scipy) {lam2:.9g}, reference "
          f"{REFERENCE_LAM2_UNROUNDED:.9g}, relative gap {gap:+.3e}; "
          f"upper bound {upper:.9g}", flush=True)
    if not gap >= GAP_FLOOR:
        fail(f"relaxed lambda_2 gap {gap:+.3e} below {GAP_FLOOR}")
    if upper < lam2 * (1 - 1e-6):
        fail(f"upper bound {upper} below the relaxed lambda_2 {lam2}")

    kernels = [
        {"name": "tridiag_solve", "route": "cuda",
         "source": "mac_tpu_torch/csrc/tridiag.cu",
         "replaces": "mac_tpu/ops/pallas/tridiag_kernel.py:44",
         "launches": launches["tridiag_solve"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "assemble_ut", "route": "cuda",
         "source": "mac_tpu_torch/csrc/assemble.cu",
         "replaces": "mac_tpu/ops/pallas/assemble_kernel.py:61",
         "launches": launches["assemble_ut"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Profile of the PyTorch port's matrix-free path on one NVIDIA GPU.

    python3 profile_scale.py

The cell is phase 5 of chip_smoke.py: the n = 100000 expander graph of
scripts/bench_scale.py, K = 12500, MAC with fiedler_inner_iters=10,
fiedler_maxiter=60, fiedler_tol=6e-4, solve(K, x_init, max_iters=10,
use_cache=True). After one cold and two warm solves without the profiler:
  1. one warm solve with CUDA activity only: the device's busy time (the
     sum of its kernel and copy durations), its share of that same run's
     wall time, the kernels run, and device time by kernel;
  2. one warm solve with CPU and CUDA activity and the path's layers wrapped
     in profiler ranges: host-inclusive time by layer (the inner solves are
     replays of their CUDA graphs, mac_tpu_torch.ops.graphs).
Every line names the card and its power limit. It gates nothing:
chip_smoke.py checks the path.
"""

import time

from chip_smoke import SCALE_N, card_line, fail, synthetic


def _layer_ranges():
    """(module, attribute, range name) of the matrix-free path's layers."""
    from mac_tpu_torch.ops import graphs, twogrid
    from mac_tpu_torch.utils import fiedler

    return [(fiedler, "tracemin_fiedler", "TRACEMIN"),
            (graphs, "replay", "inner solve (graph replay)"),
            (twogrid, "tridiag_ldl_auto", "blocked chain LDL^T"),
            (twogrid, "coarse_laplacian", "coarse Lc (scatter-add)"),
            (fiedler, "twogrid_level", "V-cycle set-up"),
            (fiedler, "lap_weight_table", "ELL weight table")]


def _timed(solve):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(solve, card):
    """Busy time and its share of the profiled run's own wall time, from
    CUDA activity alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = _timed(solve)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_ms = sum(t for t, _ in by_kernel.values()) / 1e3
    print(f"device profile ({card}): wall {wall:.3f} s, device busy "
          f"{busy_ms:.1f} ms over {sum(c for _, c in by_kernel.values())} "
          f"kernels and copies; busy share {busy_ms / 1e3 / wall:.3f}",
          flush=True)
    for name, (tot, cnt) in sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / 1e3:9.2f} ms {cnt:7d} x  {name[:110]}", flush=True)


def layer_profile(solve, card):
    """Host-inclusive time by layer, each layer wrapped in a profiler range
    for this run only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, name):
        def inner(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return inner

    patched = [(mod, attr, getattr(mod, attr), name)
               for mod, attr, name in _layer_ranges()]
    names = [name for *_, name in patched]
    try:
        for mod, attr, real, name in patched:
            setattr(mod, attr, ranged(real, name))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = _timed(solve)
    finally:
        for mod, attr, real, _ in patched:
            setattr(mod, attr, real)
    print(f"layer profile ({card}): wall {wall:.3f} s under the profiler",
          flush=True)
    for e in prof.key_averages():
        if e.key in names and e.cpu_time_total > 0:
            print(f"  range {e.key}: {e.count} calls, host-inclusive "
                  f"{e.cpu_time_total / 1e3:.1f} ms", flush=True)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = card_line()
    from mac_tpu_torch.solvers import MAC

    fi, wf, ci, wc = synthetic(SCALE_N, seed=0, local=False)
    k = len(wc) // 4
    x_init = np.zeros(len(wc))
    x_init[np.argpartition(wc, -k)[-k:]] = 1.0
    mac = MAC((fi, wf), (ci, wc), SCALE_N, fiedler_inner_iters=10,
              fiedler_maxiter=60, fiedler_tol=6e-4, device="cuda")
    if mac._banded is not None or mac.op.mode != "ell":
        fail("the n = 100000 expander graph did not take the ELL route")

    def solve():
        mac.solve(k, x_init, max_iters=10, use_cache=True)

    walls = [_timed(solve) for _ in range(3)]
    print(f"unprofiled ({card}): cold {walls[0]:.3f} s, warm "
          f"{walls[1]:.3f} / {walls[2]:.3f} s; last_solve_stats "
          f"{mac.last_solve_stats}", flush=True)
    device_profile(solve, card)
    layer_profile(solve, card)
    print(card, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What the device-mesh layer costs on one NVIDIA GPU.

    python3 profile_mesh.py

On a process group of one NCCL rank (this process, a file:// rendezvous)
and the matrix-free cell of chip_smoke.py's phase 5 (the n = 100000
expander, K = 12500, fiedler_inner_iters=10, fiedler_maxiter=60,
fiedler_tol=6e-4, max_iters=10):
  1. the host time of one call of each collective the layer issues, on the
     shapes of the n = 100000 path (median over 5 rounds of 500 calls,
     synchronised after each round), beside a plain copy of the same
     tensor; and the host time to enqueue 100 gathers (or copies) while the
     device still runs a 20 ms spin, which shows whether a call waits for
     the device;
  2. warm solves without a mesh, with node-row and with edge shards, in
     turns (plain, rows, edges, edges, rows, plain), and the collectives
     each mesh solve issues (counted at mac_tpu_torch.parallel.mesh.
     MeshGroup);
  3. one warm solve without a mesh and one with node rows under
     torch.profiler (CPU and CUDA activity): the host operators whose self
     time grows most from the first to the second.
Every line names the card and its power limit. It gates nothing:
chip_smoke.py phase 9 checks the path.
"""

import datetime
import statistics
import tempfile
import time

from chip_smoke import SCALE_N, card_line, fail, synthetic


def per_call_us(fn, calls=500, rounds=5):
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append(1e6 * (time.perf_counter() - t0) / calls)
    return statistics.median(out)


def behind_spin_ms(fn, calls=100, spin_ms=20.0):
    """Host milliseconds to enqueue `calls` calls of fn() while the device
    still runs a spin of `spin_ms`: near 0 when a call does not wait for
    the device, near spin_ms when it does."""
    import torch

    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(1_000_000)
    s1.record()
    s1.synchronize()
    cycles_per_ms = 1e6 / s0.elapsed_time(s1)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_ms * cycles_per_ms))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return host_ms


def main():
    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    import mac_tpu_torch  # noqa: F401 (the numerics policy)
    from mac_tpu_torch.parallel import mesh as meshmod
    from mac_tpu_torch.solvers import MAC

    card = card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_mesh_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            run(np, torch, meshmod, MAC, card)
        finally:
            dist.destroy_process_group()


def run(np, torch, meshmod, MAC, card):
    mesh = meshmod.make_mesh(device_type="cuda")
    grp = meshmod.MeshGroup(mesh)
    dev = grp.device
    V = torch.randn((SCALE_N, 4), device=dev)
    deg = torch.randn((SCALE_N,), device=dev)
    flag = torch.tensor(True, device=dev)
    import torch.distributed as dist

    def gather_list(t):
        parts = [torch.empty_like(t) for _ in range(grp.size)]
        dist.all_gather(parts, t, group=grp.group)
        return parts

    costs = {
        "copy (clone) of (100000, 4) float32": lambda: V.clone(),
        "all_gather into a list, then cat, (100000, 4)":
            lambda: torch.cat(gather_list(V), dim=0),
        "MeshGroup.all_gather (one buffer), (100000, 4)":
            lambda: grp.all_gather(V, dim=-2),
        "all_reduce, (100000,)": lambda: grp.all_reduce(deg),
        "agree (all_reduce MIN of one int32, .item())":
            lambda: grp.agree(flag),
    }
    for name, fn in costs.items():
        print(f"1. {name}: {per_call_us(fn):.1f} us a call ({card})",
              flush=True)
    for name in ("copy (clone) of (100000, 4) float32",
                 "MeshGroup.all_gather (one buffer), (100000, 4)"):
        print(f"1. host ms to enqueue 100 x {name} behind a 20 ms device "
              f"spin: {behind_spin_ms(costs[name]):.2f} ({card})",
              flush=True)

    fi5, wf5, ci5, wc5 = synthetic(SCALE_N, seed=0, local=False)
    k5 = len(wc5) // 4
    x5 = np.zeros(len(wc5))
    x5[np.argsort(-wc5, kind="stable")[:k5]] = 1.0
    counts = {}
    for name in ("all_gather", "all_reduce", "agree"):
        plain = getattr(meshmod.MeshGroup, name)

        def counted(self, *a, _plain=plain, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _plain(self, *a, **k)

        setattr(meshmod.MeshGroup, name, counted)
    knobs = dict(fiedler_inner_iters=10, fiedler_maxiter=60,
                 fiedler_tol=6e-4)
    macs = {"plain": MAC((fi5, wf5), (ci5, wc5), SCALE_N, device="cuda",
                         **knobs),
            "rows": MAC((fi5, wf5), (ci5, wc5), SCALE_N, mesh=mesh, **knobs),
            "edges": MAC((fi5, wf5), (ci5, wc5), SCALE_N, mesh=mesh,
                         mesh_apply="edges", **knobs)}

    def solve(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        macs[name].solve(k5, x5, max_iters=10)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for name in macs:
        solve(name)  # cold
    walls = {name: [] for name in macs}
    for name in ("plain", "rows", "edges", "edges", "rows", "plain"):
        counts.clear()
        walls[name].append(solve(name))
        if name != "plain":
            print(f"2. {name}: collectives in one solve {dict(counts)}",
                  flush=True)
    for name, ws in walls.items():
        print(f"2. warm solve {name}: {[round(w, 4) for w in ws]} s, fiedler "
              f"iterations {macs[name].last_solve_stats['fiedler_iterations']}"
              f" ({card})", flush=True)

    from torch.profiler import ProfilerActivity, profile

    by_op = {}
    for name in ("plain", "rows"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(name)
        by_op[name] = {e.key: (e.self_cpu_time_total, e.count)
                       for e in prof.key_averages()}
    keys = set(by_op["plain"]) | set(by_op["rows"])
    diff = sorted(keys, key=lambda k: by_op["rows"].get(k, (0, 0))[0]
                  - by_op["plain"].get(k, (0, 0))[0], reverse=True)[:15]
    for k in diff:
        (t1, c1), (t0, c0) = (by_op["rows"].get(k, (0, 0)),
                              by_op["plain"].get(k, (0, 0)))
        print(f"3. {k[:60]}: self CPU rows {t1 / 1e3:.1f} ms over {c1} "
              f"calls, plain {t0 / 1e3:.1f} ms over {c0} ({card})",
              flush=True)

if __name__ == "__main__":
    main()

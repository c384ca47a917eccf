#!/usr/bin/env python3
"""Wall of the two lane paths of TRACEMIN with their batched Rayleigh-Ritz
eigensolves on sym_eig (K4 on the card, its plain Jacobi on the CPU)
against torch.linalg.eigh, in one process, in turns eigh, sym_eig,
sym_eig, eigh:

    python3 lanes_ab.py [--device cpu] [--reps N] [--only sweep|greedy]
                        [--small]

  * sweep: MAC.solve_sweep on city10000 at chip_smoke.py phase 8a's eight
    budgets and NaiveGreedy starts (banded float32, the fast32 policy);
  * greedy: GreedyEig(...).subset(8) on intel (phase 7c: the ELL operator,
    64 trial lanes a chunk, float32).
--small (the default with --device cpu, where intel's GreedyEig takes
longer than a quarter of an hour) runs both on synthetic pose graphs
instead (chip_smoke.pose_graph): the sweep at eight budgets on n = 2000,
GreedyEig's subset(4) on n = 300.

The lanes hand sym_eig (R, k, k) batches, the single solves (k, k)
matrices, both through ops.lobpcg's reference to ops.kernels.syev. Each
version puts in that reference's place a stand-in kept for the whole run
whose sym_eig counts the batched calls and sends them to sym_eig
("sym_eig") or to torch.linalg.eigh ("eigh", what the lane form called
before), and the single solves' matrices to sym_eig in both. A
turn makes one untimed call, then `reps` timed ones (synchronised on the
card); the medians by version and their ratio follow. Every line names
the card and its power limit (the CPU's model name with --device cpu).
"""

import argparse
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

TURNS = ("eigh", "sym_eig", "sym_eig", "eigh")


def cpu_line() -> str:
    for ln in Path("/proc/cpuinfo").read_text().splitlines():
        if ln.startswith("model name"):
            return f"CPU {ln.split(':', 1)[1].strip()}"
    return "CPU"


def workloads(dev, only, small):
    """{name: zero-argument callable} of the two paths on dev."""
    import numpy as np

    from chip_smoke import pose_graph

    import mac_tpu_torch
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, GreedyEig, NaiveGreedy

    data = Path(mac_tpu_torch.__file__).resolve().parent.parent / "data"
    out = {}
    if small:
        for name, (n, loops, span, seed), steps in (
                ("sweep", (2000, 600, 40, 5), None),
                ("greedy", (300, 100, 30, 3), 4)):
            if only not in (None, name):
                continue
            idx, w, n = pose_graph(n, loops, span, seed)
            fixed, cands = (idx[:n - 1], w[:n - 1]), (idx[n - 1:], w[n - 1:])
            if steps is None:
                m = len(w) - (n - 1)
                ks = [int(f * m) for f in np.linspace(0.1, 0.5, 8)]
                mac = MAC(fixed, cands, n, device=dev)
                out[f"sweep n {n}, 8 lanes"] = (
                    lambda mac=mac, ks=ks: mac.solve_sweep(ks))
            else:
                eig = GreedyEig(fixed, cands, n, device=dev)
                out[f"GreedyEig n {n} subset({steps}), 64 lanes"] = (
                    lambda eig=eig, steps=steps: eig.subset(steps))
        return out
    if only in (None, "sweep"):
        meas, n = read_g2o_file(str(data / "city10000.g2o"))
        fixed, cands = split_edges(rpm_to_mac(meas))
        ks = [int(f * len(cands)) for f in np.linspace(0.1, 0.5, 8)]
        naive = NaiveGreedy(cands)
        X0 = np.stack([naive.subset(k) for k in ks])
        mac = MAC(fixed, cands, n, device=dev)
        out["sweep city10000, 8 lanes"] = lambda: mac.solve_sweep(ks, X0)
    if only in (None, "greedy"):
        meas, n = read_g2o_file(str(data / "intel.g2o"))
        fixed, cands = split_edges(rpm_to_mac(meas))
        eig = GreedyEig(fixed, cands, n, device=dev)
        out["GreedyEig intel subset(8), 64 lanes"] = lambda: eig.subset(8)
    return out


def main():
    import torch

    from mac_tpu_torch.ops import lobpcg
    from mac_tpu_torch.ops.kernels import syev

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", choices=("sweep", "greedy"))
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("lanes_ab: no CUDA device", file=sys.stderr)
            sys.exit(1)
        from chip_smoke import card_line
        where = card_line()
    else:
        where = f"{cpu_line()}, {torch.get_num_threads()} threads"
    print(where, flush=True)

    real = syev.sym_eig
    batched = {"sym_eig": 0, "eigh": 0}

    def make(version):
        def eig(H):
            if H.dim() == 2:
                return real(H)
            batched[version] += 1
            return torch.linalg.eigh(H) if version == "eigh" else real(H)
        return eig

    versions = {v: SimpleNamespace(sym_eig=make(v))
                for v in ("eigh", "sym_eig")}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    walls = {}
    small = args.small or dev.type == "cpu"
    for name, run in workloads(dev, args.only, small).items():
        for version in TURNS:
            with mock.patch.object(lobpcg, "_syev", versions[version]):
                run()
                sync()
                batched[version] = 0
                k4_0 = real.launches
                got = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    run()
                    sync()
                    got.append(time.perf_counter() - t0)
            walls.setdefault(name, {}).setdefault(version, []).extend(got)
            print(f"{version} {name}: walls {[round(t, 4) for t in got]} s; "
                  f"per call {batched[version] / args.reps:g} batched "
                  f"eigensolves, {(real.launches - k4_0) / args.reps:g} K4 "
                  f"launches ({where})", flush=True)
        e = statistics.median(walls[name]["eigh"])
        k = statistics.median(walls[name]["sym_eig"])
        print(f"summary {name}: median wall eigh {e:.4f} s, sym_eig {k:.4f} "
              f"s, sym_eig / eigh {k / e:.3f} ({where})", flush=True)


if __name__ == "__main__":
    main()

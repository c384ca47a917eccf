#!/usr/bin/env python3
"""Where a replayed warm solve's device time goes, kernel by kernel, on one
NVIDIA GPU.

    python3 profile_cg.py [--plain-cg] [--cells NAME,NAME,...]

For each of chip_smoke.py's phase-13 cells (city10000, city10000 at
fiedler_block_q=11, sphere2500, the n = 100000 expander of
scripts/bench_scale.py, banded float64 city10000), built as chip_smoke.py
builds them: one cold solve (it captures the graphs), one warm solve, then
one warm solve under torch.profiler with CUDA activity alone. Printed per
cell: the device busy milliseconds, the device kernels (copies and memsets
apart), the ten largest device items by name (milliseconds, calls,
microseconds a call), the TRACEMIN inner CG steps the solve ran (each
outer-iteration replay runs its key's inner_iters steps) and the kernels
per CG step (all the solve's kernels over its CG steps, a whole solve's
measure), and the kernels of one CG step alone: a replayed inner solve
(ops.graphs.inner_replay) of 6 steps less one of 5, over the route's state
after the warm solve (chip_smoke.step_kernels: the kernels counted from
the captured graphs' nodes, the ms from profiles of their replays).

Also per cell: K6's and K8's device time in the warm solve, all their
kernels (names with "k6_", "k8_") added up.
--plain-cg runs every solve with the plain CG step (the torch ops that the
kernels K5, K6, K1p, K7 and K8 stand for) on the card, as chip_smoke.py's
phase 13 does in its "plain-cg" turn: the account before the kernels, on
the same tree. --before DIR first runs DIR's profile_cg.py (an older
checkout, e.g. a `git archive` of the parent commit unpacked under build/)
on the same cells in a process of its own, then this tree's, and ends
with each cell's busy milliseconds, CG-step kernels and K6's and K8's
device time and calls before and after (before: the "k6_" items among the
older script's ten largest, where it prints no K6 line of its own), and
each cell's ten largest items before and after side by side.
Every line names the card and its power limit.
"""

import argparse
import re
import subprocess
import sys
import time
from contextlib import nullcontext

from chip_smoke import (BUNDLED, SCALE_N, card_line, device_items, fail,
                        step_kernels, synthetic)

CELLS = ("city10000", "city10000 q = 11", "sphere2500", f"n = {SCALE_N}",
         "city10000 banded float64")


def build_cells(names):
    """{name: (MAC, solve(), route operator)} of the cells asked for."""
    from pathlib import Path

    import numpy as np
    import torch

    import mac_tpu_torch
    from mac_tpu_torch.slam.pose_graph import (read_g2o_file, rpm_to_mac,
                                               split_edges)
    from mac_tpu_torch.solvers import MAC, NaiveGreedy

    data = Path(mac_tpu_torch.__file__).resolve().parent.parent / "data"

    def dataset(name):
        meas, n = read_g2o_file(str(data / f"{name}.g2o"))
        fixed, cands = split_edges(rpm_to_mac(meas))
        k = len(cands) // 2
        return fixed, cands, n, k, NaiveGreedy(cands).subset(k)

    out = {}
    for name in names:
        if name == "city10000":
            fixed, cands, n, k, x = dataset("city10000")
            mac = MAC(fixed, cands, n, device="cuda")
            out[name] = (mac, lambda m=mac, k=k, x=x: m.solve(
                k, x, rounding="nearest", use_cache=True))
        elif name == "city10000 q = 11":
            fixed, cands, n, k, x = dataset("city10000")
            mac = MAC(fixed, cands, n, fiedler_block_q=11, device="cuda")
            out[name] = (mac, lambda m=mac, k=k, x=x: m.solve(
                k, x, rounding="nearest", use_cache=True))
        elif name == "sphere2500":
            fixed, cands, n, k, x = dataset("sphere2500")
            mac = MAC(fixed, cands, n)
            if BUNDLED["sphere2500"][1] != "float32" or mac._banded is None:
                fail("sphere2500 left the banded float32 route")
            out[name] = (mac, lambda m=mac, k=k, x=x: m.solve(
                k, x, use_cache=True))
        elif name == f"n = {SCALE_N}":
            fi, wf, ci, wc = synthetic(SCALE_N, seed=0, local=False)
            k = len(wc) // 4
            x = np.zeros(len(wc))
            x[np.argsort(-wc)[:k]] = 1.0
            mac = MAC((fi, wf), (ci, wc), SCALE_N, fiedler_inner_iters=10,
                      fiedler_maxiter=60, fiedler_tol=6e-4, device="cuda")
            out[name] = (mac, lambda m=mac, k=k, x=x: m.solve(
                k, x, max_iters=10, use_cache=True))
        elif name == "city10000 banded float64":
            fixed, cands, n, k, x = dataset("city10000")
            mac = MAC(fixed, cands, n, use_banded=True, dtype=torch.float64,
                      device="cuda")
            out[name] = (mac, lambda m=mac, k=k, x=x: m.solve(
                k, x, max_iters=20))
        else:
            fail(f"unknown cell {name!r}; cells: {CELLS}")
    return out


class CountSteps:
    """Counts the inner CG steps of the replays ops.graphs.run makes: an
    outer-iteration graph (key ("outer", knobs)) runs knobs.inner_iters
    steps, an inner-only graph (key ("inner", iters)) iters."""

    def __enter__(self):
        from mac_tpu_torch.ops import graphs

        self.steps = 0
        self._run = graphs.run

        def run(route, key, fn, s):
            if key[0] == "outer":
                self.steps += key[1].inner_iters
            elif key[0] == "inner":
                self.steps += key[1]
            return self._run(route, key, fn, s)

        graphs.run = run
        return self

    def __exit__(self, *exc):
        from mac_tpu_torch.ops import graphs

        graphs.run = self._run
        return False


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain-cg", action="store_true",
                    help="the plain CG step on the card")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--before", metavar="DIR",
                    help="an older checkout to profile first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    card = card_line()
    print(card, flush=True)
    before, tags_before, tops_before = {}, {}, {}
    if args.before:
        cmd = [sys.executable, "profile_cg.py", "--cells", args.cells]
        if args.plain_cg:
            cmd.append("--plain-cg")
        proc = subprocess.run(cmd, cwd=args.before, capture_output=True,
                              text=True)
        cell = None
        for line in proc.stdout.splitlines():
            print(f"before | {line}", flush=True)
            got = re.match(r"(.+) \((?:kernels|plain CG step)\): .*device busy "
                           r"([0-9.]+) ms.*one CG step alone .*?: (\S+) "
                           r"kernels", line)
            if got:
                cell = got[1]
                before[cell] = (float(got[2]), got[3])
            tag = re.match(r"(K[68]) \(k[68]_\*\): ([0-9.]+) ms, (\d+) "
                           r"calls", line)
            item = re.match(r"\s+([0-9.]+) ms\s+(\d+) calls .*k6_", line)
            top = re.match(r"\s+([0-9.]+) ms\s+(\d+) calls\s+[0-9.]+ us a "
                           r"call  (.*)", line)
            if cell is not None and top:
                tops_before.setdefault(cell, []).append(
                    (float(top[1]), int(top[2]), top[3]))
            if cell is not None and tag:  # its own line: all of K6 or K8
                tags_before.setdefault(cell, {})[tag[1]] = [
                    float(tag[2]), int(tag[3])]
            elif cell is not None and item:
                got6 = tags_before.setdefault(cell, {}).setdefault(
                    "K6", [0.0, 0])
                got6[0] += float(item[1])
                got6[1] += int(item[2])
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            fail(f"the older profile_cg.py in {args.before} exited "
                 f"{proc.returncode}")
    import mac_tpu_torch  # noqa: F401 (sets the numerics policy)
    from concurrent.futures import ThreadPoolExecutor

    from mac_tpu_torch.ops.kernels import _build

    sources = [p.stem for p in _build.CSRC.glob("*.cu")]
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    way = "plain CG step" if args.plain_cg else "kernels"
    ctx = nullcontext
    if args.plain_cg:
        from chip_smoke import PlainCG as ctx
    after, tops = {}, {}
    for name, (mac, solve) in build_cells(args.cells.split(",")).items():
        with ctx():
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            solve()
            torch.cuda.synchronize()
            with CountSteps() as steps:
                busy, kernels, items = device_items(solve)
            per_step = step_kernels(mac._banded if mac._banded is not None
                                    else mac.op)
        print(f"{name} ({way}): cold solve {cold:.3f} s; one profiled warm "
              f"solve: device busy {busy:.3f} ms, {kernels} kernels, "
              f"{steps.steps} inner CG steps, {kernels / max(steps.steps, 1):.1f}"
              f" kernels a CG step; one CG step alone (6 less 5 replayed): "
              f"{per_step[0]} kernels, {per_step[1]:.4f} ms ({card})",
              flush=True)
        for ms, cnt, nm in items[:10]:
            print(f"  {ms:9.3f} ms {cnt:7d} calls {1e3 * ms / cnt:8.2f} us "
                  f"a call  {nm[:110]}", flush=True)
        tagged = {}
        for tag in ("k6_", "k8_"):
            got = [(ms, cnt) for ms, cnt, nm in items if tag in nm]
            ms, cnt = sum(m for m, _ in got), sum(c for _, c in got)
            tagged[tag.upper()[:2]] = (ms, cnt)
            print(f"{tag.upper()[:2]} ({tag}*): {ms:.3f} ms, {cnt} calls in "
                  f"the warm solve ({card})", flush=True)
        tops[name] = items[:10]
        after[name] = (busy, per_step[0], tagged)
    for name, (busy, step, tagged) in after.items():
        if name in before:
            was = tags_before.get(name, {})
            print(f"summary {name}: device busy {before[name][0]:.3f} -> "
                  f"{busy:.3f} ms ({busy / before[name][0]:.3f}), one CG step "
                  f"{before[name][1]} -> {step} kernels, " + ", ".join(
                      f"{t} {was.get(t, [float('nan'), 0])[0]:.3f} ms / "
                      f"{was.get(t, [0, 0])[1]} -> {ms:.3f} ms / {cnt}"
                      for t, (ms, cnt) in tagged.items()) + f" ({card})",
                  flush=True)
            for i, (old, new) in enumerate(zip(
                    tops_before.get(name, []) + [None] * 10, tops[name])):
                old = ("-" if old is None
                       else f"{old[0]:.3f} ms / {old[1]} {old[2][:50]}")
                print(f"summary {name} largest {i + 1}: before {old}; after "
                      f"{new[0]:.3f} ms / {new[1]} {new[2][:50]}", flush=True)
    print(f"profile_cg: done ({card})", flush=True)


if __name__ == "__main__":
    sys.exit(main())

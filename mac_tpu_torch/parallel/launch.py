"""Start a mesh's ranks on one host, and the mesh's dry run.

    from mac_tpu_torch.parallel.launch import spawn
    results = spawn(fn, 4, device_type="cpu", timeout_s=120, args=(data,))

runs fn(rank, world, *args) in `world` fresh processes (the spawn start
method) that share a process group: NCCL with one GPU per rank for
device_type="cuda", gloo for "cpu" (one torch thread per rank). The ranks
meet at a file:// rendezvous in a temporary directory, so concurrent
launches on one host never contend for a port. fn must be importable by
its module path from a module that needs no more than torch, numpy and
this package: each rank imports it anew. spawn returns each rank's return
value in rank order; a rank that raises, exits non-zero or outlives the
deadline stops every rank and raises here.

Under torchrun (one process per GPU, the group's address in the
environment) no launcher is needed: init_process_group() then
mesh.make_mesh().

dryrun_multigpu(n) is the counterpart of the JAX package's
__graft_entry__.dryrun_multichip: one Frank-Wolfe step over lanes, a capped
solve, the budget sweep over 'sweep', and a banded solve, on a mesh of n
ranks.
"""

import datetime
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, fn, args, device_type, init, timeout_s, out):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method=init,
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # Every rank has joined before fn runs: a rank whose fn returns
            # at once would otherwise tear the group down while a peer is
            # still in its connection handshake (gloo's connectFullMesh then
            # fails there with "Connection closed by peer").
            dist.barrier(device_ids=[rank] if device_type == "cuda"
                         else None)
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(f"{out}.{rank}", "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        Path(f"{out}.{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(fn, world: int, *, device_type: str = "cuda",
          timeout_s: float = 300.0, args: tuple = ()):
    """fn(rank, world, *args) on `world` new ranks; see the module
    docstring. Returns [rank 0's result, ...]."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device_type {device_type!r}")
    if device_type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} GPUs; this host has "
                           f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mac_mesh_") as tmp:
        init = f"file://{tmp}/rendezvous"
        out = f"{tmp}/result"
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, fn, args, device_type, init, timeout_s, out))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
                        f":\n{_error(out, bad[0])}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} exited with {procs[bad[0]].exitcode}:\n"
                    f"{_error(out, bad[0])}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _error(out: str, rank: int) -> str:
    path = Path(f"{out}.{rank}.err")
    return path.read_text() if path.exists() else "(no traceback)"


def synthetic_pose_graph(n=512, n_loops=128, seed=7):
    """Chain (odometry) plus random loop closures: ((fixed_idx, fixed_w),
    (cand_idx, cand_w), n). The synthetic instance of the JAX package's
    __graft_entry__, draw for draw."""
    rng = np.random.RandomState(seed)
    fixed_idx = np.stack([np.arange(n - 1), np.arange(1, n)],
                         axis=1).astype(np.int32)
    fixed_w = 0.5 + rng.rand(n - 1)
    cand = set()
    while len(cand) < n_loops:
        i, j = rng.randint(0, n, 2)
        if abs(int(i) - int(j)) > 1:
            cand.add((min(i, j), max(i, j)))
    cand_idx = np.array(sorted(cand), dtype=np.int32)
    cand_w = 0.5 + rng.rand(len(cand))
    return (fixed_idx, fixed_w), (cand_idx, cand_w), n


def dryrun_rank(rank, world, device_type):
    """One rank of dryrun_multigpu, in a started process group of `world`
    ranks. Returns a summary dict (the same on every rank)."""
    from mac_tpu_torch.parallel import sharded
    from mac_tpu_torch.parallel.mesh import make_mesh
    from mac_tpu_torch.solvers import MAC

    n_sweep = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(n_graph=world // n_sweep, n_sweep=n_sweep,
                     device_type=device_type)
    fixed, cands, n = synthetic_pose_graph(n=128, n_loops=48)
    mac = MAC(fixed, cands, n, mesh=mesh, fiedler_maxiter=25,
              fiedler_inner_iters=4)
    if not isinstance(mac._sharded, sharded.ShardedLaplacian):
        raise AssertionError("the mesh solve did not take the row-sharded "
                             "ELL product")
    if mac._sharded.nbr_tbl.shape[0] * mac._group.size != mac._sharded.n_pad:
        raise AssertionError("the rank holds more than its row block")
    m = len(mac.weights)
    k = m // 3

    # One Frank-Wolfe step on a batch of start points, as lanes.
    batch = max(n_sweep, 2)
    xs = torch.stack([torch.full((m,), (i + 1) / (batch + 1), dtype=mac.dtype,
                                 device=mac.device) for i in range(batch)])
    f, grad, _, _ = mac._problem_impl(mac._params, xs,
                                      mac._X0.expand(batch, *mac._X0.shape))
    s = torch.stack([sharded.sharded_top_k_indicator(mac._group, g, k)
                     for g in grad])
    x_new = xs + 0.5 * (s - xs)
    if tuple(x_new.shape) != (batch, m) or not bool((f > 0).all()):
        raise AssertionError(f"FW step: shape {tuple(x_new.shape)}, "
                             f"lambda_2 {f.tolist()}")

    rounded, _, upper = mac.solve(k, np.full(m, k / m), max_iters=3)
    if int(rounded.sum()) != k:
        raise AssertionError(f"solve rounded {rounded.sum()} edges, want {k}")
    ks = [k // 2, k][:batch] + [k] * max(batch - 2, 0)
    r_sw, _, u_sw = mac.solve_sweep(ks, max_iters=3)
    if [int(v) for v in r_sw.sum(axis=1)] != ks:
        raise AssertionError(f"sweep rounded {r_sw.sum(axis=1)}, want {ks}")

    fixed_b, cands_b, n_b = synthetic_pose_graph(n=640, n_loops=160, seed=9)
    mac_b = MAC(fixed_b, cands_b, n_b, mesh=mesh, use_banded=True,
                dtype=torch.float32, fiedler_maxiter=8, fiedler_inner_iters=4)
    if not isinstance(mac_b._sharded, sharded.ShardedBanded):
        raise AssertionError("the banded solve is not row-sharded")
    kb = len(mac_b.weights) // 3
    rb, _, _ = mac_b.solve(kb, np.full(len(mac_b.weights), 0.3), max_iters=2)
    if int(rb.sum()) != kb:
        raise AssertionError(f"banded solve rounded {rb.sum()}, want {kb}")
    return {"mesh": (n_sweep, world // n_sweep), "m": m, "batch": batch,
            "lambda2": [float(v) for v in f], "upper": float(upper),
            "sweep_upper": [float(v) for v in u_sw], "banded_n": n_b}


def dryrun_multigpu(n_ranks: int, device_type: str = "cuda",
                    timeout_s: float = 600.0) -> dict:
    """The mesh's dry run on n_ranks ranks (a 2 x n/2 mesh for even
    n >= 4, else 1 x n): in this process when it already holds a process
    group of n_ranks ranks (rank functions then run here), else on ranks
    started by spawn. Returns rank 0's summary; raises on any failure."""
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise ValueError(f"the running process group has "
                             f"{dist.get_world_size()} ranks, not {n_ranks}")
        return dryrun_rank(dist.get_rank(), n_ranks, device_type)
    return spawn(dryrun_rank, n_ranks, device_type=device_type,
                 timeout_s=timeout_s, args=(device_type,))[0]

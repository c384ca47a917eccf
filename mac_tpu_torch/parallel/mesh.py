"""Device meshes over torch.distributed (PyTorch counterpart of
mac_tpu.parallel.mesh).

A mesh is a torch.distributed.device_mesh.DeviceMesh whose dimensions are
named ("sweep", "graph"), the axis names of the JAX package's Mesh:

  * 'graph': the node rows (or the edges) of the Laplacian tables and the
    candidate edges are split over its ranks; the eigenvector block stays
    replicated and each product ends in one collective on this group.
  * 'sweep': the budget lanes of MAC.solve_sweep are split over its ranks
    (data parallelism), each coordinate solving its lanes with its own
    'graph' group.

The mesh spans every rank of the default process group, one GPU per rank
on the card.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

MESH_DIMS = ("sweep", "graph")
# The single-buffer all-gather: all_gather_single where torch has it (it
# deprecates the older name), else all_gather_into_tensor; one signature.
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def make_mesh(n_graph: Optional[int] = None, n_sweep: int = 1,
              device_type: str = "cuda"):
    """A ("sweep", "graph") DeviceMesh of n_sweep x n_graph ranks over the
    started process group (n_graph defaults to world // n_sweep).

    Raises when no process group has been started, when the shape does not
    cover the world, or, for device_type="cuda", when this rank has no GPU
    of its own (local rank LOCAL_RANK, else the global rank, on this host);
    under CUDA it makes that GPU the current device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs a started process group: run under torchrun "
            "or mac_tpu_torch.parallel.launch.spawn, or call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_graph is None:
        n_graph = world // n_sweep
    if n_sweep < 1 or n_graph < 1 or n_sweep * n_graph != world:
        raise ValueError(f"a {n_sweep} x {n_graph} mesh does not cover the "
                         f"{world} ranks of the process group")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(
                f"rank {dist.get_rank()} (local rank {local}) has no GPU of "
                f"its own: this host has {count}")
        torch.cuda.set_device(local)
    elif device_type != "cpu":
        raise ValueError(f"unknown device_type {device_type!r}")
    return init_device_mesh(device_type, (n_sweep, n_graph),
                            mesh_dim_names=MESH_DIMS)


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is a ("sweep", "graph") DeviceMesh over the
    whole of a started process group."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("mesh given but no process group is started")
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"mesh dimensions {mesh.mesh_dim_names}, want "
                         f"{MESH_DIMS}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the "
                         f"{dist.get_world_size()} ranks; it must hold all")


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: its current GPU, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` of x up to a multiple of `multiple` (static host-side).
    Returns (padded, original size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, constant_values=fill), size


def replicated(mesh):
    """Placements of a tensor replicated on every rank."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * mesh.ndim


def row_sharded(mesh):
    """Placements of a tensor whose rows are split over 'graph'."""
    from torch.distributed.tensor import Replicate, Shard
    return (Replicate(), Shard(0))


def sweep_sharded(mesh):
    """Placements of a tensor whose rows are split over 'sweep'."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


class MeshGroup:
    """This rank's group along one dimension of a mesh ('graph' by
    default), with the collectives the sharded products need: `size`
    ranks, this one `rank`; tensors live on `device`."""

    def __init__(self, mesh, dim: str = "graph"):
        check_mesh(mesh)
        self.group = mesh.get_group(dim)
        self.size = mesh.size(MESH_DIMS.index(dim))
        self.rank = mesh.get_local_rank(mesh_dim=dim)
        self.device = mesh_device(mesh)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's t (equal shapes), concatenated along `dim` in rank
        order: one gather into a single (size, *t.shape) buffer, a view
        of it for dim 0."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        _gather_into(out, t, group=self.group)
        dim = dim % t.dim()
        return out.view(self.size, *t.shape).movedim(0, dim).reshape(
            *t.shape[:dim], self.size * t.shape[dim], *t.shape[dim + 1:])

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's t."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def agree(self, flag) -> bool:
        """bool(flag) agreed over the group: true only where it is true on
        every rank (one all-reduce MIN). The ranks' replicated arithmetic
        may differ in its last bits (atomics on the card), so a loop test
        read on one rank alone could leave it in a loop whose collectives
        the others no longer join."""
        t = torch.as_tensor(flag, device=self.device).to(
            torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return bool(t.item())


def same_on_every_rank(mesh, *arrays):
    """numpy arrays (or floats) as the mesh's first rank holds them, on
    every rank: one broadcast over the default group. Returns them in the
    types given (floats as float)."""
    check_mesh(mesh)
    dev = mesh_device(mesh)
    flat = [np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays]
    buf = torch.as_tensor(np.concatenate(flat), device=dev)
    dist.broadcast(buf, src=int(mesh.mesh.reshape(-1)[0]))
    buf = buf.cpu().numpy()
    out, at = [], 0
    for a, f in zip(arrays, flat):
        v = buf[at:at + f.size]
        at += f.size
        if isinstance(a, (float, np.floating)):
            out.append(float(v[0]))
        else:
            out.append(v.reshape(np.shape(a)).astype(np.asarray(a).dtype))
    return out

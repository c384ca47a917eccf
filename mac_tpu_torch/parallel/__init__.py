"""The multi-GPU layer (PyTorch counterpart of mac_tpu.parallel).

One process per GPU under torch.distributed (started by torchrun or by
mac_tpu_torch.parallel.launch.spawn); a DeviceMesh with the dimensions
("sweep", "graph"): the 'graph' dimension shards the Laplacian products
(mac_tpu_torch.parallel.sharded), the 'sweep' dimension the budget lanes
of MAC.solve_sweep. Collectives run over NCCL on the card and gloo on the
CPU. Every rank runs the same host set-up and the same replicated algebra;
the ranks agree over the group on every host-side loop decision, so that
every rank issues the same collectives.
"""

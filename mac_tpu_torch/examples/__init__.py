"""Example drivers of the PyTorch port, run from the root of a checkout as
`python -m mac_tpu_torch.examples.<name>` (on the CUDA device; --cpu runs
them on the CPU)."""

"""Device and numerics policy of the port.

Float32 matrix products run in full float32: TF32 is off for cuBLAS and
cuDNN. (The TPU reference computes its HIGHEST-precision products in exact
float32 and its DEFAULT-precision ones -- the coarse operator R^T (L R) and
the preconditioner's residual applies -- in one bf16 pass; the port runs
both in float32.) Devices are explicit: nothing moves to another device on
its own.
"""

import torch


def configure_numerics() -> None:
    """Turn TF32 off for float32 matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' explicitly to run "
                           "the plain PyTorch versions on the host")
    return dev

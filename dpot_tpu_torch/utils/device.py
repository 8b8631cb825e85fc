"""Device selection for the port's entry points.

Every entry point runs on CUDA unless its caller asks for the CPU. Without a
GPU, a CUDA request raises instead of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """torch.device for `device` (None means cuda). On CUDA, float32 matrix
    products and convolutions are held to full float32 (TF32 off), the
    precision the JAX reference and the parity tests assume."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}: use 'cuda' or 'cpu'")
    return d

"""Device selection for the port's entry points.

Every entry point runs on CUDA unless its caller asks for the CPU. Without a
GPU, a CUDA request raises instead of carrying on quietly on the CPU. Under
torchrun a rank's "cuda" is cuda:LOCAL_RANK, and a rank whose card does not
exist raises; an explicit index (cuda:0) is taken as it is, which is how
several ranks share one card.
"""

from __future__ import annotations

import os

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
        if d.index is None and "LOCAL_RANK" in os.environ:
            d = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank with LOCAL_RANK {d.index} has no card: this host has "
                    f"{torch.cuda.device_count()}; launch one rank per card, or name "
                    "the card (--device cuda:0) with --dist_backend gloo")
        if d.index is not None:
            torch.cuda.set_device(d)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif d.type != "cpu":
        raise ValueError(f"unsupported device {d}: use 'cuda' or 'cpu'")
    return d

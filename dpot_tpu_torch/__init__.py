"""dpot_tpu_torch: the PyTorch/CUDA port of dpot_tpu for NVIDIA Hopper.

The JAX package `dpot_tpu` stays the reference; this package imports torch,
numpy and the standard library only. Its layout mirrors the JAX package
(ops/, models/, serve/, cli/, utils/, train/interop.py). The norm1 GroupNorm
and AFNO mixer of every DPOT trunk block run through a hand-written CUDA
kernel (ops/cuda/afno_fused.py, csrc/afno_fused.cu), built with nvcc at
first use. Entry points run on CUDA unless the caller passes device="cpu",
where the kernels' plain PyTorch versions run instead.
"""

from dpot_tpu_torch.models import MODEL_PRESETS, build_model

__all__ = ["MODEL_PRESETS", "build_model"]

"""Model registry and the reference's scale ladder presets (port of
dpot_tpu/models/registry.py). The DPOT 2D and 3D families are ported so
far."""

from __future__ import annotations

from typing import Any

import torch

from dpot_tpu_torch.utils.device import resolve_device

MODEL_PRESETS: dict[str, dict[str, Any]] = {
    "Ti": dict(embed_dim=512, mlp_ratio=1.0, depth=4, n_blocks=4, out_layer_dim=32),
    "S": dict(embed_dim=1024, mlp_ratio=1.0, depth=6, n_blocks=8, out_layer_dim=32),
    "M": dict(embed_dim=1024, mlp_ratio=4.0, depth=12, n_blocks=8, out_layer_dim=32),
    "L": dict(embed_dim=1536, mlp_ratio=4.0, depth=24, n_blocks=16, out_layer_dim=128),
    "H": dict(embed_dim=2048, mlp_ratio=3.951171875, depth=27, n_blocks=8, out_layer_dim=128),
}

_NOT_PORTED = ("FNO", "fno", "FNO3D", "fno3d", "UNet", "unet", "CDPOT", "cdpot")


def build_model(
    model: str = "DPOT",
    *,
    img_size: int = 128,
    patch_size: int = 8,
    in_channels: int = 4,
    out_channels: int | None = None,
    in_timesteps: int = 10,
    out_timesteps: int = 1,
    modes: int = 32,
    n_cls: int = 12,
    normalize: bool = False,
    act: str = "gelu",
    use_ln: int = 0,
    remat: bool = False,
    preset: str | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = "cuda",
    seed: int = 0,
    **overrides,
):
    """Build a model by family name on `device` (CUDA unless the caller
    asks for the CPU), its weights drawn from `seed`. remat recomputes each
    trunk block in the backward. use_ln belongs to the FNO family and is
    ignored here, as in the JAX package. DPOT3D takes `temporal_modes`
    (default 8) among the overrides, and returns the prediction only."""
    del use_ln
    kwargs: dict[str, Any] = dict(
        img_size=img_size, patch_size=patch_size, in_channels=in_channels,
        out_channels=out_channels if out_channels is not None else in_channels,
        in_timesteps=in_timesteps, out_timesteps=out_timesteps, modes=modes,
        n_cls=n_cls, normalize=normalize, act=act, remat=remat,
    )
    if preset is not None:
        kwargs.update(MODEL_PRESETS[preset])
    kwargs.update(overrides)
    # 'AFNO' is the reference's legacy name for the AFNO-mixer transformer
    if model in ("DPOT", "dpot", "AFNO", "afno"):
        from dpot_tpu_torch.models.dpot import DPOTNet

        return DPOTNet(**kwargs, dtype=dtype, device=resolve_device(device), seed=seed)
    if model in ("DPOT3D", "dpot3d"):
        from dpot_tpu_torch.models.dpot3d import DPOTNet3D

        return DPOTNet3D(**kwargs, dtype=dtype, device=resolve_device(device), seed=seed)
    if model in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {model!r} is not ported yet (ROADMAP, 'Modules to "
            "port', item 11: the other model families)"
        )
    raise ValueError(f"unknown model family {model!r}")

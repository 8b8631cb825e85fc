"""Model registry and the reference's scale ladder presets (port of
dpot_tpu/models/registry.py): DPOT 2D and 3D, CDPOT, FNO 2D and 3D, UNet,
with the JAX registry's mapping of arguments per family. The MLPs
(models/mlp.py) are built directly, as in the JAX package."""

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
    asks for the CPU), its weights drawn from `seed`, mapping the arguments
    as the JAX registry does: DPOT, DPOT3D and CDPOT take them all (DPOT3D
    `temporal_modes`, default 8, among the overrides, and returns the
    prediction only); FNO takes width = embed_dim (default 768), n_layers =
    depth (default 4) and use_ln (GroupNorm(4) layers, FNO only); FNO3D the
    same but no patch_size, act or normalize (pred-only, GELU); UNet width =
    out_layer_dim (default 32), n_dim 2, and no patch_size, modes or
    normalize. remat recomputes each trunk block in the backward: the AFNO
    trunks only (the FNOs have none, and would run UNet's BatchNorm twice)."""
    kwargs: dict[str, Any] = dict(
        img_size=img_size, patch_size=patch_size, in_channels=in_channels,
        out_channels=out_channels if out_channels is not None else in_channels,
        in_timesteps=in_timesteps, out_timesteps=out_timesteps, modes=modes,
        n_cls=n_cls, normalize=normalize, act=act, remat=remat,
    )
    if preset is not None:
        kwargs.update(MODEL_PRESETS[preset])
    kwargs.update(overrides)
    use_ln = bool(kwargs.pop("use_ln", use_ln))
    common = dict(dtype=dtype, device=resolve_device(device), seed=seed)
    # 'AFNO' is the reference's legacy name for the AFNO-mixer transformer
    if model in ("DPOT", "dpot", "AFNO", "afno"):
        from dpot_tpu_torch.models.dpot import DPOTNet

        return DPOTNet(**kwargs, **common)
    if model in ("DPOT3D", "dpot3d"):
        from dpot_tpu_torch.models.dpot3d import DPOTNet3D

        return DPOTNet3D(**kwargs, **common)
    if model in ("CDPOT", "cdpot"):
        from dpot_tpu_torch.models.cdpot import CDPOTNet

        return CDPOTNet(**kwargs, **common)
    if model not in ("FNO", "fno", "FNO3D", "fno3d", "UNet", "unet"):
        raise ValueError(f"unknown model family {model!r}")
    if kwargs["remat"]:
        raise ValueError(f"remat recomputes AFNO trunk blocks, which {model} does not have")
    k = kwargs
    width = k.get("embed_dim", 768)
    n_layers = k.get("depth", 4)
    if model in ("FNO", "fno"):
        from dpot_tpu_torch.models.fno import FNO2d

        return FNO2d(k["modes"], k["modes"], width, img_size=k["img_size"],
                     n_channels=k["in_channels"], in_timesteps=k["in_timesteps"],
                     out_timesteps=k["out_timesteps"], n_layers=n_layers,
                     patch_size=k["patch_size"], use_ln=use_ln, normalize=k["normalize"],
                     n_cls=k["n_cls"], act=k["act"], **common)
    if model in ("FNO3D", "fno3d"):
        from dpot_tpu_torch.models.fno import FNO3d

        return FNO3d(k["modes"], k["modes"], k["modes"], width, img_size=k["img_size"],
                     n_channels=k["in_channels"], in_timesteps=k["in_timesteps"],
                     out_timesteps=k["out_timesteps"], n_layers=n_layers, use_ln=use_ln,
                     **common)
    from dpot_tpu_torch.models.unet import UNet

    return UNet(in_channels=k["in_channels"], out_channels=k["out_channels"],
                out_timesteps=k["out_timesteps"], width=k.get("out_layer_dim", 32),
                n_dim=2, act=k["act"], n_cls=k["n_cls"], in_timesteps=k["in_timesteps"],
                img_size=k["img_size"], **common)

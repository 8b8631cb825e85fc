"""CDPOTNet, the CNO-hybrid DPOT (port of dpot_tpu/models/cdpot.py).

The trunk is DPOTNet's: the same `Block`, so norm1 and the AFNO mixer of
every block run as `fused_gn_afno` (the Hopper kernels on the card). What
differs is at both ends:
- the patch embed (`CNOPatchEmbed`) puts the filtered LeakyReLU
  (ops/resample.py `lrelu_filtered`, with its own bias) between the strided
  patch conv (the (x, y, t) grid folded in) and the 1x1 conv, and runs it per
  frame on (B*T, h, h, E);
- the output head starts with a `CNOBlock` (the low-pass filter, identity at
  conv_kernel 1; a conv; the filtered activation resampling the latent to
  the image's resolution) instead of a transposed conv.

Parameter names and shapes are those of the reference state dict
(the layout dpot_tpu/train/interop.py `cdpot_params_from_torch` reads). The
reference registers one activation module twice, as
`patch_embed.act_patching` and as `patch_embed.proj.1`, so its state dict
carries both `...act_patching.bias` and `...proj.1.bias`; the port does the
same, so such a file loads with strict=True and the parameter is one.
I/O and dtypes as DPOTNet: (B, X, Y, T, C) -> (pred, cls_logits).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dpot_tpu_torch.models.dpot import (
    Activation,
    Block,
    Dense,
    PatchConv,
    TimeAggregator,
)
from dpot_tpu_torch.ops.initializers import torch_uniform, trunc_normal
from dpot_tpu_torch.ops.norms import instance_stats
from dpot_tpu_torch.ops.resample import low_pass_filter, lrelu_filtered
from dpot_tpu_torch.utils.device import resolve_device


class FilteredLReLU(nn.Module):
    """LReLu_torch as a module: its bias (zeros at init, as in JAX) and the
    resampling sizes."""

    def __init__(self, channels: int, in_size: int, out_size: int | None = None):
        super().__init__()
        self.in_size = in_size
        self.out_size = out_size
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return lrelu_filtered(x, self.bias, self.in_size, self.out_size)


class Conv2d(nn.Module):
    """Conv2d with 'same' padding on channels-last (B, H, W, C), weight
    (O, I, k, k) as the reference's; a 1x1 one is a matmul."""

    def __init__(self, in_channels: int, out_channels: int, k: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        fan_in = in_channels * k * k
        self.dtype = dtype
        self.weight = nn.Parameter(torch_uniform((out_channels, in_channels, k, k), fan_in,
                                                 generator))
        self.bias = nn.Parameter(torch_uniform((out_channels,), fan_in, generator))

    def forward(self, x):
        dt = self.dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if w.shape[-1] == 1:
            return F.linear(x.to(dt), w[:, :, 0, 0], b)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w, b, padding="same")
        return y.permute(0, 2, 3, 1)


class CNOPatchEmbed(nn.Module):
    """Patch conv (grid folded in) -> per-frame filtered LeakyReLU -> 1x1
    conv: (B, H, W, T, C) -> (B*T, h, h, out_dim)."""

    def __init__(self, in_channels: int, p: int, embed_dim: int, out_dim: int,
                 latent_size: int, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.latent_size = latent_size
        self.act_patching = FilteredLReLU(embed_dim, latent_size)
        self.proj = nn.ModuleList([
            PatchConv(in_channels, embed_dim, p, dtype, generator),
            self.act_patching,
            Conv2d(embed_dim, out_dim, 1, dtype, generator),
        ])

    def forward(self, x):
        B, T = x.shape[0], x.shape[3]
        h = self.latent_size
        x = self.proj[0](x)                                      # (B, h, h, T, E)
        x = x.permute(0, 3, 1, 2, 4).reshape(B * T, h, h, x.shape[-1])
        return self.proj[2](self.proj[1](x))


class CNOBlock(nn.Module):
    """Low-pass filter -> conv -> filtered LeakyReLU resampling in_size to
    out_size, on (B, H, W, C)."""

    def __init__(self, in_channels: int, out_channels: int, in_size: int, out_size: int,
                 conv_kernel: int, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.conv_kernel = conv_kernel
        self.convolution = Conv2d(in_channels, out_channels, conv_kernel, dtype, generator)
        self.activation = FilteredLReLU(out_channels, in_size, out_size)

    def forward(self, x):
        return self.activation(self.convolution(low_pass_filter(x, self.conv_kernel)))


class CDPOTNet(nn.Module):
    """Full CDPOT model; construction, devices, dtypes and `remat` as
    DPOTNet's."""

    def __init__(
        self,
        img_size: int = 224,
        patch_size: int = 16,
        in_channels: int = 1,
        out_channels: int = 4,
        in_timesteps: int = 1,
        out_timesteps: int = 1,
        n_blocks: int = 4,
        embed_dim: int = 768,
        out_layer_dim: int = 32,
        depth: int = 12,
        modes: int = 32,
        mlp_ratio: float = 1.0,
        n_cls: int = 12,
        normalize: bool = False,
        act: str = "gelu",
        time_agg: str = "exp_mlp",
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = "cuda",
        seed: int = 0,
        remat: bool = False,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        p = patch_size
        h = img_size // p
        self.img_size = img_size
        self.patch_size = p
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.in_timesteps = in_timesteps
        self.out_timesteps = out_timesteps
        self.normalize = normalize
        self.dtype = dtype
        self.remat = remat

        if normalize:
            self.scale_feats_mu = Dense(2 * in_channels, embed_dim, g)
            self.scale_feats_sigma = Dense(2 * in_channels, embed_dim, g)
        # the reference's width of the patch conv: out_channels * p + 3
        self.patch_embed = CNOPatchEmbed(in_channels, p, out_channels * p + 3, embed_dim, h,
                                         dtype, g)
        self.pos_embed = nn.Parameter(trunc_normal((1, embed_dim, h, h), g))
        self.time_agg_layer = TimeAggregator(in_timesteps, embed_dim, time_agg, dtype, g)
        self.blocks = nn.ModuleList([
            Block(embed_dim, n_blocks, modes, mlp_ratio, act, dtype, g)
            for _ in range(depth)
        ])
        self.cls_head = nn.ModuleList([
            Dense(embed_dim, embed_dim, g), Activation(act),
            Dense(embed_dim, embed_dim, g), Activation(act),
            Dense(embed_dim, n_cls, g),
        ])
        self.out_layer = nn.ModuleList([
            CNOBlock(embed_dim, out_layer_dim, h, img_size, 1, dtype, g),
            Conv2d(out_layer_dim, out_layer_dim, 1, dtype, g),
            Activation(act),
            Conv2d(out_layer_dim, out_channels * out_timesteps, 1, dtype, g),
        ])
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, H, W, T, C = x.shape
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"input {H}x{W} != model img_size {self.img_size}")
        dt = self.dtype
        h = H // self.patch_size

        if self.normalize:
            mu, sigma = instance_stats(x, dims=(1, 2, 3))
            x = (x - mu) / sigma
            stats = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0, :]
            scale_mu = self.scale_feats_mu(stats)[:, None, None, :]
            scale_sigma = self.scale_feats_sigma(stats)[:, None, None, :]

        x = self.patch_embed(x)                                  # (B*T, h, h, D)
        x = x + self.pos_embed.permute(0, 2, 3, 1)
        x = x.reshape(B, T, h, h, -1).permute(0, 2, 3, 1, 4)     # (B, h, h, T, D)
        x = self.time_agg_layer(x)
        if self.normalize:
            x = scale_sigma.to(dt) * x + scale_mu.to(dt)

        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                 if remat else blk(x))

        ct = x.mean(dim=(1, 2)).float()
        for layer in self.cls_head:
            ct = layer(ct)

        for layer in self.out_layer:
            x = layer(x)
        x = x.reshape(B, H, W, self.out_timesteps, self.out_channels)
        if self.normalize:
            x = x * sigma + mu
        return x.float(), ct.float()

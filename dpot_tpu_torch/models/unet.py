"""UNet baseline, dimension-generic (1/2/3D) (port of
dpot_tpu/models/unet.py; the registry builds it in 2D).

Four levels of double convolutions (conv3 -> BatchNorm -> act, twice),
max-pool 2, transposed-conv upsampling with skip concatenations, every
spatial axis zero-padded on the right to a multiple of 16 and cropped back,
the coordinate grid channels first and the data second, a 1x1 output conv,
and zero class logits. The body runs channels-first (NC...), as torch's
convolutions want it; the model's I/O is channels-last, (B, spatial..., T,
C) in and ((B, spatial..., T_out, C_out), zeros (B, n_cls)) out.

`BatchNorm` is torch.nn.BatchNorm{1,2,3}d's arithmetic in float32 (cast back
to the input's dtype): in train mode it normalises with the biased batch
variance and updates its running buffers with momentum 0.1 and the unbiased
one; in eval mode it normalises with the buffers. The buffers ride in the
state dict (`running_mean`, `running_var`, `num_batches_tracked`), so the
reference's state dict loads with strict=True; JAX threads the same
statistics as its `batch_stats` collection. A train step's rollout updates
them once per model application, as JAX does; the eval rollout and serving
run in eval mode. Parameter names are the reference's (the layout of
dpot_tpu/train/interop.py `unet_params_from_torch`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpot_tpu_torch.models.dpot import Activation
from dpot_tpu_torch.models.fno import axis_grid
from dpot_tpu_torch.ops.initializers import torch_uniform
from dpot_tpu_torch.utils.device import resolve_device


class BatchNorm(nn.Module):
    """Batch norm over every axis but 1 of (N, C, ...)."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        x32 = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x32.mean(dim=dims)
            var = (x32 - mean.reshape(shape)).square().mean(dim=dims)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        xn = (x32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return (xn * self.weight.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class ConvNd(nn.Module):
    """An n-d convolution with 'same' padding (or, transposed, a kernel-2
    stride-2 upsampling) in the compute dtype; weights in the reference's
    layouts, torch's default init (a transposed conv's fan-in from its
    output channels, as torch computes it)."""

    def __init__(self, in_channels: int, out_channels: int, k: int, n_dim: int,
                 dtype: torch.dtype, generator: torch.Generator, bias: bool = True,
                 transposed: bool = False):
        super().__init__()
        self.n_dim = n_dim
        self.dtype = dtype
        self.transposed = transposed
        if transposed:
            shape, fan_in = (in_channels, out_channels), out_channels * k ** n_dim
        else:
            shape, fan_in = (out_channels, in_channels), in_channels * k ** n_dim
        self.weight = nn.Parameter(torch_uniform(shape + (k,) * n_dim, fan_in, generator))
        self.bias = (nn.Parameter(torch_uniform((out_channels,), fan_in, generator))
                     if bias else None)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.transposed:
            fn = getattr(F, f"conv_transpose{self.n_dim}d")
            return fn(x.to(dt), self.weight.to(dt), b, stride=2)
        fn = getattr(F, f"conv{self.n_dim}d")
        return fn(x.to(dt), self.weight.to(dt), b, padding="same")


class DoubleConv(nn.Module):
    """{name}conv1 -> {name}norm1 -> act -> {name}conv2 -> {name}norm2 -> act,
    under the reference's module names."""

    def __init__(self, in_channels: int, features: int, name: str, n_dim: int, act: str,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.names = []
        for j, c_in in ((1, in_channels), (2, features)):
            for part, mod in ((f"conv{j}", ConvNd(c_in, features, 3, n_dim, dtype, generator,
                                                  bias=False)),
                              (f"norm{j}", BatchNorm(features)),
                              (f"act{j}", Activation(act))):
                setattr(self, name + part, mod)
                self.names.append(name + part)

    def forward(self, x):
        for n in self.names:
            x = getattr(self, n)(x)
        return x


class UNet(nn.Module):
    """The UNet; in_channels and in_timesteps give the first conv's inputs
    (in_timesteps * in_channels data channels after n_dim grid channels)."""

    def __init__(self, in_channels: int = 30, out_channels: int = 1, out_timesteps: int = 1,
                 width: int = 32, n_dim: int = 2, act: str = "gelu", n_cls: int = 1,
                 in_timesteps: int = 1, img_size: int = 64,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = "cuda", seed: int = 0):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        f = width
        self.n_dim = n_dim
        self.n_cls = n_cls
        self.img_size = img_size
        self.in_channels = in_channels
        self.in_timesteps = in_timesteps
        self.out_channels = out_channels
        self.out_timesteps = out_timesteps
        self.dtype = dtype

        def block(c_in, feats, name):
            return DoubleConv(c_in, feats, name, n_dim, act, dtype, g)

        c = n_dim + in_timesteps * in_channels
        for i, feats in enumerate((f, 2 * f, 4 * f, 8 * f), start=1):
            setattr(self, f"encoder{i}", block(c, feats, f"enc{i}"))
            c = feats
        self.bottleneck = block(8 * f, 16 * f, "bottleneck")
        for i, feats in ((4, 8 * f), (3, 4 * f), (2, 2 * f), (1, f)):
            setattr(self, f"upconv{i}", ConvNd(2 * feats, feats, 2, n_dim, dtype, g,
                                               transposed=True))
            setattr(self, f"decoder{i}", block(2 * feats, feats, f"dec{i}"))
        self.conv = ConvNd(f, out_timesteps * out_channels, 1, n_dim, dtype, g)
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n_dim = self.n_dim
        B, *spatial, T, C = x.shape
        x = x.reshape(B, *spatial, T * C)
        shape = (B, *spatial, 1)
        grids = [axis_grid(n, ax + 1, shape, x.dtype, x.device) for ax, n in enumerate(spatial)]
        x = torch.cat(grids + [x], dim=-1).movedim(-1, 1)        # (B, C', spatial...)
        pad = []
        for n in reversed(spatial):                              # F.pad: last axis first
            pad += [0, math.ceil(n / 16) * 16 - n]
        x = F.pad(x, pad)

        pool = getattr(F, f"max_pool{n_dim}d")
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(pool(enc1, 2))
        enc3 = self.encoder3(pool(enc2, 2))
        enc4 = self.encoder4(pool(enc3, 2))
        d = self.bottleneck(pool(enc4, 2))
        for i, skip in ((4, enc4), (3, enc3), (2, enc2), (1, enc1)):
            d = getattr(self, f"upconv{i}")(d)
            d = getattr(self, f"decoder{i}")(torch.cat([d, skip], dim=1))
        d = d[(slice(None), slice(None)) + tuple(slice(0, n) for n in spatial)]
        out = self.conv(d).movedim(1, -1)
        out = out.reshape(B, *spatial, self.out_timesteps, self.out_channels)
        return out.float(), out.new_zeros((B, self.n_cls), dtype=torch.float32)

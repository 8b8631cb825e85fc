"""DPOTNet3D, the 3D Denoising Operator Transformer, in PyTorch (port of
dpot_tpu/models/dpot3d.py, the reference's models/dpot3d.py).

Model I/O is channels-last: (B, X, Y, Z, T, C) in, the prediction
(B, X, Y, Z, T_out, C_out) out and nothing else (the cls_head exists as a
parameter, for checkpoint parity, but is not an output, as in the
reference); the trunk runs on (B, h, w, l, D). Parameter names and shapes
are those of the reference torch state dict, the layout that the JAX
package's `dpot3d_params_from_torch` reads: Conv3d patch and 1x1x1 MLP
weights, a ConvTranspose3d out_layer.0, pos_embed (1, D, h, w, l).
Convolutions are computed as matrix products, as in 2D; the dense layers,
GroupNorm, time aggregator and activations are the 2D model's.

The AFNO3D mixer is ops/spectral.py `afno_filter_3d` (a float32 rfftn /
irfftn, cuFFT on the card, around the mode MLP in the compute type): there
is no TPU kernel for it in the JAX package, whose mixer is XLA code.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dpot_tpu_torch.models.dpot import Activation, Dense, GroupNorm, TimeAggregator
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.cuda.graphs import capturing
from dpot_tpu_torch.ops.initializers import scaled_uniform, torch_uniform, trunc_normal
from dpot_tpu_torch.ops.norms import instance_stats
from dpot_tpu_torch.ops.spectral import afno_filter_3d
from dpot_tpu_torch.utils.device import resolve_device


class AFNO3D(nn.Module):
    """3D adaptive FNO mixer; w1/b1/w2/b2 in the reference layout. Its mode
    MLP applies GELU whatever `act` says: the reference hardcodes F.gelu
    there (models/dpot3d.py:63-74), unlike 2D, and the JAX package keeps
    that."""

    def __init__(self, width: int, num_blocks: int, modes: int, temporal_modes: int,
                 generator: torch.Generator):
        super().__init__()
        if width % num_blocks:
            raise ValueError(f"width {width} not divisible by {num_blocks} blocks")
        nb, bs = num_blocks, width // num_blocks
        self.modes = modes
        self.temporal_modes = temporal_modes
        scale = 1.0 / (bs * bs)
        self.w1 = nn.Parameter(scaled_uniform((2, nb, bs, bs), scale, generator))
        self.b1 = nn.Parameter(scaled_uniform((2, nb, bs), scale, generator))
        self.w2 = nn.Parameter(scaled_uniform((2, nb, bs, bs), scale, generator))
        self.b2 = nn.Parameter(scaled_uniform((2, nb, bs), scale, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, X, Y, Z, C) of the compute dtype, which is the mode MLP's."""
        return afno_filter_3d(x, self.w1, self.b1, self.w2, self.b2, self.modes,
                              self.temporal_modes, get_activation("gelu"), x.dtype)


class Block3D(nn.Module):
    """GroupNorm(8) -> AFNO3D -> GroupNorm(8) -> pointwise MLP -> residual."""

    def __init__(self, width: int, num_blocks: int, modes: int, temporal_modes: int,
                 mlp_ratio: float, act: str, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.norm1 = GroupNorm(8, width)
        self.filter = AFNO3D(width, num_blocks, modes, temporal_modes, generator)
        self.norm2 = GroupNorm(8, width)
        self.mlp = nn.ModuleList([
            Dense(width, hidden, generator, conv=True, dtype=dtype, spatial=3),
            Activation(act),
            Dense(hidden, width, generator, conv=True, dtype=dtype, spatial=3),
        ])

    def forward(self, x):
        residual = x
        x = self.norm2(self.filter(self.norm1(x)))
        for layer in self.mlp:
            x = layer(x)
        return x + residual


@lru_cache(maxsize=None)
def grid_patches_3d(H: int, W: int, L: int, T: int, p: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Patchified (x, y, z, t) coordinate channels (the reference's
    get_grid_4d) at latent resolution: (h, w, l, T, p^3 * 4), flattened in
    PatchConv3D's (a, b, c, channel) order. Cached and made as the 2D
    grid_patches are (models/dpot.py): outside inference mode, never
    evicted, never during a CUDA graph's capture."""
    if torch.device(device).type == "cuda" and capturing():
        raise RuntimeError(
            f"the grid channels of a {H}x{W}x{L} input (T {T}, patch {p}, {dtype}) are not "
            "cached on the card: a CUDA graph cannot upload them during its capture; "
            "run the function once eagerly first")
    h, w, l = H // p, W // p, L // p
    with torch.inference_mode(False):
        gx = torch.linspace(0, 1, H).reshape(h, p)
        gy = torch.linspace(0, 1, W).reshape(w, p)
        gz = torch.linspace(0, 1, L).reshape(l, p)
        gt = torch.linspace(0, 1, T)
        shape = (h, w, l, T, p, p, p)
        g = torch.stack([
            gx[:, None, None, None, :, None, None].expand(shape),
            gy[None, :, None, None, None, :, None].expand(shape),
            gz[None, None, :, None, None, None, :].expand(shape),
            gt[None, None, None, :, None, None, None].expand(shape),
        ], dim=-1)
        return g.reshape(h, w, l, T, p ** 3 * 4).to(device=device, dtype=dtype)


class PatchConv3D(nn.Module):
    """Conv3d(k=p, s=p) over C data + 4 grid channels, as space-to-depth and
    a matmul on (B, X, Y, Z, T, C); the grid's batch-independent part is one
    matmul at latent resolution."""

    def __init__(self, in_channels: int, features: int, p: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        fan_in = (in_channels + 4) * p ** 3
        self.p = p
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch_uniform((features, in_channels + 4, p, p, p), fan_in, generator))
        self.bias = nn.Parameter(torch_uniform((features,), fan_in, generator))

    def forward(self, x):
        p, dt = self.p, self.dtype
        B, H, W, L, T, C = x.shape
        h, w, l = H // p, W // p, L // p
        E = self.weight.shape[0]
        # (E, C+4, a, b, c) -> rows in (a, b, c, channel) order
        k = self.weight.permute(2, 3, 4, 1, 0)
        kx = k[..., :C, :].reshape(p ** 3 * C, E).to(dt)
        kg = k[..., C:, :].reshape(p ** 3 * 4, E).to(dt)
        x = x.to(dt).reshape(B, h, p, w, p, l, p, T, C).permute(0, 1, 3, 5, 7, 2, 4, 6, 8)
        y = x.reshape(B, h, w, l, T, p ** 3 * C) @ kx
        y = y + grid_patches_3d(H, W, L, T, p, dt, x.device) @ kg
        return y + self.bias.to(dt)


class UnpatchConv3D(nn.Module):
    """ConvTranspose3d(k=p, s=p) as a matmul and depth-to-space on
    (B, h, w, l, D); torch's fan-in of this layer is out_channels * p^3, for
    weight and bias alike."""

    def __init__(self, in_channels: int, features: int, p: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        fan_in = features * p ** 3
        self.p = p
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch_uniform((in_channels, features, p, p, p), fan_in, generator))
        self.bias = nn.Parameter(torch_uniform((features,), fan_in, generator))

    def forward(self, x):
        p, dt = self.p, self.dtype
        B, h, w, l, D = x.shape
        O = self.weight.shape[1]
        k = self.weight.permute(0, 2, 3, 4, 1).reshape(D, p ** 3 * O).to(dt)
        y = (x.to(dt) @ k).reshape(B, h, w, l, p, p, p, O).permute(0, 1, 4, 2, 5, 3, 6, 7)
        return y.reshape(B, h * p, w * p, l * p, O) + self.bias.to(dt)


class PatchEmbed3D(nn.Module):
    """proj.0 patch conv (grid folded in) -> act -> proj.2 1x1x1 conv."""

    def __init__(self, in_channels: int, p: int, embed_dim: int, out_dim: int,
                 act: str, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.proj = nn.ModuleList([
            PatchConv3D(in_channels, embed_dim, p, dtype, generator),
            Activation(act),
            Dense(embed_dim, out_dim, generator, conv=True, dtype=dtype, spatial=3),
        ])

    def forward(self, x):
        for layer in self.proj:
            x = layer(x)
        return x


class DPOTNet3D(nn.Module):
    """Full 3D DPOT model, pred-only. Weights are drawn on the CPU from a
    torch.Generator seeded with `seed` and moved to `device` (the card
    unless the caller asks for the CPU); `remat` runs each trunk block under
    torch.utils.checkpoint, the state dict's keys unchanged."""

    def __init__(
        self,
        img_size: int = 64,
        patch_size: int = 8,
        in_channels: int = 1,
        out_channels: int = 4,
        in_timesteps: int = 1,
        out_timesteps: int = 1,
        n_blocks: int = 4,
        embed_dim: int = 768,
        out_layer_dim: int = 32,
        depth: int = 12,
        modes: int = 32,
        temporal_modes: int = 8,
        mlp_ratio: float = 1.0,
        n_cls: int = 1,
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
        self.img_size = img_size
        self.patch_size = p
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.in_timesteps = in_timesteps
        self.out_timesteps = out_timesteps
        self.normalize = normalize
        self.dtype = dtype
        self.remat = remat
        h = img_size // p

        if normalize:
            self.scale_feats_mu = Dense(2 * in_channels, embed_dim, g)
            self.scale_feats_sigma = Dense(2 * in_channels, embed_dim, g)
        # the reference's embed width out_channels * p + 4 (a quirk kept)
        self.patch_embed = PatchEmbed3D(
            in_channels, p, out_channels * p + 4, embed_dim, act, dtype, g)
        self.pos_embed = nn.Parameter(trunc_normal((1, embed_dim, h, h, h), g))
        self.time_agg_layer = TimeAggregator(in_timesteps, embed_dim, time_agg, dtype, g)
        self.blocks = nn.ModuleList([
            Block3D(embed_dim, n_blocks, modes, temporal_modes, mlp_ratio, act, dtype, g)
            for _ in range(depth)
        ])
        self.cls_head = nn.ModuleList([
            Dense(embed_dim, embed_dim, g), Activation(act),
            Dense(embed_dim, embed_dim, g), Activation(act),
            Dense(embed_dim, n_cls, g),
        ])
        self.out_layer = nn.ModuleList([
            UnpatchConv3D(embed_dim, out_layer_dim, p, dtype, g), Activation(act),
            Dense(out_layer_dim, out_layer_dim, g, conv=True, dtype=dtype, spatial=3),
            Activation(act),
            Dense(out_layer_dim, out_channels * out_timesteps, g, conv=True, dtype=dtype,
                  spatial=3),
        ])
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, L, T, C = x.shape
        if not H == W == L == self.img_size:
            raise ValueError(f"input {H}x{W}x{L} != model img_size {self.img_size}^3")
        dt = self.dtype

        if self.normalize:
            mu, sigma = instance_stats(x, dims=(1, 2, 3, 4))
            x = (x - mu) / sigma
            stats = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0, 0, :]
            scale_mu = self.scale_feats_mu(stats)[:, None, None, None, :]
            scale_sigma = self.scale_feats_sigma(stats)[:, None, None, None, :]

        x = self.patch_embed(x)                                  # (B, h, w, l, T, D)
        x = x + self.pos_embed.permute(0, 2, 3, 4, 1)[:, :, :, :, None, :]
        x = self.time_agg_layer(x)                               # (B, h, w, l, D)
        if self.normalize:
            x = scale_sigma.to(dt) * x + scale_mu.to(dt)         # AdaIN

        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                 if remat else blk(x))

        for layer in self.out_layer:
            x = layer(x)
        x = x.reshape(B, H, W, L, self.out_timesteps, self.out_channels)
        if self.normalize:
            x = x * sigma + mu
        return x.float()

"""FNO baselines, 2D and 3D, channels-last (port of dpot_tpu/models/fno.py).

The spectral convolutions keep the corners of the real FFT's half spectrum
(+-modes1 x modes2 in 2D; +-modes1 x +-modes2 x modes3 in 3D) and contract
them with per-mode complex weights, in float32 whatever the compute type
(cuFFT takes no bfloat16), with FNO's "backward" FFT norm (AFNO's is
"ortho"). The weights are real-stacked, (2, in, out, modes...), in 2D as in
the reference and in 3D as in the JAX package, whose reference stores
torch.cfloat there: a reference file's complex weights are split into that
layout when they load (train/interop.py `params_from_any`), and the two
halves train as independent reals, as JAX trains them.

Parameter names are those of the reference state dict (the layout of
dpot_tpu/train/interop.py `fno2d_params_from_torch` /
`fno3d_params_from_torch`). FNO2d returns (pred, cls_logits) at the
latent's resolution (a patch above 1 is not resized back, as in JAX);
FNO3d returns the prediction only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dpot_tpu_torch.models.dpot import Activation, Dense, GroupNorm, PatchEmbed
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.initializers import scaled_uniform
from dpot_tpu_torch.ops.norms import instance_stats
from dpot_tpu_torch.ops.spectral import irfftn_pair, rfftn_pair
from dpot_tpu_torch.utils.device import resolve_device


def _cmul(xr, xi, wr, wi, eq):
    """Complex contraction on (re, im) pairs."""
    return (torch.einsum(eq, xr, wr) - torch.einsum(eq, xi, wi),
            torch.einsum(eq, xr, wi) + torch.einsum(eq, xi, wr))


class SpectralConv(nn.Module):
    """The spectral convolution over the spatial axes of (B, spatial..., C):
    2D keeps the corners [:m1] and [-m1:] of axis 1 (weights1, weights2), 3D
    the four corners of axes 1 and 2 (weights1..4); the last axis keeps its
    first modes of the half spectrum. Later corners overwrite earlier ones
    where they overlap, as in JAX."""

    def __init__(self, channels: int, modes: tuple[int, ...], generator: torch.Generator):
        super().__init__()
        self.modes = modes
        self.n_weights = 2 if len(modes) == 2 else 4
        scale = 1.0 / (channels * channels)
        for k in range(1, self.n_weights + 1):
            self.register_parameter(f"weights{k}", nn.Parameter(
                scaled_uniform((2, channels, channels, *modes), scale, generator)))

    def corners(self, grid: tuple[int, ...]) -> list[tuple[slice, ...]]:
        m1, m2 = self.modes[:2]
        H = grid[0]
        if len(self.modes) == 2:
            return [(slice(0, m1), slice(0, m2)), (slice(H - m1, H), slice(0, m2))]
        W, m3 = grid[1], self.modes[2]
        return [(sx, sy, slice(0, m3))
                for sy in (slice(0, m2), slice(W - m2, W))
                for sx in (slice(0, m1), slice(H - m1, H))]

    def forward(self, x):
        B, *grid, C = x.shape
        nd = len(grid)
        dims = tuple(range(1, nd + 1))
        fr, fi = rfftn_pair(x.float(), dims, norm="backward")
        letters = "xyz"[:nd]
        eq = f"b{letters}i,io{letters}->b{letters}o"
        zr = fr.new_zeros(fr.shape)
        zi = fi.new_zeros(fi.shape)
        ws = [getattr(self, f"weights{k}") for k in range(1, self.n_weights + 1)]
        for w, corner in zip(ws, self.corners(tuple(grid))):
            idx = (slice(None), *corner)
            cr, ci = _cmul(fr[idx], fi[idx], w[0].float(), w[1].float(), eq)
            zr[idx] = cr
            zi[idx] = ci
        return irfftn_pair(zr, zi, tuple(grid), dims, norm="backward").to(x.dtype)


def axis_grid(n: int, axis: int, shape: tuple[int, ...], dtype, device) -> torch.Tensor:
    """linspace(0, 1, n) along `axis`, broadcast to `shape` (a coordinate
    grid channel, made on `device`: no host-to-device copy)."""
    view = [1] * len(shape)
    view[axis] = n
    return torch.linspace(0, 1, n, device=device).to(dtype).reshape(view).expand(shape)


class _FNOTrunk(nn.Module):
    """The n_layers of act(spectral(x) + w(x)) [-> GroupNorm(4)]."""

    def __init__(self, width: int, modes: tuple[int, ...], n_layers: int, use_ln: bool,
                 act: str, dtype: torch.dtype, generator: torch.Generator, spatial: int):
        super().__init__()
        g = generator
        self.act = get_activation(act)
        self.spectral_convs = nn.ModuleList(
            [SpectralConv(width, modes, g) for _ in range(n_layers)])
        self.convs = nn.ModuleList([Dense(width, width, g, conv=True, dtype=dtype,
                                          spatial=spatial) for _ in range(n_layers)])
        self.ln_layers = (nn.ModuleList([GroupNorm(4, width) for _ in range(n_layers)])
                          if use_ln else None)

    def trunk(self, x):
        for i, (spec, w) in enumerate(zip(self.spectral_convs, self.convs)):
            x = self.act(spec(x) + w(x))
            if self.ln_layers is not None:
                x = self.ln_layers[i](x)
        return x


class FNO2d(_FNOTrunk):
    """(B, X, Y, T, C) -> ((B, X/p, Y/p, T_out, C), cls_logits)."""

    def __init__(self, modes1: int, modes2: int, width: int, img_size: int = 64,
                 n_channels: int = 1, in_timesteps: int = 10, out_timesteps: int = 1,
                 n_layers: int = 4, patch_size: int = 1, use_ln: bool = False,
                 normalize: bool = False, n_cls: int = 0, act: str = "gelu",
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = "cuda", seed: int = 0):
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        super().__init__(width, (modes1, modes2), n_layers, use_ln, act, dtype, g, 2)
        p, T, C = patch_size, in_timesteps, n_channels
        self.img_size = img_size
        self.in_channels = n_channels
        self.in_timesteps = in_timesteps
        self.out_timesteps = out_timesteps
        self.normalize = normalize
        self.dtype = dtype
        if normalize:
            self.scale_feats = Dense(2 * C, width, g)
        # the reference's width of the patch conv: T * C * p + 2, GELU fixed
        self.patch_embed = PatchEmbed(T * C + 2, p, T * C * p + 2, width, "gelu", dtype, g,
                                      grid=False)
        self.cls_head = nn.ModuleList([
            Dense(width, width, g), Activation(act), Dense(width, width, g),
            Activation(act), Dense(width, n_cls, g),
        ])
        self.fc1 = Dense(width, width, g, dtype=dtype)
        self.fc2 = Dense(width, C * out_timesteps, g, dtype=dtype)
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, H, W, T, C = x.shape
        if self.normalize:
            mu, sigma = instance_stats(x, dims=(1, 2, 3))
            x = (x - mu) / sigma
            stats = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0, :]
            scale_feats = self.scale_feats(stats)[:, None, None, :]
        shape = (B, H, W, 1)
        x = torch.cat([x.reshape(B, H, W, T * C),
                       axis_grid(H, 1, shape, x.dtype, x.device),
                       axis_grid(W, 2, shape, x.dtype, x.device)], dim=-1)
        x = self.patch_embed(x)
        if self.normalize:
            x = x + scale_feats
        x = self.trunk(x)

        ct = x.mean(dim=(1, 2)).float()
        for layer in self.cls_head:
            ct = layer(ct)

        x = self.fc2(self.act(self.fc1(x)))
        x = x.reshape(B, x.shape[1], x.shape[2], self.out_timesteps, C)
        if self.normalize:
            x = x * sigma + mu
        return x.float(), ct.float()


class FNO3d(_FNOTrunk):
    """(B, X, Y, Z, T, C) -> (B, X, Y, Z, T_out, C), the prediction only.
    GELU throughout, whatever `act` says, as the JAX registry builds it."""

    def __init__(self, modes1: int, modes2: int, modes3: int, width: int,
                 img_size: int = 64, n_channels: int = 1, in_timesteps: int = 10,
                 out_timesteps: int = 1, n_layers: int = 4, use_ln: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = "cuda", seed: int = 0):
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        super().__init__(width, (modes1, modes2, modes3), n_layers, use_ln, "gelu", dtype,
                         g, 3)
        T, C = in_timesteps, n_channels
        self.img_size = img_size
        self.in_channels = n_channels
        self.in_timesteps = in_timesteps
        self.out_timesteps = out_timesteps
        self.dtype = dtype
        self.fc0 = Dense(T * C + 3, width, g, dtype=dtype)
        self.fc1 = Dense(width, width, g, dtype=dtype)
        self.fc2 = Dense(width, C * out_timesteps, g, dtype=dtype)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, L, T, C = x.shape
        shape = (B, H, W, L, 1)
        x = torch.cat([x.reshape(B, H, W, L, T * C)]
                      + [axis_grid(n, a, shape, x.dtype, x.device)
                         for a, n in ((1, H), (2, W), (3, L))], dim=-1)
        x = self.trunk(self.fc0(x))
        x = self.fc2(self.act(self.fc1(x)))
        return x.reshape(B, H, W, L, self.out_timesteps, C).float()

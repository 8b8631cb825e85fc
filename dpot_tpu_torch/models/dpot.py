"""DPOTNet (2D), the Denoising Operator Transformer, in PyTorch (port of
dpot_tpu/models/dpot.py).

Model I/O is channels-last, (B, X, Y, T, C) in and ((B, X, Y, T_out, C_out),
cls_logits (B, n_cls)) out, as in the JAX package; the trunk runs on
(B, h, w, D). Parameter names and shapes are those of the reference torch
state dict (the layout dpot_tpu/train/interop.py reads), so a reference
.pth loads with `load_state_dict(strict=True)`. Convolutions are computed as
matrix products. Parameters are float32; `dtype` is the compute dtype
(float32 or bfloat16). The norm1 GroupNorm and the AFNO mixer of every
trunk block run as one fused kernel (ops/cuda/afno_fused.py), or for a
latent above 4096 px as the separable route (ops/spectral.py). `remat`
recomputes each trunk block's activations in the backward instead of
keeping them (torch.utils.checkpoint, the counterpart of JAX's
`nn.remat(Block)`). The parameters may also be a bfloat16 working copy
(train/state.py): every op then takes them as they are, or upcasts them
where it computes in float32.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno
from dpot_tpu_torch.ops.cuda.graphs import capturing
from dpot_tpu_torch.ops.initializers import (
    gamma_geometric,
    scaled_normal,
    scaled_uniform,
    torch_uniform,
    trunc_normal,
)
from dpot_tpu_torch.ops.norms import group_norm, instance_stats
from dpot_tpu_torch.ops.spectral import (
    COMBINED_MAX_PIXELS,
    combined_spectral_ops,
    kept_modes,
    separable_gn_afno,
)
from dpot_tpu_torch.utils.device import resolve_device


class Activation(nn.Module):
    """A named activation as a module (it holds no parameters, so the
    Sequential-style indices of the reference state dict line up)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_activation(name)

    def forward(self, x):
        return self.fn(x)


class Dense(nn.Module):
    """Linear layer on the channel axis. conv=True keeps the weight in the
    (O, I, 1, ..., 1) shape of a reference 1x1 convolution over `spatial`
    axes (Conv2d by default, Conv3d with 3); dtype is the compute dtype
    (None: float32, the promotion of a float32 weight)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, conv: bool = False,
                 dtype: torch.dtype | None = None, spatial: int = 2):
        super().__init__()
        shape = (out_features, in_features) + ((1,) * spatial if conv else ())
        self.weight = nn.Parameter(torch_uniform(shape, in_features, generator))
        self.bias = nn.Parameter(torch_uniform((out_features,), in_features, generator))
        self.dtype = dtype or torch.float32

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(x.to(self.dtype), w.to(self.dtype), self.bias.to(self.dtype))


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm-compatible group norm on channels-last input."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class AFNO2D(nn.Module):
    """Adaptive FNO spectral mixer; w1/b1/w2/b2 in the reference layout,
    `act` the mode MLP's activation. Applied together with the block's
    norm1, routed by the latent's size as the JAX package routes it: the
    fused kernel up to COMBINED_MAX_PIXELS, the separable route
    (GroupNorm, then the FFT branch of afno_filter_2d) above."""

    def __init__(self, width: int, num_blocks: int, modes: int,
                 generator: torch.Generator, act: str = "gelu"):
        super().__init__()
        if width % num_blocks:
            raise ValueError(f"width {width} not divisible by {num_blocks} blocks")
        nb, bs = num_blocks, width // num_blocks
        self.modes = modes
        self.act = act
        scale = 1.0 / (bs * bs)
        self.w1 = nn.Parameter(scaled_uniform((2, nb, bs, bs), scale, generator))
        self.b1 = nn.Parameter(scaled_uniform((2, nb, bs), scale, generator))
        self.w2 = nn.Parameter(scaled_uniform((2, nb, bs, bs), scale, generator))
        self.b2 = nn.Parameter(scaled_uniform((2, nb, bs), scale, generator))

    def forward(self, x: torch.Tensor, norm: GroupNorm) -> torch.Tensor:
        """norm(x) mixed, plus the normed x (the AFNO-internal residual).
        x: (B, H, W, C) of the compute dtype, which is the kernel's operand
        type. The mode MLP applies `act` as ops/activations defines it for
        that dtype: gelu is the tanh form under bf16 and erf under f32."""
        B, H, W, C = x.shape
        if H * W > COMBINED_MAX_PIXELS:
            return separable_gn_afno(x, norm.weight, norm.bias, norm.num_groups, self.w1,
                                     self.b1, self.w2, self.b2, self.modes,
                                     get_activation(self.act))
        kh, kw = kept_modes(H, W, self.modes)
        A, Ainv = combined_spectral_ops(H, W, kh, kw, x.dtype, x.device)
        out = fused_gn_afno(
            x.reshape(B, H * W, C).contiguous(), norm.weight, norm.bias, A, Ainv,
            self.w1, self.b1, self.w2, self.b2, kh * kw, norm.num_groups,
            approximate=x.dtype == torch.bfloat16, act=self.act,
        )
        return out.reshape(B, H, W, C)


class Block(nn.Module):
    """GroupNorm(8) -> AFNO -> GroupNorm(8) -> pointwise MLP -> residual."""

    def __init__(self, width: int, num_blocks: int, modes: int, mlp_ratio: float,
                 act: str, dtype: torch.dtype, generator: torch.Generator,
                 norm_groups: int = 8):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.norm1 = GroupNorm(norm_groups, width)
        self.filter = AFNO2D(width, num_blocks, modes, generator, act)
        self.norm2 = GroupNorm(norm_groups, width)
        self.mlp = nn.ModuleList([
            Dense(width, hidden, generator, conv=True, dtype=dtype),
            Activation(act),
            Dense(hidden, width, generator, conv=True, dtype=dtype),
        ])

    def forward(self, x):
        residual = x
        x = self.norm2(self.filter(x, self.norm1))
        for layer in self.mlp:
            x = layer(x)
        return x + residual


@lru_cache(maxsize=None)
def grid_patches(H: int, W: int, T: int, p: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Patchified (x, y, t) coordinate channels at latent resolution:
    (h, w, T, p*p*3), flattened in the (a, b, c) order of PatchConv. Made
    outside inference mode, as the cached DFT operators are, so that a
    training forward may use what an inference forward cached; never
    evicted and never made during a CUDA graph's capture, as they are
    (ops/spectral.py)."""
    if torch.device(device).type == "cuda" and capturing():
        raise RuntimeError(
            f"the grid channels of a {H}x{W} input (T {T}, patch {p}, {dtype}) are not "
            "cached on the card: a CUDA graph cannot upload them during its capture; "
            "run the function once eagerly first")
    h, w = H // p, W // p
    with torch.inference_mode(False):
        gx = torch.linspace(0, 1, H).reshape(h, p)
        gy = torch.linspace(0, 1, W).reshape(w, p)
        gt = torch.linspace(0, 1, T)
        shape = (h, w, T, p, p)
        g = torch.stack([
            gx[:, None, None, :, None].expand(shape),
            gy[None, :, None, None, :].expand(shape),
            gt[None, None, :, None, None].expand(shape),
        ], dim=-1)
        return g.reshape(h, w, T, p * p * 3).to(device=device, dtype=dtype)


class PatchConv(nn.Module):
    """Conv2d(k=p, s=p) over C data + 3 grid channels, as space-to-depth and
    a matmul on (B, H, W, T, C). The grid channels are batch-independent, so
    their contribution is one matmul at latent resolution. grid=False is
    the plain form on (B, H, W, C), whose C channels are all the input's
    (FNO2d passes its two grid channels among them)."""

    def __init__(self, in_channels: int, features: int, p: int,
                 dtype: torch.dtype, generator: torch.Generator, grid: bool = True):
        super().__init__()
        fan_in = (in_channels + 3 * grid) * p * p
        self.p = p
        self.dtype = dtype
        self.grid = grid
        self.weight = nn.Parameter(
            torch_uniform((features, in_channels + 3 * grid, p, p), fan_in, generator)
        )
        self.bias = nn.Parameter(torch_uniform((features,), fan_in, generator))

    def forward(self, x):
        p, dt = self.p, self.dtype
        E = self.weight.shape[0]
        # (E, C(+3), a, b) -> rows in (a, b, c) order
        k = self.weight.permute(2, 3, 1, 0)
        if not self.grid:
            B, H, W, C = x.shape
            h, w = H // p, W // p
            x = x.to(dt).reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
            y = x.reshape(B, h, w, p * p * C) @ k.reshape(p * p * C, E).to(dt)
            return y + self.bias.to(dt)
        B, H, W, T, C = x.shape
        h, w = H // p, W // p
        kx = k[:, :, :C].reshape(p * p * C, E).to(dt)
        kg = k[:, :, C:].reshape(p * p * 3, E).to(dt)
        x = x.to(dt).reshape(B, h, p, w, p, T, C).permute(0, 1, 3, 5, 2, 4, 6)
        y = x.reshape(B, h, w, T, p * p * C) @ kx
        y = y + grid_patches(H, W, T, p, dt, x.device) @ kg
        return y + self.bias.to(dt)


class UnpatchConv(nn.Module):
    """ConvTranspose2d(k=p, s=p) as a matmul and depth-to-space on
    (B, h, w, D). torch computes this layer's fan-in from weight.size(1),
    i.e. out_channels * p * p, for both weight and bias."""

    def __init__(self, in_channels: int, features: int, p: int,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        fan_in = features * p * p
        self.p = p
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch_uniform((in_channels, features, p, p), fan_in, generator)
        )
        self.bias = nn.Parameter(torch_uniform((features,), fan_in, generator))

    def forward(self, x):
        p, dt = self.p, self.dtype
        B, h, w, D = x.shape
        O = self.weight.shape[1]
        k = self.weight.permute(0, 2, 3, 1).reshape(D, p * p * O).to(dt)
        y = (x.to(dt) @ k).reshape(B, h, w, p, p, O).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, h * p, w * p, O) + self.bias.to(dt)


class PatchEmbed(nn.Module):
    """proj.0 patch conv (grid folded in unless grid=False) -> act -> proj.2
    1x1 conv."""

    def __init__(self, in_channels: int, p: int, embed_dim: int, out_dim: int,
                 act: str, dtype: torch.dtype, generator: torch.Generator,
                 grid: bool = True):
        super().__init__()
        self.proj = nn.ModuleList([
            PatchConv(in_channels, embed_dim, p, dtype, generator, grid),
            Activation(act),
            Dense(embed_dim, out_dim, generator, conv=True, dtype=dtype),
        ])

    def forward(self, x):
        for layer in self.proj:
            x = layer(x)
        return x


class TimeAggregator(nn.Module):
    """Collapse T input frames into one latent frame ('mlp' | 'exp_mlp')."""

    def __init__(self, n_timesteps: int, channels: int, time_agg: str,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        if time_agg not in ("mlp", "exp_mlp"):
            raise ValueError(f"unknown time_agg {time_agg!r}")
        T, C = n_timesteps, channels
        self.time_agg = time_agg
        self.dtype = dtype
        self.w = nn.Parameter(scaled_normal((T, C, C), 1.0 / (T * C**0.5), generator))
        if time_agg == "exp_mlp":
            self.gamma = nn.Parameter(gamma_geometric(C))

    def forward(self, x):  # (B, h, w, T, C)
        T, C = self.w.shape[0], self.w.shape[-1]
        x = x.to(self.dtype)
        if self.time_agg == "exp_mlp":
            t = torch.linspace(0.0, 1.0, x.shape[-2], device=x.device)[:, None]
            x = x * torch.cos(t @ self.gamma.float()).to(self.dtype)
        return x.reshape(*x.shape[:-2], T * C) @ self.w.reshape(T * C, C).to(self.dtype)


class DPOTNet(nn.Module):
    """Full 2D DPOT model. Parameters are drawn on the CPU from a
    torch.Generator seeded with `seed` (the same weights on every device),
    then moved to `device`: the card unless the caller asks for the CPU
    (utils/device.py `resolve_device`, which raises without CUDA). With `remat`, a forward under grad mode keeps
    only each trunk block's input and runs the block again in the backward;
    the blocks stay where they are, so the state dict's keys do not change."""

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
        self.patch_embed = PatchEmbed(
            in_channels, p, out_channels * p + 3, embed_dim, act, dtype, g
        )
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
            UnpatchConv(embed_dim, out_layer_dim, p, dtype, g), Activation(act),
            Dense(out_layer_dim, out_layer_dim, g, conv=True, dtype=dtype),
            Activation(act),
            Dense(out_layer_dim, out_channels * out_timesteps, g, conv=True, dtype=dtype),
        ])
        self.to(device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, H, W, T, C = x.shape
        if H != self.img_size or W != self.img_size:
            raise ValueError(f"input {H}x{W} != model img_size {self.img_size}")
        dt = self.dtype

        if self.normalize:
            # reversible instance norm + AdaIN scales from the statistics
            mu, sigma = instance_stats(x, dims=(1, 2, 3))
            x = (x - mu) / sigma
            stats = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0, :]
            scale_mu = self.scale_feats_mu(stats)[:, None, None, :]
            scale_sigma = self.scale_feats_sigma(stats)[:, None, None, :]

        x = self.patch_embed(x)                                  # (B, h, w, T, D)
        x = x + self.pos_embed.permute(0, 2, 3, 1)[:, :, :, None, :]
        x = self.time_agg_layer(x)                               # (B, h, w, D)
        if self.normalize:
            x = scale_sigma.to(dt) * x + scale_mu.to(dt)         # AdaIN

        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            # a block draws no random numbers, so its recomputation needs no
            # saved RNG state
            x = (checkpoint(blk, x, use_reentrant=False, preserve_rng_state=False)
                 if remat else blk(x))

        ct = x.mean(dim=(1, 2)).float()                          # classifier head
        for layer in self.cls_head:
            ct = layer(ct)

        for layer in self.out_layer:
            x = layer(x)
        x = x.reshape(B, H, W, self.out_timesteps, self.out_channels)
        if self.normalize:
            x = x * sigma + mu
        return x.float(), ct.float()

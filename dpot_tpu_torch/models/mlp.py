"""Residual MLP and Fourier-feature MLP (port of dpot_tpu/models/mlp.py,
the reference's models/mlp.py).

Utility models: no registry entry builds them, as in the JAX package.
Parameter names are the reference's (`linear_pre`, `linears.{i}`,
`linear_post`; the layout of dpot_tpu/train/interop.py
`mlp_params_from_torch`). FourierMLP's Gaussian frequency matrix is drawn
from the model's seeded generator, as each reference module draws its own,
and kept as the buffer `B`.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dpot_tpu_torch.models.dpot import Dense
from dpot_tpu_torch.ops.activations import get_activation
from dpot_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    """linear_pre -> act, n_layers of act(linear(x)) (+ x with res),
    linear_post; float32."""

    def __init__(self, n_input: int, n_hidden: int, n_output: int, n_layers: int = 1,
                 act: str = "gelu", res: bool = True,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = "cuda", seed: int = 0):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.act = get_activation(act)
        self.res = res
        self.linear_pre = Dense(n_input, n_hidden, g)
        self.linears = nn.ModuleList([Dense(n_hidden, n_hidden, g) for _ in range(n_layers)])
        self.linear_post = Dense(n_hidden, n_output, g)
        if generator is None:
            self.to(resolve_device(device))

    def forward(self, x):
        x = self.act(self.linear_pre(x))
        for layer in self.linears:
            h = self.act(layer(x))
            x = h + x if self.res else h
        return self.linear_post(x)


class FourierMLP(nn.Module):
    """Random Gaussian ('gaussian') or log-spaced ('exp') frequency features
    of the coordinates, a 3-layer MLP on theta, and a residual-MLP trunk;
    fourier_dim 0 feeds (x, theta) to the trunk directly."""

    def __init__(self, space_dim: int = 2, theta_dim: int = 1, output_size: int = 3,
                 n_layers: int = 2, n_hidden: int = 64, act: str = "gelu",
                 fourier_dim: int = 0, feature_type: str = "gaussian", sigma: float = 1.0,
                 res: bool = True, device: str | torch.device | None = "cuda",
                 seed: int = 0):
        super().__init__()
        if feature_type not in ("gaussian", "exp"):
            raise ValueError(f"unknown feature_type {feature_type!r}")
        g = torch.Generator().manual_seed(seed)
        self.theta_dim = theta_dim
        self.fourier_dim = fourier_dim
        self.feature_type = feature_type
        n_in = space_dim + theta_dim
        if fourier_dim > 0:
            if feature_type == "gaussian":
                self.register_buffer(
                    "B", sigma * torch.randn((space_dim, fourier_dim), generator=g))
                n_feats = 2 * fourier_dim
            else:
                self.n_freqs = fourier_dim // space_dim
                n_feats = 2 * space_dim * self.n_freqs
            self.theta_mlp = MLP(theta_dim, fourier_dim, fourier_dim, n_layers=3, act=act,
                                 res=res, generator=g)
            n_in = n_feats + fourier_dim
        self.mlp = MLP(n_in, n_hidden, output_size, n_layers=n_layers, act=act, res=res,
                       generator=g)
        self.to(resolve_device(device))

    def forward(self, x, theta=None):
        if theta is None:
            theta = x.new_zeros((x.shape[0], self.theta_dim))
        if self.fourier_dim > 0:
            if self.feature_type == "gaussian":
                feats = 2 * math.pi * x @ self.B
            else:
                freqs = torch.logspace(math.log10(1 / 2048), math.log10(2048), self.n_freqs,
                                       device=x.device)
                feats = 2 * math.pi * torch.einsum("ij,k->ijk", x, freqs).reshape(
                    x.shape[0], -1)
            z = torch.cat([torch.sin(feats), torch.cos(feats), self.theta_mlp(theta)], dim=-1)
        else:
            z = torch.cat([x, theta], dim=-1)
        return self.mlp(z)

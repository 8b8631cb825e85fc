"""Reference-layout weights for the port (the port side of
dpot_tpu/train/interop.py).

The port's models keep the reference torch state dict's names and shapes,
so a reference `.pth` loads directly. `state_dict_from_jax` maps the JAX
package's params of any family (a pytree of numpy arrays) to that layout;
it is the exact inverse of the JAX package's `*_params_from_torch` for
DPOTNet, DPOTNet3D, CDPOTNet, FNO2d, FNO3d, UNet (whose `batch_stats` become
the BatchNorm buffers) and MLP. `params_from_any` reads the weights of a
reference `.pth` or of a port checkpoint for a model at hand: its position
embedding resized to the model's latent grid, and complex tensors (FNO3d's
torch.cfloat spectral weights) split into the real-stacked (2, ...) layout
that JAX keeps. `inflate_2d_to_3d` bootstraps a 3D model from a 2D one
(the reference's load_3d_components_from_2d).
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import numpy as np
import torch

from dpot_tpu_torch.data.resize import resize_linear_nd


def strip_module_prefix(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Strip the DDP 'module.' prefix per key (unprefixed keys unchanged)."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def _t(a) -> torch.Tensor:
    # a copy: the arrays JAX hands over are read-only
    return torch.from_numpy(np.array(a))


def _linear(d: Mapping, prefix: str, out: dict) -> None:
    """Dense kernel (I, O) -> Linear weight (O, I)."""
    out[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T)
    out[f"{prefix}.bias"] = _t(d["bias"])


def _conv1x1(d: Mapping, prefix: str, out: dict, nd: int = 2) -> None:
    """Dense kernel (I, O) -> 1x1 convolution weight (O, I, 1, ..., 1) over
    nd spatial axes."""
    k = np.asarray(d["kernel"]).T
    out[f"{prefix}.weight"] = _t(k.reshape(k.shape + (1,) * nd))
    out[f"{prefix}.bias"] = _t(d["bias"])


def _conv(d: Mapping, prefix: str, out: dict) -> None:
    """Conv kernel (k..., I, O) -> convolution weight (O, I, k...)."""
    k = np.asarray(d["kernel"])
    nd = k.ndim - 2
    out[f"{prefix}.weight"] = _t(np.transpose(k, (nd + 1, nd) + tuple(range(nd))))
    if "bias" in d:
        out[f"{prefix}.bias"] = _t(d["bias"])


def _conv_transpose(d: Mapping, prefix: str, out: dict) -> None:
    """flax ConvTranspose kernel (k..., I, O), spatially flipped against
    torch's -> ConvTranspose weight (I, O, k...)."""
    k = np.asarray(d["kernel"])
    nd = k.ndim - 2
    w = np.transpose(k, (nd, nd + 1) + tuple(range(nd)))
    out[f"{prefix}.weight"] = _t(np.flip(w, axis=tuple(range(2, 2 + nd))))
    out[f"{prefix}.bias"] = _t(d["bias"])


def _norm(d: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(d["scale"])
    out[f"{prefix}.bias"] = _t(d["bias"])


def _cls_head(p: Mapping, sd: dict) -> None:
    for j, idx in enumerate((0, 2, 4)):
        if f"cls_head_{j}" in p:
            _linear(p[f"cls_head_{j}"], f"cls_head.{idx}", sd)


def _trunk(p: Mapping, sd: dict, nd: int) -> None:
    """The AFNO trunk's blocks, time aggregator, AdaIN scales and cls head
    (DPOT 2D/3D and CDPOT)."""
    sd["pos_embed"] = _t(np.moveaxis(p["pos_embed"], -1, 1))  # channels-last -> (1, D, ...)
    sd["time_agg_layer.w"] = _t(p["time_agg"]["w"])
    if "gamma" in p["time_agg"]:
        sd["time_agg_layer.gamma"] = _t(p["time_agg"]["gamma"])
    for name in ("scale_feats_mu", "scale_feats_sigma"):
        if name in p:
            _linear(p[name], name, sd)
    i = 0
    while f"blocks_{i}" in p:
        b, pre = p[f"blocks_{i}"], f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            _norm(b[norm], f"{pre}.{norm}", sd)
        for k in ("w1", "b1", "w2", "b2"):
            sd[f"{pre}.filter.{k}"] = _t(b["filter"][k])
        _conv1x1(b["mlp_fc1"], f"{pre}.mlp.0", sd, nd)
        _conv1x1(b["mlp_fc2"], f"{pre}.mlp.2", sd, nd)
        i += 1
    _cls_head(p, sd)


def _dpot(p: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    pe = p["patch_embed"]
    nd = np.ndim(pe["proj1"]["kernel"]) - 2
    _conv(pe["proj1"], "patch_embed.proj.0", sd)
    _conv1x1(pe["proj2"], "patch_embed.proj.2", sd, nd)
    _trunk(p, sd, nd)
    # UnpatchConv kernel (p..., D, O) -> ConvTranspose weight (D, O, p...)
    sd["out_layer.0.weight"] = _t(np.transpose(p["out_deconv"]["kernel"],
                                               (nd, nd + 1) + tuple(range(nd))))
    sd["out_layer.0.bias"] = _t(p["out_deconv"]["bias"])
    _conv1x1(p["out_conv1"], "out_layer.2", sd, nd)
    _conv1x1(p["out_conv2"], "out_layer.4", sd, nd)
    return sd


def _cdpot(p: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    pe = p["patch_embed"]
    _conv(pe["proj1"], "patch_embed.proj.0", sd)
    # one module under two names in the reference (and in the port)
    sd["patch_embed.act_patching.bias"] = _t(pe["act_bias"])
    sd["patch_embed.proj.1.bias"] = _t(pe["act_bias"])
    _conv(pe["proj2"], "patch_embed.proj.2", sd)
    _trunk(p, sd, 2)
    _conv(p["out_cno"]["convolution"], "out_layer.0.convolution", sd)
    sd["out_layer.0.activation.bias"] = _t(p["out_cno"]["act_bias"])
    _conv(p["out_conv1"], "out_layer.1", sd)
    _conv(p["out_conv2"], "out_layer.3", sd)
    return sd


def _fno(p: Mapping) -> dict[str, torch.Tensor]:
    """FNO2d (a patch embed) or FNO3d (fc0)."""
    sd: dict[str, torch.Tensor] = {}
    nd = 3 if "fc0" in p else 2
    if nd == 3:
        _linear(p["fc0"], "fc0", sd)
    else:
        _conv(p["patch_embed"]["proj1"], "patch_embed.proj.0", sd)
        _conv1x1(p["patch_embed"]["proj2"], "patch_embed.proj.2", sd)
    if "scale_feats" in p:
        _linear(p["scale_feats"], "scale_feats", sd)
    i = 0
    while f"spectral_{i}" in p:
        for k, w in p[f"spectral_{i}"].items():
            sd[f"spectral_convs.{i}.{k}"] = _t(w)
        _conv1x1(p[f"w_{i}"], f"convs.{i}", sd, nd)
        if f"ln_{i}" in p:
            _norm(p[f"ln_{i}"], f"ln_layers.{i}", sd)
        i += 1
    _cls_head(p, sd)
    _linear(p["fc1"], "fc1", sd)
    _linear(p["fc2"], "fc2", sd)
    return sd


def _unet(p: Mapping, stats: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}

    def block(src: str, tmod: str, tname: str) -> None:
        for j in (1, 2):
            _conv(p[src][f"conv{j}"], f"{tmod}.{tname}conv{j}", sd)
            pre = f"{tmod}.{tname}norm{j}"
            _norm(p[src][f"norm{j}"], pre, sd)
            sd[f"{pre}.running_mean"] = _t(stats[src][f"norm{j}"]["mean"])
            sd[f"{pre}.running_var"] = _t(stats[src][f"norm{j}"]["var"])
            sd[f"{pre}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    for i in (1, 2, 3, 4):
        block(f"enc{i}", f"encoder{i}", f"enc{i}")
    block("bottleneck", "bottleneck", "bottleneck")
    for i in (4, 3, 2, 1):
        _conv_transpose(p[f"upconv{i}"], f"upconv{i}", sd)
        block(f"dec{i}", f"decoder{i}", f"dec{i}")
    _conv(p["out_conv"], "conv", sd)
    return sd


def _mlp(p: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _linear(p["linear_pre"], "linear_pre", sd)
    i = 0
    while f"linears_{i}" in p:
        _linear(p[f"linears_{i}"], f"linears.{i}", sd)
        i += 1
    _linear(p["linear_post"], "linear_post", sd)
    return sd


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX params of any family ({'params': ...[, 'batch_stats': ...]} or
    the inner params dict) -> the port's (reference-layout) state dict of
    tensors on the CPU. The tree's keys tell the families apart: `out_cno`
    CDPOT, `spectral_0` the FNOs, `enc1` UNet (its `batch_stats` become the
    running buffers, num_batches_tracked 0), `linear_pre` MLP, else DPOT
    2D or 3D (the patch kernel's rank)."""
    p = params["params"] if "params" in params else params
    if "out_cno" in p:
        return _cdpot(p)
    if "spectral_0" in p:
        return _fno(p)
    if "enc1" in p:
        return _unet(p, params["batch_stats"])
    if "linear_pre" in p:
        return _mlp(p)
    return _dpot(p)


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """State dict of a reference `.pth` ({'args', 'model', 'optimizer'} or a
    bare state dict), DDP prefixes stripped. Loaded with weights_only, with
    argparse.Namespace (the reference's saved 'args') allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["model"] if isinstance(obj, dict) and "model" in obj else obj
    return strip_module_prefix(sd)


def resize_pos_embed(pos: torch.Tensor, *size: int) -> torch.Tensor:
    """The position embedding (1, D, h0, w0[, l0]) resized (bi/trilinear,
    half-pixel centres, as torch's interpolate with align_corners=False) to
    (1, D, *size): a checkpoint trained at another resolution (the
    reference's resize_pos_embed, models/dpot.py:424-441)."""
    if tuple(pos.shape[2:]) == size:
        return pos
    last = pos[0].movedim(0, -1).float().numpy()
    out = resize_linear_nd(last, size)
    return torch.from_numpy(np.ascontiguousarray(out)).movedim(-1, 0)[None].to(pos.dtype)


def params_from_any(path: str, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The state dict for `model` from a reference `.pth`, a port checkpoint
    directory or its model.pth (the port's counterpart of load_params_any in
    dpot_tpu/cli/evaluate.py), pos_embed resized to the model's latent grid
    and complex tensors split as (real, imaginary) on a new leading axis.
    Load it with strict=True: any other key or shape that does not match
    raises there, naming both shapes."""
    from dpot_tpu_torch.train.checkpoint import restore_params

    sd = restore_params(path)
    sd = {k: torch.stack([v.real, v.imag]) if v.is_complex() else v for k, v in sd.items()}
    if "pos_embed" in sd:
        sd["pos_embed"] = resize_pos_embed(sd["pos_embed"],
                                           *model.state_dict()["pos_embed"].shape[2:])
    return sd


# what a 2D model lends a 3D one: the trunk blocks and the time aggregator
INFLATE_PREFIXES = ("blocks.", "time_agg_layer.")


def inflate_2d_to_3d(
    sd3d: Mapping[str, torch.Tensor], sd2d: Mapping[str, torch.Tensor],
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """2D -> 3D weight inflation (the reference's load_3d_components_from_2d,
    utilities.py:170-207; the JAX package's inflate_2d_to_3d with its
    components, blocks and time_agg): every entry of the 3D state dict's
    trunk blocks and time aggregator that the 2D one has with the same
    shape, once a 1x1 convolution weight (O, I, 1, 1) is unsqueezed to its
    1x1x1 form, is copied. Returns the merged state dict (a copy of sd3d)
    and the copied names, in sd3d's order."""
    merged = dict(sd3d)
    copied = []
    for k, v in sd3d.items():
        src = sd2d.get(k)
        if src is None or not k.startswith(INFLATE_PREFIXES):
            continue
        if src.dim() + 1 == v.dim():
            src = src.unsqueeze(-1)
        if src.shape == v.shape:
            merged[k] = src.to(v.dtype)
            copied.append(k)
    return merged, copied

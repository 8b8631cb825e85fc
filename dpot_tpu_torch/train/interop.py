"""Reference-layout weights for the port (the port side of
dpot_tpu/train/interop.py).

The port's DPOTNet and DPOTNet3D keep the reference torch state dict's
names and shapes, so a reference `.pth` loads directly.
`state_dict_from_jax` maps the JAX package's DPOTNet or DPOTNet3D params (a
pytree of numpy arrays) to that layout; it is the exact inverse of the JAX
package's `dpot_params_from_torch` / `dpot3d_params_from_torch`.
`params_from_any` reads the weights of a reference `.pth` or of a port
checkpoint for a model at hand, its position embedding resized to the
model's latent grid. `inflate_2d_to_3d` bootstraps a 3D model from a 2D
one (the reference's load_3d_components_from_2d).
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


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX DPOTNet or DPOTNet3D params ({'params': ...} or the inner dict)
    -> the port's (reference-layout) state dict of float tensors on the CPU.
    The rank of the patch kernel tells the two apart."""
    p = params["params"] if "params" in params else params
    sd: dict[str, torch.Tensor] = {}
    pe = p["patch_embed"]
    kernel = np.asarray(pe["proj1"]["kernel"])
    nd = kernel.ndim - 2
    spatial = tuple(range(nd))
    # (k..., I, O) -> (O, I, k...)
    sd["patch_embed.proj.0.weight"] = _t(np.transpose(kernel, (nd + 1, nd) + spatial))
    sd["patch_embed.proj.0.bias"] = _t(pe["proj1"]["bias"])
    _conv1x1(pe["proj2"], "patch_embed.proj.2", sd, nd)
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
            sd[f"{pre}.{norm}.weight"] = _t(b[norm]["scale"])
            sd[f"{pre}.{norm}.bias"] = _t(b[norm]["bias"])
        for k in ("w1", "b1", "w2", "b2"):
            sd[f"{pre}.filter.{k}"] = _t(b["filter"][k])
        _conv1x1(b["mlp_fc1"], f"{pre}.mlp.0", sd, nd)
        _conv1x1(b["mlp_fc2"], f"{pre}.mlp.2", sd, nd)
        i += 1
    for j, idx in enumerate((0, 2, 4)):
        if f"cls_head_{j}" in p:
            _linear(p[f"cls_head_{j}"], f"cls_head.{idx}", sd)
    # UnpatchConv kernel (p..., D, O) -> ConvTranspose weight (D, O, p...)
    sd["out_layer.0.weight"] = _t(np.transpose(p["out_deconv"]["kernel"],
                                               (nd, nd + 1) + spatial))
    sd["out_layer.0.bias"] = _t(p["out_deconv"]["bias"])
    _conv1x1(p["out_conv1"], "out_layer.2", sd, nd)
    _conv1x1(p["out_conv2"], "out_layer.4", sd, nd)
    return sd


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
    dpot_tpu/cli/evaluate.py), pos_embed resized to the model's latent grid.
    Load it with strict=True: any other key or shape that does not match
    raises there, naming both shapes."""
    from dpot_tpu_torch.train.checkpoint import restore_params

    sd = restore_params(path)
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

"""Reference-layout weights for the port (the port side of
dpot_tpu/train/interop.py).

The port's DPOTNet keeps the reference torch state dict's names and shapes,
so a reference `.pth` loads directly. `state_dict_from_jax` maps the JAX
package's DPOTNet params (a pytree of numpy arrays) to that layout; it is
the exact inverse of the JAX package's `dpot_params_from_torch`.
`params_from_any` reads the weights of a reference `.pth` or of a port
checkpoint for a model at hand, its position embedding resized to the
model's latent grid.
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


def _conv1x1(d: Mapping, prefix: str, out: dict) -> None:
    """Dense kernel (I, O) -> 1x1 Conv2d weight (O, I, 1, 1)."""
    out[f"{prefix}.weight"] = _t(np.asarray(d["kernel"]).T[:, :, None, None])
    out[f"{prefix}.bias"] = _t(d["bias"])


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX DPOTNet params ({'params': ...} or the inner dict) -> the port's
    (reference-layout) state dict of float tensors on the CPU."""
    p = params["params"] if "params" in params else params
    sd: dict[str, torch.Tensor] = {}
    pe = p["patch_embed"]
    # HWIO (kh, kw, I, O) -> OIHW
    sd["patch_embed.proj.0.weight"] = _t(np.transpose(pe["proj1"]["kernel"], (3, 2, 0, 1)))
    sd["patch_embed.proj.0.bias"] = _t(pe["proj1"]["bias"])
    _conv1x1(pe["proj2"], "patch_embed.proj.2", sd)
    sd["pos_embed"] = _t(np.transpose(p["pos_embed"], (0, 3, 1, 2)))  # NHWC -> NCHW
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
        _conv1x1(b["mlp_fc1"], f"{pre}.mlp.0", sd)
        _conv1x1(b["mlp_fc2"], f"{pre}.mlp.2", sd)
        i += 1
    for j, idx in enumerate((0, 2, 4)):
        if f"cls_head_{j}" in p:
            _linear(p[f"cls_head_{j}"], f"cls_head.{idx}", sd)
    # UnpatchConv kernel (p, p, D, O) -> ConvTranspose2d weight (D, O, p, p)
    sd["out_layer.0.weight"] = _t(np.transpose(p["out_deconv"]["kernel"], (2, 3, 0, 1)))
    sd["out_layer.0.bias"] = _t(p["out_deconv"]["bias"])
    _conv1x1(p["out_conv1"], "out_layer.2", sd)
    _conv1x1(p["out_conv2"], "out_layer.4", sd)
    return sd


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """State dict of a reference `.pth` ({'args', 'model', 'optimizer'} or a
    bare state dict), DDP prefixes stripped. Loaded with weights_only, with
    argparse.Namespace (the reference's saved 'args') allowed."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["model"] if isinstance(obj, dict) and "model" in obj else obj
    return strip_module_prefix(sd)


def resize_pos_embed(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The position embedding (1, D, h0, w0) resized bilinearly (half-pixel
    centres, as torch's interpolate with align_corners=False) to (1, D, h, w):
    a checkpoint trained at another resolution (the reference's
    resize_pos_embed, models/dpot.py:424-441)."""
    if pos.shape[2:] == (h, w):
        return pos
    nhwc = pos[0].permute(1, 2, 0).float().numpy()
    out = resize_linear_nd(nhwc, (h, w))
    return torch.from_numpy(np.ascontiguousarray(out)).permute(2, 0, 1)[None].to(pos.dtype)


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

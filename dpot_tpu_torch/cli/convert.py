"""Checkpoint conversion CLI of the port (port of dpot_tpu/cli/convert.py):
a reference-layout .pth (a released DPOT checkpoint) to a checkpoint
directory of the port.

    python -m dpot_tpu_torch.cli.convert --resume_path model_Ti.pth \
        --model DPOT --width 512 --n_layers 4 --res 128 --out_path ckpt/Ti [--device cpu]

The directory holds model.pth (the weights, fresh optimizer state, step 0)
and config.json, so that `cli.train --resume_path`, `cli.serve` and
`cli.evaluate` (with --config_from_ckpt true) all take it. Every family of
the registry: DPOT 2D, DPOT3D and FNO3D (whose directories cli.evaluate
reads on 3D sets), CDPOT (the reference's duplicate `act_patching` /
`proj.1` keys load as the one parameter they are), FNO (with --use_ln) and
UNet (its BatchNorm statistics with it). FNO3D's torch.cfloat spectral
weights are split into the real-stacked layout (train/interop.py
`params_from_any`), the counterpart of the JAX package's per-family
converters (dpot_tpu/cli/convert.py).
"""

from __future__ import annotations

import sys

import torch

FAMILIES = ("DPOT", "AFNO", "DPOT3D", "CDPOT", "FNO", "FNO3D", "UNET")


def main(argv=None) -> str:
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.checkpoint import save_checkpoint
    from dpot_tpu_torch.train.interop import params_from_any
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.utils.config import load_config, pop_flag

    argv = list(argv if argv is not None else sys.argv[1:])
    out_path = pop_flag(argv, "--out_path", "./converted_ckpt")
    device = pop_flag(argv, "--device", "cuda")
    cfg = load_config(argv)
    if cfg.model.upper() not in FAMILIES:
        raise ValueError(f"no converter for model {cfg.model!r}")
    model = build_model(
        cfg.model, img_size=cfg.res, patch_size=cfg.patch_size, in_channels=cfg.n_channels,
        in_timesteps=cfg.T_in, out_timesteps=cfg.T_bundle, embed_dim=cfg.width,
        modes=cfg.modes, depth=cfg.n_layers, n_blocks=cfg.n_blocks,
        mlp_ratio=cfg.mlp_ratio, out_layer_dim=cfg.out_layer_dim, act=cfg.act,
        n_cls=len(cfg.train_paths), normalize=cfg.normalize, use_ln=cfg.use_ln,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        device=device, seed=cfg.seed,
    )
    model.load_state_dict(params_from_any(cfg.resume_path, model), strict=True)
    opt = build_optimizer(cfg.opt, model.parameters(), cfg.lr, cfg.beta1, cfg.beta2)
    state = TrainState.create(model, opt, seed=cfg.seed + 1)
    save_checkpoint(out_path, state, config=vars(cfg))
    print(f"converted {cfg.resume_path} -> {out_path}", flush=True)
    return out_path


if __name__ == "__main__":
    main()

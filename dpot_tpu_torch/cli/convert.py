"""Checkpoint conversion CLI of the port (port of dpot_tpu/cli/convert.py):
a reference-layout .pth (a released DPOT checkpoint) to a checkpoint
directory of the port.

    python -m dpot_tpu_torch.cli.convert --resume_path model_Ti.pth \
        --model DPOT --width 512 --n_layers 4 --res 128 --out_path ckpt/Ti [--device cpu]

The directory holds model.pth (the weights, fresh optimizer state, step 0)
and config.json, so that `cli.train --resume_path`, `cli.serve` and
`cli.evaluate` (with --config_from_ckpt true) all take it. DPOT 2D and
DPOT3D (`--model DPOT3D`, whose directory cli.evaluate reads on 3D sets).
"""

from __future__ import annotations

import sys

import torch

# the reference's other families: their converters wait for their models
_NOT_PORTED = ("CDPOT", "FNO", "FNO3D", "UNET")


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
    name = cfg.model.upper()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"converting a {cfg.model} checkpoint is not ported yet (ROADMAP, 'Modules "
            "to port', item 11: the other model families)")
    if name not in ("DPOT", "AFNO", "DPOT3D"):
        raise ValueError(f"no converter for model {cfg.model!r}")
    model = build_model(
        cfg.model, img_size=cfg.res, patch_size=cfg.patch_size, in_channels=cfg.n_channels,
        in_timesteps=cfg.T_in, out_timesteps=cfg.T_bundle, embed_dim=cfg.width,
        modes=cfg.modes, depth=cfg.n_layers, n_blocks=cfg.n_blocks,
        mlp_ratio=cfg.mlp_ratio, out_layer_dim=cfg.out_layer_dim, act=cfg.act,
        n_cls=len(cfg.train_paths), normalize=cfg.normalize,
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

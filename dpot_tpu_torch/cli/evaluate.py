"""Evaluation CLI of the port (port of dpot_tpu/cli/evaluate.py, the
reference's evaluate.py):

    python -m dpot_tpu_torch.cli.evaluate --model DPOT --resume_path <ckpt> \
        --test_paths ns2d_fno_1e-5 --res 128 --width 1024 --n_layers 6 \
        [--metrics] [--varyres] [--config_from_ckpt true] [--device cpu]

--resume_path takes a reference-layout .pth or a checkpoint directory that
the port wrote (or its model.pth). 3D test sets take DPOT3D (a DPOT model
named on them becomes one, as in the JAX CLI), which returns the
prediction only; --varyres is 2D-only, and one run takes sets of one rank.
--metrics adds the reference Evaluator's battery (the 3D one on 3D sets),
--varyres runs the resolution-transfer sweep instead. --device:
cuda by default, where the kernels run; cpu runs their plain versions.
Prints a line per dataset, then the results as one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch


def main(argv=None) -> dict:
    from dpot_tpu_torch.data.registry import get_spec
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.evaluator import evaluate, evaluate_varying_resolution
    from dpot_tpu_torch.train.interop import params_from_any
    from dpot_tpu_torch.utils.config import load_config, pop_flag, pop_switch

    argv = list(argv if argv is not None else sys.argv[1:])
    varyres = pop_switch(argv, "--varyres")
    full_metrics = pop_switch(argv, "--metrics")
    device = pop_flag(argv, "--device", "cuda")
    cfg = load_config(argv)
    if not cfg.resume_path:
        raise SystemExit("--resume_path is required: the checkpoint to evaluate")

    n_channels = max(get_spec(p).n_channels for p in cfg.test_paths)
    ndims = {p: get_spec(p).ndim for p in cfg.test_paths}
    if len(set(ndims.values())) > 1:
        raise SystemExit(
            "mixed-rank test sets are unsupported (one model serves one spatial "
            f"rank): {ndims}; evaluate 2D and 3D sets separately")
    ndim = ndims[cfg.test_paths[0]]
    if varyres and ndim != 2:
        raise SystemExit(
            "--varyres sweeps 2D resolutions only (spectral resize and the varyres "
            f"rollout are 2D); the test sets are {ndim}D: run the standard 3D "
            "evaluation instead")
    model_name = cfg.model
    if ndim == 3 and model_name in ("DPOT", "dpot", "AFNO", "afno"):
        model_name = "DPOT3D"  # 3D sets take the 3D family, as in the JAX CLI
    if (ndim == 3) != (model_name in ("DPOT3D", "dpot3d", "FNO3D", "fno3d")):
        raise SystemExit(f"model {model_name} cannot evaluate {ndim}D test sets")

    model = build_model(
        model_name, img_size=cfg.res, patch_size=cfg.patch_size, in_channels=n_channels,
        in_timesteps=cfg.T_in, out_timesteps=cfg.T_bundle, embed_dim=cfg.width,
        modes=cfg.modes, depth=cfg.n_layers, n_blocks=cfg.n_blocks,
        mlp_ratio=cfg.mlp_ratio, out_layer_dim=cfg.out_layer_dim, act=cfg.act,
        n_cls=len(cfg.train_paths), normalize=cfg.normalize, use_ln=cfg.use_ln,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        device=device, seed=cfg.seed,
    )
    model.load_state_dict(params_from_any(cfg.resume_path, model), strict=True)

    common = dict(t_in=cfg.T_in, t_bundle=cfg.T_bundle, batch_size=cfg.batch_size,
                  n_channels=n_channels, num_workers=cfg.num_workers)
    if varyres:
        results = evaluate_varying_resolution(model, cfg.test_paths, model_res=cfg.res,
                                              **common)
        for res, per_ds in results.items():
            for p, v in per_ds.items():
                print(f"res {res}, {p}: {v['loss_full']:.5f}")
    else:
        results = evaluate(model, cfg.test_paths, res=cfg.res, full_metrics=full_metrics,
                           viz_dir=cfg.viz_dir or None, **common)
        for p in cfg.test_paths:
            print(f"{p}: {results[p]['loss_full']:.5f}")
        print(f"Avg time : {results['avg_step_time']:.5f}")
    print(json.dumps(results, default=str), flush=True)
    return results


if __name__ == "__main__":
    main()

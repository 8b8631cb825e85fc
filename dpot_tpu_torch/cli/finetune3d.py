"""3D fine-tuning CLI of the port (port of dpot_tpu/cli/finetune3d.py, the
reference's finetune3d.py):

    python -m dpot_tpu_torch.cli.finetune3d --train_paths ns3d_pdb_M1_turb \
        --res 64 --resume_path <2D .pth | port checkpoint dir> [--device cpu]

Trains DPOTNet3D on one 3D dataset (TemporalDataset3D), bootstrapped, when
--resume_path is given, from a 2D pretrain by the 2D->3D inflation
(train/interop.py `inflate_2d_to_3d`: the trunk blocks and the time
aggregator, 1x1 convolutions unsqueezed to 1x1x1). The source is a
reference-layout .pth or a checkpoint directory that the port wrote; both
hold the 2D state dict by name, so, unlike the JAX CLI, no 2D template
model is built to read it. Every epoch prints its train and test relative
L2 (divided as the JAX CLI divides them) and, with --use_writer, writes a
checkpoint to --log_path that `restore_params` reads.
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> dict:
    import torch

    from dpot_tpu_torch.data import DataLoader, TemporalDataset3D
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.checkpoint import restore_params, save_checkpoint
    from dpot_tpu_torch.train.interop import inflate_2d_to_3d
    from dpot_tpu_torch.train.loop import _to_device, loader_arch
    from dpot_tpu_torch.train.optimizers import build_optimizer
    from dpot_tpu_torch.train.schedules import build_schedule, onecycle_momentum
    from dpot_tpu_torch.train.state import TrainState
    from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step
    from dpot_tpu_torch.utils.config import load_config, pop_flag

    argv = list(argv if argv is not None else sys.argv[1:])
    device = pop_flag(argv, "--device", "cuda")
    cfg = load_config(argv)
    print("config", vars(cfg), "device", device, flush=True)
    name = cfg.train_paths[0]

    train_ds = TemporalDataset3D(name, res=cfg.res, t_in=cfg.T_in, t_ar=cfg.T_ar, train=True)
    test_ds = TemporalDataset3D(name, res=cfg.res, t_in=cfg.T_in, t_ar=-1, train=False)
    prefetch, ring = loader_arch(cfg)
    train_dl = DataLoader(train_ds, cfg.batch_size, shuffle=True, num_workers=cfg.num_workers,
                          seed=cfg.seed, prefetch=prefetch, slot_ring=ring)
    test_dl = DataLoader(test_ds, cfg.batch_size, shuffle=False, num_workers=cfg.num_workers,
                         prefetch=prefetch)

    model = build_model(
        "DPOT3D", img_size=cfg.res, patch_size=cfg.patch_size,
        in_channels=train_ds.n_channels, in_timesteps=cfg.T_in,
        out_timesteps=cfg.T_bundle, embed_dim=cfg.width, modes=cfg.modes,
        depth=cfg.n_layers, n_blocks=cfg.n_blocks, mlp_ratio=cfg.mlp_ratio,
        out_layer_dim=cfg.out_layer_dim, act=cfg.act, n_cls=1, normalize=cfg.normalize,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        remat=cfg.remat, device=device, seed=cfg.seed,
    )
    copied: list[str] = []
    if cfg.resume_path:
        merged, copied = inflate_2d_to_3d(model.state_dict(), restore_params(cfg.resume_path))
        model.load_state_dict(merged, strict=True)
        print(f"inflated {len(copied)} 2D entries into the 3D model", flush=True)

    steps_per_epoch = max(len(train_dl), 1)
    sched = build_schedule(cfg.lr_method, cfg.lr, steps_per_epoch, cfg.epochs,
                           warmup_epochs=cfg.warmup_epochs)
    beta1 = cfg.beta1
    if cfg.lr_method == "cycle" and cfg.cycle_momentum:
        # OneCycleLR cycles beta1, and the reference's optimizers read it
        beta1 = onecycle_momentum(steps_per_epoch * cfg.epochs, cfg.warmup_epochs, cfg.epochs)
    opt = build_optimizer(cfg.opt, model.parameters(), sched, beta1, cfg.beta2,
                          grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay)
    state = TrainState.create(model, opt, seed=cfg.seed + 1)
    step = make_train_step(t_bundle=cfg.T_bundle, noise_scale=cfg.noise_scale)
    roll = make_eval_rollout(t_bundle=cfg.T_bundle)
    device = next(model.parameters()).device

    train_l2, test_l2, step_seconds, load_seconds = [], [], [], []
    for ep in range(cfg.epochs):
        t0 = t1 = time.perf_counter()
        tr = 0.0
        steps_per_sample = 1.0
        pending = None
        for x, y, msk, _ in train_dl:
            load_seconds.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            batch = {"x": _to_device(x, device), "y": _to_device(y, device),
                     "msk": _to_device(msk, device),
                     "cls": torch.zeros(x.shape[0], dtype=torch.int64, device=device)}
            state, aux = step(state, batch)
            # loss_step sums over the T_ar // T_bundle rollout steps
            steps_per_sample = max(y.shape[-2] // cfg.T_bundle, 1)
            # one-step-lagged read-back: the host does not wait inside a step
            if pending is not None:
                tr += float(pending)
            pending = aux["loss_step"]
            step_seconds.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
        if pending is not None:
            tr += float(pending)
        te = 0.0
        for x, y, msk, _ in test_dl:
            out = roll(model, {"x": _to_device(x, device), "y": _to_device(y, device),
                               "msk": _to_device(msk, device)})
            te += float(out["loss_full"])
        train_l2.append(tr / len(train_ds) / steps_per_sample)
        test_l2.append(te / len(test_ds))
        print(f"epoch {ep}, time {time.perf_counter() - t0:.3f}, train l2 step "
              f"{train_l2[-1]:.5f} test l2 full {test_l2[-1]:.5f}", flush=True)
        if cfg.use_writer and cfg.log_path:
            save_checkpoint(cfg.log_path, state, config=vars(cfg))
    return {"state": state, "model": model, "copied": copied, "train_l2_step": train_l2,
            "test_l2_full": test_l2, "step_seconds": step_seconds,
            "load_seconds": load_seconds}


if __name__ == "__main__":
    main()

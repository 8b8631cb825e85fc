"""The pretraining loop on one device (port of dpot_tpu/train/loop.py).

`train(cfg)` drives: dataset mixture -> train step (AR rollout, noise
injection, optimizer) -> per-dataset eval rollouts -> epoch logging under
the reference's scalar names -> checkpoints -> loss-explosion rollback.

The loss of step i is read back only after step i + 1 has been queued
(one-step-lagged fetch), so the host never waits for the device inside a
step. Batches cross to the device through pinned host memory. With
`steps_per_dispatch=K` the loader hands out K * B samples at a time, which
go to the device as (K, B, ...) and run as one K-step dispatch (a CUDA
graph on the card, train/step.py); a tail that cannot fill a dispatch runs
as B-sized single steps, so an epoch takes the samples and optimizer steps
of K = 1. Options of the JAX loop that are not ported raise
NotImplementedError naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.checkpoint import restore_checkpoint, restore_params, save_checkpoint
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.schedules import build_schedule, onecycle_momentum
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step
from dpot_tpu_torch.utils.config import TrainConfig
from dpot_tpu_torch.utils.device import resolve_device
from dpot_tpu_torch.utils.metrics_logging import MetricWriter


def _fetch(t) -> float:
    """A device scalar read back to the host (the loop's only syncs)."""
    return float(t)


def _fetch_rows(*ts: torch.Tensor) -> list[list[float]]:
    """Equal-length device vectors read back to the host in one transfer."""
    return torch.stack(ts).tolist()


def _opt_steps_per_epoch(cfg: TrainConfig, train_dl, train_ds) -> int:
    """Optimizer steps per epoch, the schedule's and the resume's unit:
    len(train_dl) at steps_per_dispatch 1; with K-step dispatches the
    loader's batches are K * B but tails split back into B-sized steps, so
    the count stays ceil(n / B), as at K = 1."""
    if cfg.steps_per_dispatch == 1:
        return max(len(train_dl), 1)
    return max(-(-len(train_ds) // cfg.batch_size), 1)


def check_ported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError for every option of the JAX loop that the
    port does not have yet."""
    item = "ROADMAP, 'Modules to port', item"
    missing = [
        (cfg.mesh_data not in (None, 1) or cfg.mesh_spatial > 1 or cfg.mesh_model > 1
         or cfg.mesh_pipe > 1, f"device meshes (mesh_*) ({item} 12)"),
        (cfg.shard_params != "replicate",
         f"shard_params={cfg.shard_params!r} ({item} 12)"),
        (bool(cfg.viz_dir), f"viz_dir (utils/viz.py) ({item} 13)"),
    ]
    for bad, what in missing:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def _rollback_tensors(state: TrainState) -> tuple[torch.Tensor, ...]:
    """What a rollback restores: the parameters (the f32 master where the
    model runs a working copy), the moments and the model's buffers (UNet's
    BatchNorm statistics, which JAX keeps among its params)."""
    opt = state.optimizer
    return (*opt.params, *opt.mu, *opt.nu, *state.model.buffers())


def _snapshot(state: TrainState) -> list[torch.Tensor]:
    """Device copies of the rollback's tensors."""
    return [t.detach().clone() for t in _rollback_tensors(state)]


@torch.no_grad()
def _restore(state: TrainState, snap: list[torch.Tensor]) -> None:
    for dst, src in zip(_rollback_tensors(state), snap):
        dst.copy_(src)
    state.refresh_working_copy()


def _to_device(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def build_everything(cfg: TrainConfig, device: str | torch.device = "cuda"):
    """Datasets, loaders, model, schedule and the train state at step 0."""
    check_ported(cfg)
    device = resolve_device(device)
    train_ds = MixedTemporalDataset(
        cfg.train_paths, cfg.ntrain_list, res=cfg.res, t_in=cfg.T_in,
        t_ar=cfg.T_ar, train=True, data_weights=cfg.data_weights,
    )
    test_dss = [
        MixedTemporalDataset(
            [p], [cfg.ntest_list[i]] if cfg.ntest_list else None, res=cfg.res,
            n_channels=train_ds.n_channels, t_in=cfg.T_in, t_ar=-1, train=False,
        )
        for i, p in enumerate(cfg.test_paths)
    ]
    prefetch = cfg.loader_prefetch
    if prefetch < 0:
        prefetch = 0 if cfg.num_workers <= 1 else 8
    # steps_per_dispatch=K: K optimizer steps' samples a loader batch
    train_dl = DataLoader(train_ds, cfg.batch_size * cfg.steps_per_dispatch, shuffle=True,
                          num_workers=cfg.num_workers, seed=cfg.seed, prefetch=prefetch)
    test_dls = [DataLoader(ds, cfg.batch_size, shuffle=False,
                           num_workers=cfg.num_workers, prefetch=prefetch)
                for ds in test_dss]
    model = build_model(
        cfg.model, img_size=cfg.res, patch_size=cfg.patch_size,
        in_channels=train_ds.n_channels, in_timesteps=cfg.T_in,
        out_timesteps=cfg.T_bundle, embed_dim=cfg.width, modes=cfg.modes,
        depth=cfg.n_layers, n_blocks=cfg.n_blocks, mlp_ratio=cfg.mlp_ratio,
        out_layer_dim=cfg.out_layer_dim, act=cfg.act, n_cls=len(cfg.train_paths),
        normalize=cfg.normalize, use_ln=cfg.use_ln, remat=cfg.remat,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        device=device, seed=cfg.seed,
    )
    steps_per_epoch = _opt_steps_per_epoch(cfg, train_dl, train_ds)
    sched = build_schedule(
        cfg.lr_method, cfg.lr, steps_per_epoch, cfg.epochs,
        warmup_epochs=cfg.warmup_epochs, step_size=cfg.step_size,
        step_gamma=cfg.step_gamma, lr_step_size=cfg.lr_step_size,
    )
    beta1 = cfg.beta1
    if cfg.lr_method == "cycle" and cfg.cycle_momentum:
        # OneCycleLR cycles beta1, and the reference's optimizers read it
        beta1 = onecycle_momentum(steps_per_epoch * cfg.epochs, cfg.warmup_epochs,
                                  cfg.epochs)
    opt = build_optimizer(
        cfg.opt, model.parameters(), sched, beta1, cfg.beta2,
        grad_clip=cfg.grad_clip, weight_decay=cfg.weight_decay,
        moment_dtype=torch.bfloat16 if cfg.opt_moment_dtype == "bfloat16" else None,
    )
    state = TrainState.create(model, opt, seed=cfg.seed + 1)
    return model, state, sched, train_dl, test_dls, train_ds


def train(cfg: TrainConfig, log_dir: Optional[str] = None,
          device: str | torch.device = "cuda",
          init_state_dict: Optional[dict[str, torch.Tensor]] = None) -> dict:
    """Train on `device` (CUDA unless the caller asks for the CPU). Returns
    the state, the model, the last epoch's metrics, the log directory and
    the host time of every loop iteration (`step_seconds`).

    The run starts from, in this order of precedence: `init_state_dict`
    (the caller's weights, e.g. cli/finetune's merge), cfg.resume_path (a
    full resume: weights, moments, step, noise stream) or cfg.init_from (a
    checkpoint's weights only). A warm start from weights keeps fresh
    moments, step 0 and the schedule from its start. `dispatch_steps`
    holds the optimizer steps of each loop iteration (K or 1)."""
    model, state, sched, train_dl, test_dls, train_ds = build_everything(cfg, device)
    device = next(model.parameters()).device
    if log_dir is None and cfg.use_writer:
        log_dir = os.path.join(cfg.log_path or "./logs",
                               time.strftime("%m%d_%H_%M_%S") + cfg.comment)
    writer = MetricWriter(log_dir)
    ckpt_dir = os.path.join(log_dir, "model") if log_dir else None
    if ckpt_dir and cfg.async_ckpt:
        writer.text("async_ckpt: checkpoints are saved synchronously in this port")

    steps_per_epoch = _opt_steps_per_epoch(cfg, train_dl, train_ds)
    start_epoch = 0
    if init_state_dict is None and cfg.init_from and not cfg.resume_path:
        init_state_dict = restore_params(cfg.init_from)
        writer.text(f"warm start: params from {cfg.init_from}")
    if init_state_dict is not None:
        # params only: the moments, step and schedule start afresh
        state.load_params(init_state_dict)
    elif cfg.resume_path:
        # full resume: params, moments, step (schedule position), noise
        # stream, and the loader positioned on the checkpoint's epoch
        restore_checkpoint(cfg.resume_path, state)
        start_epoch = min(state.step // steps_per_epoch, cfg.epochs)
        train_dl.set_epoch(start_epoch)
        writer.text(f"resumed full train state from {cfg.resume_path}: step "
                    f"{state.step}, continuing at epoch {start_epoch}")

    time_major = bool(train_ds.time_major_batches)
    ones_mask = bool(train_ds.train_masks_are_ones)
    # wire formats: x in bf16 when the compute is bf16 anyway; no mask when
    # the train masks are all ones
    wire = cfg.wire_dtype
    if wire == "auto":
        wire = "bfloat16_x" if cfg.dtype == "bfloat16" else "float32"
    wire_x = torch.bfloat16 if wire.startswith("bfloat16") else None
    wire_y = torch.bfloat16 if wire == "bfloat16" else None
    step_kw = dict(t_bundle=cfg.T_bundle, noise_scale=cfg.noise_scale,
                   time_major=time_major, ones_mask=ones_mask)
    K = cfg.steps_per_dispatch
    step_fn = make_train_step(grad_accum=cfg.grad_accum, scan_steps=K, **step_kw)
    # a tail that cannot fill a dispatch runs B-sized single steps
    tail_step_fn = make_train_step(grad_accum=cfg.grad_accum, **step_kw) if K > 1 else step_fn
    # a tail batch that does not divide into grad_accum takes one full step
    noaccum_step_fn = make_train_step(**step_kw) if cfg.grad_accum > 1 else tail_step_fn
    roll_fn = make_eval_rollout(t_bundle=cfg.T_bundle)

    n_params = sum(p.numel() for p in model.parameters())
    writer.text(f"model {cfg.model} params {n_params / 1e6:.2f}M device {device}")

    it = start_epoch * steps_per_epoch
    loss_ema = None
    rollback_on = cfg.rollback_factor > 0 and cfg.rollback_snapshot_steps >= 0
    last_good = _snapshot(state) if rollback_on else None
    history: dict = {}
    step_seconds: list[float] = []
    dispatch_steps: list[int] = []

    for ep in range(start_epoch, cfg.epochs):
        t1 = t_1 = time.perf_counter()
        t_load = t_train = 0.0
        train_l2_step = train_l2_full = 0.0
        train_seen = 0
        steps_per_sample = 1.0
        pending = None  # (aux, per-step batch size, steps per sample, global step)

        def drain(pending):
            nonlocal train_l2_step, train_l2_full, train_seen, loss_ema
            if pending is None:
                return
            aux, bsz, sps, it_d = pending
            if aux["loss_step"].dim():
                # a K-step dispatch: its (K,) losses in one transfer
                losses = list(zip(*_fetch_rows(aux["loss_step"], aux["loss_full"])))
            else:
                losses = [(_fetch(aux["loss_step"]), _fetch(aux["loss_full"]))]
            for j, (loss_v, full_v) in enumerate(losses):
                # the exploded sub-step counts, as at K = 1; the rest of its
                # dispatch belongs to the trajectory rolled back, and does not
                train_l2_step += loss_v
                train_l2_full += full_v
                train_seen += bsz
                step_idx = it_d - len(losses) + 1 + j
                if writer.log_dir:
                    writer.scalar("train_loss_step", loss_v / (bsz * sps), step_idx)
                    writer.scalar("train_loss_full", full_v / bsz, step_idx)
                # failure detection against an EMA of the losses; a non-finite
                # loss always triggers, even before the EMA has a value
                exploded = rollback_on and (
                    not np.isfinite(loss_v)
                    or (loss_ema is not None and step_idx > cfg.rollback_warmup_steps
                        and loss_v > cfg.rollback_factor * loss_ema)
                )
                if exploded:
                    ema_s = f"{loss_ema:.3g}" if loss_ema is not None else "unset"
                    writer.text(f"loss explodes ({loss_v:.3g} vs ema {ema_s}), "
                                "restoring previous good state")
                    _restore(state, last_good)
                    break
                if np.isfinite(loss_v):
                    loss_ema = loss_v if loss_ema is None else 0.9 * loss_ema + 0.1 * loss_v

        def dispatch_units(dl):
            """Loader batches as (x, y, msk, cls, k): a full K * B batch is one
            K-step dispatch, anything else B-sized single steps."""
            bs = cfg.batch_size
            for x_, y_, msk_, cls_ in dl:
                if K == 1 or x_.shape[0] == K * bs:
                    yield x_, y_, msk_, cls_, K
                else:
                    for i in range(0, x_.shape[0], bs):
                        yield x_[i:i + bs], y_[i:i + bs], msk_[i:i + bs], cls_[i:i + bs], 1

        for x, y, msk, cls, k_unit in dispatch_units(train_dl):
            t_load += time.perf_counter() - t_1
            t_1 = time.perf_counter()
            host = {"x": x, "y": y, "cls": cls}
            if not ones_mask:
                host["msk"] = msk
            if k_unit > 1:
                # (K * B, ...) -> (K, B, ...), a view
                host = {k: v.reshape(k_unit, cfg.batch_size, *v.shape[1:])
                        for k, v in host.items()}
            batch = {"x": _to_device(host["x"], device, wire_x),
                     "y": _to_device(host["y"], device, wire_y),
                     "cls": _to_device(host["cls"], device)}
            if not ones_mask:
                batch["msk"] = _to_device(host["msk"], device)
            steps_per_sample = y.shape[1 if time_major else y.ndim - 2] / cfg.T_bundle
            if k_unit > 1:
                fn = step_fn
            else:
                fn = noaccum_step_fn if x.shape[0] % cfg.grad_accum else tail_step_fn
            state, aux = fn(state, batch)
            prev_it = it
            it += k_unit
            drain(pending)
            if (rollback_on and cfg.rollback_snapshot_steps > 0
                    and it // cfg.rollback_snapshot_steps
                    != prev_it // cfg.rollback_snapshot_steps):
                # mid-epoch snapshot, taken after the drain so that a
                # just-detected explosion snapshots the restored state
                last_good = _snapshot(state)
            pending = (aux, x.shape[0] // k_unit, steps_per_sample, it)
            dt = time.perf_counter() - t_1
            t_train += dt
            step_seconds.append(dt)
            dispatch_steps.append(k_unit)
            t_1 = time.perf_counter()
        drain(pending)

        test_l2_steps, test_l2_fulls = [], []
        for di, dl in enumerate(test_dls):
            s_sum = f_sum = 0.0
            n_seen = 0
            t_y = None
            for x, y, msk, _ in dl:
                if t_y not in (None, y.shape[-2]):
                    raise ValueError(
                        f"eval batches of {cfg.test_paths[di]} mix rollout lengths "
                        f"{t_y} and {y.shape[-2]}"
                    )
                t_y = y.shape[-2]
                out = roll_fn(model, {"x": _to_device(x, device), "y": _to_device(y, device),
                                      "msk": _to_device(msk, device)})
                s_sum += _fetch(out["loss_step"])
                f_sum += _fetch(out["loss_full"])
                n_seen += x.shape[0]
            if n_seen == 0:
                writer.text(f"eval dataset {cfg.test_paths[di]} produced no batches; "
                            "metrics omitted")
                test_l2_steps.append(float("nan"))
                test_l2_fulls.append(float("nan"))
                continue
            test_l2_steps.append(s_sum / n_seen / max(t_y / cfg.T_bundle, 1))
            test_l2_fulls.append(f_sum / n_seen)
            if writer.log_dir:
                writer.scalar(f"test_loss_step_{cfg.test_paths[di]}", test_l2_steps[-1], ep)
                writer.scalar(f"test_loss_full_{cfg.test_paths[di]}", test_l2_fulls[-1], ep)

        if ckpt_dir and (ep % cfg.save_every == 0 or ep == cfg.epochs - 1):
            target = ckpt_dir
            if cfg.ckpt_bucket_epochs > 0:
                target = f"{ckpt_dir}_{ep // cfg.ckpt_bucket_epochs}"
            save_checkpoint(target, state, config=vars(cfg))
        if rollback_on and cfg.rollback_snapshot_steps == 0:
            last_good = _snapshot(state)

        t_test = time.perf_counter() - t_1
        tls = train_l2_step / max(train_seen, 1) / steps_per_sample
        tlf = train_l2_full / max(train_seen, 1)
        n_batches = max(len(train_dl), 1)
        writer.text(
            "epoch {}, time {:.5f}, lr {:.2e}, train l2 step {:.5f} train l2 full {:.5f}, "
            "test l2 step {} test l2 full {}, time train avg {:.5f} load avg {:.5f} "
            "test {:.5f}".format(
                ep, time.perf_counter() - t1, state.optimizer.lr_at(state.step), tls, tlf,
                ", ".join(f"{v:.5f}" for v in test_l2_steps),
                ", ".join(f"{v:.5f}" for v in test_l2_fulls),
                t_train / n_batches, t_load / n_batches, t_test,
            )
        )
        history = {"epoch": ep, "train_l2_step": tls, "train_l2_full": tlf,
                   "test_l2_steps": test_l2_steps, "test_l2_fulls": test_l2_fulls}

    writer.close()
    return {"state": state, "model": model, "log_dir": log_dir,
            "step_seconds": step_seconds, "dispatch_steps": dispatch_steps, **history}

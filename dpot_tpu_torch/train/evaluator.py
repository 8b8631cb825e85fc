"""Evaluation harnesses (port of dpot_tpu/train/evaluator.py, the library
form of the reference's evaluate.py and evaluate_varyingres.py).

- evaluate(): a full-trajectory rollout of each test dataset without
  gradients, reporting per-dataset step and full relative L2, the average
  time of one rollout step per sample and, on request, the reference's
  metric battery. 3D sets load through TemporalDataset3D and take a 3D
  model, which returns the prediction only (train/step.py pred_and_cls).
- evaluate_varying_resolution(): the resolution-transfer sweep: inputs and
  predictions are resized in Fourier space between the test resolution and
  the model's at every rollout step, and the mask is refilled at the test
  resolution (reference evaluate_varyingres.py:198-256), resolutions
  arange(32, 128, 9) by default.

The model runs where its parameters are; batches are copied to that device.
Every timed span ends in a read-back of a loss, which waits for the device.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset, TemporalDataset3D
from dpot_tpu_torch.data.registry import get_spec
from dpot_tpu_torch.ops.spectral import resize_temporal
from dpot_tpu_torch.train.step import make_eval_rollout
from dpot_tpu_torch.utils import criterion
from dpot_tpu_torch.utils.criterion import rel_lp_loss

# the default resolutions of the sweep (reference evaluate_varyingres.py)
VARYRES_LIST = tuple(int(r) for r in np.arange(32, 128, 9))


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _test_dataset(path: str, **kw):
    """The test-mode dataset of `path`: TemporalDataset3D for a 3D set (as
    the JAX evaluator picks it), else a one-set MixedTemporalDataset."""
    if get_spec(path).ndim == 3:
        return TemporalDataset3D(path, t_ar=-1, train=False, **kw)
    return MixedTemporalDataset([path], t_ar=-1, train=False, **kw)


def _battery(pred: torch.Tensor, tgt: torch.Tensor, msk: torch.Tensor) -> dict:
    """The reference Evaluator's metrics of one batch, each averaged over the
    channels that the mask keeps (a fully masked channel has a zero target,
    so its relative metrics are 0/0), then over the rest. The boundary and
    spectral metrics follow the field's rank; a band that the grid is too
    small to fill (the band edges 4 and 12 assume res >= 24) is left out."""
    valid = msk.sum(dim=tuple(range(msk.dim() - 1))) > 0  # (C,)
    nvalid = valid.sum().clamp(min=1)

    def vmean(v: torch.Tensor) -> torch.Tensor:
        if v.dim() and v.shape[-1] == valid.shape[0]:
            return (torch.where(valid, v, 0.0).sum(dim=-1) / nvalid).mean()
        return v.mean()

    m = criterion.evaluator_metrics(pred, tgt, temporal=False)
    rank = {4: "1d", 5: "2d", 6: "3d"}[pred.dim()]
    bd = getattr(criterion, f"boundary_rmse_{rank}")(pred, tgt)
    lo, mid, hi = getattr(criterion, f"spectral_band_mse_{rank}")(pred, tgt)
    vals = {"nmae": vmean(m["nmae"]), "nmse": vmean(m["nmse"]),
            "nmxe": vmean(m["nmxe"]), "bdmse": vmean(bd), "fmse_low": vmean(lo)}
    nbin = min(pred.shape[1:-2]) // 2
    if nbin > 4:
        vals["fmse_mid"] = vmean(mid)
    if nbin > 12:
        vals["fmse_high"] = vmean(hi)
    return vals


def evaluate(
    model: torch.nn.Module,
    test_paths: Sequence[str],
    res: int = 128,
    t_in: int = 10,
    t_bundle: int = 1,
    batch_size: int = 8,
    n_channels: int | None = None,
    num_workers: int = 8,
    full_metrics: bool = False,
    viz_dir: str | None = None,
) -> dict:
    """Full-rollout evaluation of `model` on each test dataset; returns
    {path: {"loss_step", "loss_full"[, metric battery]}, "avg_step_time"}.

    avg_step_time is the host time of a batch's rollout over the samples
    and rollout steps of the timed batches. The first batch of each shape
    is not timed (on the card it also builds the kernels), so an evaluation
    with one batch per shape reports 0.0. full_metrics=True adds the
    reference Evaluator's battery (nmae, nmse, nmxe, bdmse, fmse_*),
    averaged over batches. viz_dir: the first sample of each set's first
    batch, prediction and target masked, drawn into that directory
    (utils/viz.py save_eval_viz: 2D, or for a 3D set its mid-Z plane and
    the volume), as the JAX evaluator does."""
    device = _device_of(model)
    roll = make_eval_rollout(t_bundle=t_bundle)
    results: dict = {}
    total_time, total_steps = 0.0, 0
    seen_shapes: set = set()
    for path in test_paths:
        ds = _test_dataset(path, res=res, t_in=t_in, n_channels=n_channels)
        dl = DataLoader(ds, batch_size, shuffle=False, num_workers=num_workers)
        s_sum = f_sum = 0.0
        n_steps_per_traj = 1.0
        extra: dict[str, float] = {}
        n_batches = 0
        for x, y, msk, _ in dl:
            shape_key = (x.shape, y.shape)
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     (("x", x), ("y", y), ("msk", msk))}
            t0 = time.perf_counter()
            out = roll(model, batch)
            f_val = float(out["loss_full"])  # the read-back waits for the device
            dt = time.perf_counter() - t0
            # the per-dataset normalisation divides by one rollout length
            if n_batches and n_steps_per_traj != max(y.shape[-2] / t_bundle, 1):
                raise ValueError(f"{path}: eval batches mix rollout lengths")
            n_steps_per_traj = max(y.shape[-2] / t_bundle, 1)
            if shape_key in seen_shapes:
                total_time += dt
                total_steps += int(x.shape[0] * n_steps_per_traj)
            else:
                seen_shapes.add(shape_key)
            s_sum += float(out["loss_step"])
            f_sum += f_val
            if viz_dir and n_batches == 0:
                from dpot_tpu_torch.train.loop import write_viz

                write_viz(out["pred"][0], y[0], msk[0], None, viz_dir, path)
            n_batches += 1
            if full_metrics:
                with torch.inference_mode():
                    vals = _battery(out["pred"] * batch["msk"], batch["y"] * batch["msk"],
                                    batch["msk"])
                for k, v in vals.items():
                    extra[k] = extra.get(k, 0.0) + float(v)
        results[path] = {"loss_step": s_sum / len(ds) / n_steps_per_traj,
                         "loss_full": f_sum / len(ds)}
        if full_metrics and n_batches:
            results[path].update({k: v / n_batches for k, v in extra.items()})
    results["avg_step_time"] = total_time / max(total_steps, 1)
    return results


def refill_mask(msk: torch.Tensor, res: int) -> torch.Tensor:
    """The mask rebuilt at resolution `res`: channels with any mask weight
    become all ones, the others all zeros (evaluate_varyingres.py:198-201).
    msk (B, X, Y, 1, C) -> (B, res, res, 1, C)."""
    nonzero = (msk.sum(dim=(1, 2, 3)) > 0)[:, None, None, None, :]
    return nonzero.to(msk.dtype).expand(msk.shape[0], res, res, 1, msk.shape[-1]).contiguous()


def make_varyres_rollout(model_res: int) -> Callable:
    """One step of the sweep, `(model, x, res) -> prediction at res`: x
    resized to the model's resolution, one model application, the
    prediction resized back, without gradients."""

    def step(model: torch.nn.Module, x: torch.Tensor, res: int) -> torch.Tensor:
        with torch.inference_mode():
            im, _ = model(resize_temporal(x, (model_res, model_res)))
            return resize_temporal(im, (res, res))

    return step


def evaluate_varying_resolution(
    model: torch.nn.Module,
    test_paths: Sequence[str],
    model_res: int = 128,
    t_in: int = 10,
    t_bundle: int = 1,
    batch_size: int = 8,
    n_channels: int | None = None,
    res_list: Sequence[int] | None = None,
    num_workers: int = 8,
) -> dict:
    """Resolution-transfer sweep: {res: {path: {"loss_full", "loss_step"}}}.
    Each test set is loaded at the model's resolution, resized to `res` in
    Fourier space, and rolled out with make_varyres_rollout, the mask
    refilled at `res` (evaluate_varyingres.py:213-256). 2D sets only."""
    for path in test_paths:
        if get_spec(path).ndim != 2:
            raise ValueError(f"{path} is a {get_spec(path).ndim}D dataset: the "
                             "resolution sweep resizes 2D fields only")
    res_list = [int(r) for r in (res_list if res_list is not None else VARYRES_LIST)]
    device = _device_of(model)
    model.eval()
    step = make_varyres_rollout(model_res)
    out: dict = {}
    for res in res_list:
        per_ds = {}
        for path in test_paths:
            ds = MixedTemporalDataset([path], res=model_res, t_in=t_in, t_ar=-1,
                                      n_channels=n_channels, train=False)
            dl = DataLoader(ds, batch_size, shuffle=False, num_workers=num_workers)
            f_sum = s_sum = 0.0
            t_test = 1
            for x, y, msk, _ in dl:
                with torch.inference_mode():
                    x = resize_temporal(torch.from_numpy(x).to(device), (res, res))
                    y = resize_temporal(torch.from_numpy(y).to(device), (res, res))
                    m = refill_mask(torch.from_numpy(msk).to(device), res)
                    t_test = y.shape[-2]
                    preds = []
                    loss = 0.0
                    for t in range(0, t_test, t_bundle):
                        im = step(model, x, res)
                        sl = y[..., t:t + t_bundle, :]
                        loss = loss + rel_lp_loss(im[..., :sl.shape[-2], :], sl, m)
                        preds.append(im)
                        x = torch.cat([x[..., t_bundle:, :], im.to(x.dtype)], dim=-2)
                    pred = torch.cat(preds, dim=-2)[..., :t_test, :]
                    f_sum += float(rel_lp_loss(pred, y, m))
                    s_sum += float(loss)
            per_ds[path] = {"loss_full": f_sum / len(ds),
                            "loss_step": s_sum / len(ds) / max(t_test / t_bundle, 1)}
        out[res] = per_ds
    return out

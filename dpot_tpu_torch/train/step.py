"""Train and eval steps with autoregressive rollout (port of
dpot_tpu/train/step.py).

Semantics of the reference train loop, as the JAX package pins them:
- per AR step: noise injection x += noise_scale * ||x||_(space, time) * eps,
  per sample and channel; model forward; masked relative L2 summed over the
  rollout steps; the prediction fed back by sliding the time window;
- backward through the whole unrolled rollout;
- global-norm clip, optimizer and per-iteration schedule (train/optimizers);
- the classifier's cross-entropy computed for the metrics but not trained.

The step runs eagerly: `loss.backward()` fills the parameters' .grad and
the optimizer updates them in place. Nothing in it reads a value back to
the host; the metrics come back as device tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.utils.criterion import cross_entropy_sum, rel_lp_loss

Batch = dict[str, torch.Tensor]


def make_train_step(
    t_bundle: int = 1,
    noise_scale: float = 0.0,
    time_major: bool = False,
    ones_mask: bool = False,
    grad_accum: int = 1,
    scan_steps: int = 1,
) -> Callable[[TrainState, Batch], tuple[TrainState, dict]]:
    """Build a train step `(state, batch) -> (state, aux)`; the state is
    updated in place and returned.

    batch: x (B, H, W, T_in, C), y (B, H, W, T_ar, C), msk (B, H, W, 1, C)
    and cls (B,), on the model's device. Options, as in the JAX package:
    - batch["noise"], optional: the standard-normal draws (n_steps, *x.shape)
      to use instead of the state's generator, so that a test can share the
      noise with the JAX step;
    - time_major: x (B, T_in, spatial..., C) and y (B, T_ar, spatial..., C),
      moved to the standard layout here;
    - ones_mask: the train masks are all ones, the batch has no msk and the
      loss runs unmasked (the same result);
    - grad_accum=N: N microbatches, their gradients summed before one
      update (the loss is a batch sum, so the update equals the full-batch
      one; each microbatch draws its own noise).
    aux: loss_step, loss_full, cls_loss, cls_correct, n_steps, grad_norm."""
    if scan_steps > 1:
        raise NotImplementedError(
            "scan_steps > 1 (several optimizer steps in one dispatch) is CUDA-graph "
            "capture on the card, not ported yet (ROADMAP, 'Modules to port', item 6)"
        )

    def loss_fn(model, batch: Batch, gen: torch.Generator):
        x, y, cls = batch["x"], batch["y"], batch["cls"]
        msk = None if ones_mask else batch["msk"]
        ext_noise = batch.get("noise")
        if time_major:
            x = x.movedim(1, -2)
            y = y.movedim(1, -2)
        n_steps = max(y.shape[-2] // t_bundle, 1)
        loss = 0.0
        preds = []
        cls_loss = torch.zeros((), device=x.device)
        cls_correct = torch.zeros((), device=x.device)
        for s in range(n_steps):
            y_s = y[..., s * t_bundle:(s + 1) * t_bundle, :]
            if noise_scale > 0.0:
                norm_axes = tuple(range(1, x.dim() - 1))
                xnorm = x.square().sum(dim=norm_axes, keepdim=True).sqrt()
                if ext_noise is not None:
                    eps = ext_noise[s].to(x.dtype)
                else:
                    eps = torch.randn(x.shape, generator=gen, device=x.device,
                                      dtype=x.dtype)
                x = x + noise_scale * xnorm * eps
            im, cls_pred = model(x)
            loss = loss + rel_lp_loss(im, y_s, msk)
            with torch.no_grad():
                cls_loss += cross_entropy_sum(cls_pred, cls)
                cls_correct += (cls_pred.argmax(dim=-1) == cls).sum()
            preds.append(im)
            x = torch.cat([x[..., t_bundle:, :], im.to(torch.result_type(x, im))], dim=-2)
        with torch.no_grad():
            pred_full = torch.cat(preds, dim=-2)
            loss_full = rel_lp_loss(pred_full, y[..., : pred_full.shape[-2], :], msk)
        aux = {"loss_step": loss.detach(), "loss_full": loss_full,
               "cls_loss": cls_loss, "cls_correct": cls_correct}
        return loss, aux, n_steps

    def train_step(state: TrainState, batch: Batch) -> tuple[TrainState, dict]:
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        B = batch["x"].shape[0]
        if grad_accum > 1:
            if B % grad_accum:
                raise ValueError(f"batch {B} must divide into grad_accum={grad_accum} "
                                 "microbatches")
            if "noise" in batch:
                raise ValueError("external noise draws do not split into microbatches")
            mb = B // grad_accum
            micro = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                     for i in range(grad_accum)]
        else:
            micro = [batch]
        aux = None
        for b in micro:
            loss, a, n_steps = loss_fn(model, b, state.generator)
            loss.backward()
            aux = a if aux is None else {k: aux[k] + a[k] for k in aux}
        state.apply_gradients()
        aux["n_steps"] = torch.tensor(float(n_steps))
        aux["grad_norm"] = state.optimizer.grad_norm
        return state, aux

    return train_step


def make_eval_rollout(t_bundle: int = 1) -> Callable[[torch.nn.Module, Batch], dict]:
    """Build a full-trajectory rollout evaluator `(model, batch) -> dict` run
    under `torch.inference_mode()`: ceil(t_test / t_bundle) model
    applications, the prediction trimmed to t_test frames; returns the
    summed per-step loss, the full-trajectory loss and the prediction
    (B, H, W, t_test, C)."""

    def eval_rollout(model: torch.nn.Module, batch: Batch) -> dict:
        x, y, msk = batch["x"], batch["y"], batch["msk"]
        t_test = y.shape[-2]
        n_steps = (t_test + t_bundle - 1) // t_bundle
        model.eval()
        ims = []
        with torch.inference_mode():
            for _ in range(n_steps):
                im, _ = model(x)
                if im.shape[-2] != t_bundle:
                    raise ValueError(
                        f"eval rollout t_bundle={t_bundle} but the model emits "
                        f"{im.shape[-2]} frames per application (out_timesteps)"
                    )
                ims.append(im)
                x = torch.cat([x[..., t_bundle:, :], im.to(x.dtype)], dim=-2)
            pred = torch.cat(ims, dim=-2)[..., :t_test, :]
            step_loss = 0.0
            for s in range(n_steps):
                sl = slice(s * t_bundle, min((s + 1) * t_bundle, t_test))
                step_loss = step_loss + rel_lp_loss(pred[..., sl, :], y[..., sl, :], msk)
            full_loss = rel_lp_loss(pred, y, msk)
        return {"loss_step": step_loss, "loss_full": full_loss, "pred": pred}

    return eval_rollout

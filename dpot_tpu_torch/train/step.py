"""Train and eval steps with autoregressive rollout (port of
dpot_tpu/train/step.py).

Semantics of the reference train loop, as the JAX package pins them:
- per AR step: noise injection x += noise_scale * ||x||_(space, time) * eps,
  per sample and channel; model forward; masked relative L2 summed over the
  rollout steps; the prediction fed back by sliding the time window;
- backward through the whole unrolled rollout;
- global-norm clip, optimizer and per-iteration schedule (train/optimizers);
- the classifier's cross-entropy computed for the metrics but not trained.

A step runs eagerly: `loss.backward()` fills the parameters' .grad and
the optimizer updates them in place. Nothing in it reads a value back to
the host; the metrics come back as device tensors.

One dispatch, the counterpart of JAX's jitted `lax.scan`: on the card,
`make_train_step(scan_steps=K)` runs K steps as one CUDA graph and the
eval rollout runs as one graph per batch shape (ops/cuda/graphs.py). The
first call of a shape runs eagerly, as the warm-up that fills the caches
a capture may not fill, and its results are the call's; the capture
follows, and later calls copy their inputs into the graph's buffers and
replay it. On the CPU both are the same eager code.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dpot_tpu_torch.ops.cuda.graphs import Graph, GraphCache, copy_into, side_stream, signature
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.utils.criterion import cross_entropy_sum, rel_lp_loss

Batch = dict[str, torch.Tensor]


def _add_f32(acc: Optional[list], grads: list) -> list:
    """acc + grads, elementwise in f32 (None counts as zero)."""
    if acc is None:
        return [None if g is None else g.float() for g in grads]
    return [a if g is None else g.float() if a is None else a.add_(g)
            for a, g in zip(acc, grads)]


def pred_and_cls(model: torch.nn.Module, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """model(x) as the steps' (prediction, class logits) pair. A pred-only
    model (DPOTNet3D) returns the prediction alone; it gets zero logits of
    one class, as JAX's wrap_pred_only(n_cls=1) gives them."""
    out = model(x)
    if isinstance(out, torch.Tensor):
        return out, out.new_zeros((x.shape[0], 1), dtype=torch.float32)
    return out


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

    batch: x (B, spatial..., T_in, C), y (B, spatial..., T_ar, C), msk
    (B, spatial..., 1, C) and cls (B,), on the model's device; a 2D model
    returns (prediction, class logits), a pred-only 3D one the prediction
    (`pred_and_cls`). Options, as in the JAX package:
    - batch["noise"], optional: the standard-normal draws (n_steps, *x.shape)
      to use instead of the state's generator, so that a test can share the
      noise with the JAX step;
    - time_major: x (B, T_in, spatial..., C) and y (B, T_ar, spatial..., C),
      moved to the standard layout here;
    - ones_mask: the train masks are all ones, the batch has no msk and the
      loss runs unmasked (the same result);
    - grad_accum=N: N microbatches, their gradients summed before one
      update (the loss is a batch sum, so the update equals the full-batch
      one; each microbatch draws its own noise); with a bf16 working copy
      of the parameters (train/state.py) the sum is taken in f32;
    - scan_steps=K: K optimizer steps in one call (`KStepDispatch`): every
      batch leaf (external noise included) carries a leading (K,) axis,
      every aux leaf comes back stacked (K,), and the trajectory is that
      of K sequential calls.
    aux: loss_step, loss_full, cls_loss, cls_correct, n_steps, grad_norm."""
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")

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
            im, cls_pred = pred_and_cls(model, x)
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

    def train_step(state: TrainState, batch: Batch,
                   values: Optional[torch.Tensor] = None) -> tuple[TrainState, dict]:
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
        # the microbatch gradients of a bf16 working copy are summed in f32,
        # not by backward() into its bf16 .grad, which would round each add
        lp = state.params_lp if len(micro) > 1 else None
        aux = gsum = None
        for b in micro:
            loss, a, n_steps = loss_fn(model, b, state.generator)
            loss.backward()
            aux = a if aux is None else {k: aux[k] + a[k] for k in aux}
            if lp is not None:
                gsum = _add_f32(gsum, [p.grad for p in lp])
                model.zero_grad(set_to_none=True)
        state.apply_gradients(gsum, values)
        aux["n_steps"] = torch.tensor(float(n_steps))
        aux["grad_norm"] = state.optimizer.grad_norm
        return state, aux

    return train_step if scan_steps == 1 else KStepDispatch(train_step, scan_steps)


class KStepDispatch:
    """K train steps in one call `(state, batches) -> (state, aux)`.

    On the CPU: K eager steps. On the card: one CUDA graph of all K steps
    per (state, batch shapes), replayed once a call. The first call of a
    shape runs the K steps eagerly on a side stream (the capture's warm-up;
    they are the call's steps) and then captures; the capture's host-side
    effects (the step count, the optimizer's count and grad_norm) are
    undone, and each replay advances them by K. The graph reads the K rows
    of the optimizer's per-step scalars from a device buffer, refilled from
    the host schedules before every replay, and the state's generator is
    registered with it, so that a replay computes and draws what K eager
    steps would."""

    def __init__(self, step: Callable, steps: int):
        self.step = step
        self.steps = steps
        # (id(state), batch signature) -> (state, static batch, values, graph)
        self._graphs: dict = {}

    def _run(self, state: TrainState, batches: Batch, values: torch.Tensor) -> dict:
        auxes = [self.step(state, {k: v[i] for k, v in batches.items()}, values[i])[1]
                 for i in range(self.steps)]
        return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}

    def __call__(self, state: TrainState, batches: Batch) -> tuple[TrainState, dict]:
        K = self.steps
        for k, v in batches.items():
            if v.shape[0] != K:
                raise ValueError(f"batch leaf {k!r} has leading axis {v.shape[0]}, "
                                 f"not scan_steps={K}")
        opt = state.optimizer
        values = opt.values_at(range(opt.count, opt.count + K))
        if batches["x"].device.type != "cuda":
            return state, self._run(state, batches, values)
        key = (id(state), signature(batches))
        entry = self._graphs.get(key)
        if entry is None:
            with side_stream():
                aux = self._run(state, batches, values)
            self._graphs[key] = self._capture(state, batches, values)
            return state, aux
        _, static, static_values, graph = entry
        copy_into(static, batches)
        static_values.copy_(values)
        aux = {k: v.clone() for k, v in graph.replay().items()}
        state.step += K
        opt.count += K
        opt.grad_norm = aux["grad_norm"][-1]
        return state, aux

    def _capture(self, state: TrainState, batches: Batch, values: torch.Tensor) -> tuple:
        static = {k: v.clone() for k, v in batches.items()}
        static_values = torch.empty_like(values)
        opt = state.optimizer
        host = (state.step, opt.count, opt.grad_norm)
        try:
            graph = Graph(lambda: self._run(state, static, static_values),
                          generators=[state.generator], mutated=state.mutated())
        finally:
            state.step, opt.count, opt.grad_norm = host
        return state, static, static_values, graph


def make_eval_rollout(t_bundle: int = 1) -> "EvalRollout":
    """Build a full-trajectory rollout evaluator `(model, batch) -> dict` run
    under `torch.inference_mode()`: ceil(t_test / t_bundle) model
    applications, the prediction trimmed to t_test frames; returns the
    summed per-step loss, the full-trajectory loss and the prediction
    (B, H, W, t_test, C)."""
    return EvalRollout(t_bundle)


class EvalRollout:
    """The eval rollout of `make_eval_rollout`. On the card, one CUDA graph
    per (model, shapes and dtypes of x, y and msk), captured after the
    eager first call of that shape, which is the call's answer
    (ops/cuda/graphs.py `GraphCache`); the graphs read the model's weights
    as they are at each replay, and a replay's outputs are copied out of
    the graph before they are returned."""

    def __init__(self, t_bundle: int = 1):
        self.t_bundle = t_bundle
        self.graphs = GraphCache()

    def run(self, model: torch.nn.Module, batch: Batch) -> dict:
        """The rollout, eagerly."""
        t_bundle = self.t_bundle
        x, y, msk = batch["x"], batch["y"], batch["msk"]
        t_test = y.shape[-2]
        n_steps = (t_test + t_bundle - 1) // t_bundle
        model.eval()
        ims = []
        with torch.inference_mode():
            for _ in range(n_steps):
                im, _ = pred_and_cls(model, x)
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

    @torch.inference_mode()
    def __call__(self, model: torch.nn.Module, batch: Batch) -> dict:
        if batch["x"].device.type != "cuda":
            return self.run(model, batch)
        out = self.graphs(lambda b: self.run(model, b), batch, key=(model,))
        return {k: v.clone() for k, v in out.items()}

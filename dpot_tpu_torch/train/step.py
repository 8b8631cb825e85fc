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

Over several ranks (parallel/: DDP, or FSDP2) each rank holds its
contiguous rows of the global batch and the step computes what one
process computes on the whole of it: the noise is drawn for the global
batch from the state's generator (the same stream on every rank) and each
rank adds its rows; the loss, a sum over the samples, is scaled by the
world size for the backward, so that DDP's and FSDP2's averaging of the
gradients over the ranks gives the global sum; the metric sums are
all-reduced. A batch that every rank holds whole (`replicated`, an epoch's
tail that does not divide over the ranks) runs as in one process, its
gradients averaged over identical copies. Over a mesh with more axes
(parallel/mesh.py) the rows are split over its 'data' axis only (the
state's `rank` and `world`), the metric sums are all-reduced over the
'data' group, and the layouts that run without DDP's wrapper (tensor,
pipeline and spatial parallelism) average the gradients over the state's
`grad_group` after the backward. Under 'spatial' each rank holds its rows
of the grid: the noise's norm and the loss sum over the axis, and its
noise is its rows of the global draw.

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
import torch.distributed as dist

import contextlib

from dpot_tpu_torch.models.unet import batch_norms, local_batch_stats
from dpot_tpu_torch.ops.cuda.graphs import Graph, GraphCache, copy_into, side_stream, signature
from dpot_tpu_torch.parallel.mesh import Axis, all_gather_dim, all_reduce_mean, all_sum, grad_sync
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.utils.criterion import cross_entropy_sum, rel_lp_loss

Batch = dict[str, torch.Tensor]

# the parameters that the loss does not reach: the class head, whose
# cross-entropy is computed for the metrics but not trained. They get no
# gradient (the optimizer counts it as zero), and DDP leaves them out of
# its reducer (parallel/mesh.py replicate)
UNTRAINED = ("cls_head.",)

# the aux entries that are sums over the batch's samples
SUMS = ("loss_step", "loss_full", "cls_loss", "cls_correct")


def _add_f32(acc: Optional[list], grads: list) -> list:
    """acc + grads, elementwise in f32 (None counts as zero)."""
    if acc is None:
        return [None if g is None else g.float() for g in grads]
    return [a if g is None else g.float() if a is None else a.add_(g)
            for a, g in zip(acc, grads)]


def regroup_micro(batch: Batch, n: int, state: TrainState) -> Batch:
    """This rank's rows of a global batch (its contiguous slice on each
    rank) regrouped so that its i-th microbatch is its slice of the global
    batch's i-th, as JAX splits the global batch (dpot_tpu/train/step.py
    `_accum_grads`): the batch all-gathered over 'data' (external noise
    along its axis 1), then each microbatch's rows taken. Needed where the
    microbatches' composition matters: BatchNorm statistics over ranks."""
    axis = Axis(state.data_group, state.world, state.rank)
    out = {}
    for k, v in batch.items():
        d = 1 if k == "noise" else 0
        full = all_gather_dim(v.contiguous(), d, axis)
        MB = full.shape[d] // n
        mb = MB // state.world
        out[k] = torch.cat([full.narrow(d, i * MB + state.rank * mb, mb) for i in range(n)], d)
    return out


def grad_groups(state: TrainState) -> tuple:
    """The groups over which the step averages the gradients after the
    backward (the state's `grad_group`: one group, several, or None)."""
    g = state.grad_group
    return () if g is None else tuple(g) if isinstance(g, (tuple, list)) else (g,)


def spatial_axis(state: TrainState):
    """The 'spatial' axis that the state's model is split over, else None."""
    return getattr(state.model, "spatial", None)


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

    def loss_fn(model, batch: Batch, gen: torch.Generator, axis=None):
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
                xsq = x.square().sum(dim=norm_axes, keepdim=True)
                xnorm = (xsq if axis is None else all_sum(xsq, axis)).sqrt()
                if ext_noise is not None:
                    eps = ext_noise[s].to(x.dtype)
                else:
                    eps = torch.randn(x.shape, generator=gen, device=x.device,
                                      dtype=x.dtype)
                x = x + noise_scale * xnorm * eps
            im, cls_pred = pred_and_cls(model, x)
            loss = loss + rel_lp_loss(im, y_s, msk, axis=axis)
            with torch.no_grad():
                cls_loss += cross_entropy_sum(cls_pred, cls)
                cls_correct += (cls_pred.argmax(dim=-1) == cls).sum()
            preds.append(im)
            x = torch.cat([x[..., t_bundle:, :], im.to(torch.result_type(x, im))], dim=-2)
        with torch.no_grad():
            pred_full = torch.cat(preds, dim=-2)
            loss_full = rel_lp_loss(pred_full, y[..., : pred_full.shape[-2], :], msk,
                                    axis=axis)
        aux = {"loss_step": loss.detach(), "loss_full": loss_full,
               "cls_loss": cls_loss, "cls_correct": cls_correct}
        return loss, aux, n_steps

    def split(batch: Batch, n: int) -> list[Batch]:
        """n microbatches of equal rows; external noise (steps, B, ...) is
        split along its batch axis."""
        mb = batch["x"].shape[0] // n
        return [{k: v[:, i * mb:(i + 1) * mb] if k == "noise" else v[i * mb:(i + 1) * mb]
                 for k, v in batch.items()} for i in range(n)]

    def global_noise(state: TrainState, batch: Batch) -> torch.Tensor:
        """This rank's rows of the noise that one process draws for the
        global batch: per microbatch of the global batch, per rollout step,
        one draw from the state's generator, in the single process's order
        and in the dtype x has at that step in loss_fn: x's own at the
        first, and from the second on x's promoted with the prediction's,
        which is float32 for every model family (models/). The steps are
        stacked in the widest of these, which holds each draw exactly."""
        x = batch["x"]
        if time_major:
            x = x.movedim(1, -2)
        y_t = batch["y"].shape[1 if time_major else -2]
        n_steps = max(y_t // t_bundle, 1)
        dtypes = [x.dtype] + [torch.promote_types(x.dtype, torch.float32)] * (n_steps - 1)
        B, world = x.shape[0], state.world
        n_micro = grad_accum if B * world % grad_accum == 0 else 1
        mb = B * world // n_micro
        sp = spatial_axis(state)
        shape = list(x.shape[1:])
        if sp is not None:  # the whole grid's draw, then this rank's rows
            shape[0] *= sp.size
        draws = [[torch.randn((mb, *shape), generator=state.generator,
                              device=x.device, dtype=dt) for dt in dtypes]
                 for _ in range(n_micro)]
        full = torch.stack([torch.cat([d[s] for d in draws]).to(dtypes[-1])
                            for s in range(n_steps)])
        full = full[:, state.rank * B:(state.rank + 1) * B]
        if sp is not None:
            rows = x.shape[1]
            full = full[:, :, sp.rank * rows:(sp.rank + 1) * rows]
        return full

    def train_step(state: TrainState, batch: Batch, values: Optional[torch.Tensor] = None,
                   replicated: bool = False) -> tuple[TrainState, dict]:
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        fwd = state.forward_module
        B = batch["x"].shape[0]
        # this rank holds its rows of a global batch
        sharded = state.world > 1 and not replicated
        if grad_accum > 1 and "noise" in batch:
            raise ValueError("external noise draws do not split into microbatches")
        if ((sharded or spatial_axis(state) is not None) and noise_scale > 0.0
                and "noise" not in batch):
            batch = {**batch, "noise": global_noise(state, batch)}
        synced_stats = any(bn.axis is not None for bn in batch_norms(model))
        if grad_accum > 1 and B % grad_accum == 0:
            if sharded and synced_stats:
                batch = regroup_micro(batch, grad_accum, state)
            micro = split(batch, grad_accum)
        elif grad_accum > 1 and not sharded:
            raise ValueError(f"batch {B} must divide into grad_accum={grad_accum} "
                             "microbatches")
        else:
            micro = [batch]
        # the microbatch gradients of a bf16 working copy are summed in f32,
        # not by backward() into its bf16 .grad, which would round each add;
        # over several ranks the sum is then averaged over them here (under
        # FSDP2, whose sharded gradients exist only after its reduce-scatter,
        # each microbatch's is reduced first and then summed)
        lp = state.params_lp if len(micro) > 1 else None
        scale = state.world if sharded else 1
        aux = gsum = None
        # a batch that every rank holds whole takes its own BatchNorm statistics
        stats = (local_batch_stats(model) if synced_stats and not sharded
                 else contextlib.nullcontext())
        sync_each = lp is not None and state.sharded
        with stats:
            for i, b in enumerate(micro):
                with grad_sync(fwd, sync_each or (lp is None and i == len(micro) - 1)):
                    loss, a, n_steps = loss_fn(fwd, b, state.generator, spatial_axis(state))
                    (loss * scale if scale > 1 else loss).backward()
                aux = a if aux is None else {k: aux[k] + a[k] for k in aux}
                if lp is not None:
                    gsum = _add_f32(gsum, [p.grad for p in lp])
                    model.zero_grad(set_to_none=True)
        groups = grad_groups(state)
        if gsum is not None and not groups and state.world > 1 and not state.sharded:
            groups = (state.data_group,)  # DDP's sync was off for the microbatches
        for group in groups:
            # the same parameters on every rank of the group, whose gradients
            # are None alike (the untrained class head); the mean over each
            # group in turn is the mean over their product
            all_reduce_mean([g for g in (gsum or [p.grad for p in model.parameters()])
                             if g is not None], group)
        if sharded:
            sums = torch.stack([aux[k].float() for k in SUMS])
            dist.all_reduce(sums, group=state.data_group)
            aux.update(zip(SUMS, sums.unbind()))
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
            axis = getattr(model, "spatial", None)
            step_loss = 0.0
            for s in range(n_steps):
                sl = slice(s * t_bundle, min((s + 1) * t_bundle, t_test))
                step_loss = step_loss + rel_lp_loss(pred[..., sl, :], y[..., sl, :], msk,
                                                    axis=axis)
            full_loss = rel_lp_loss(pred, y, msk, axis=axis)
        return {"loss_step": step_loss, "loss_full": full_loss, "pred": pred}

    @torch.inference_mode()
    def __call__(self, model: torch.nn.Module, batch: Batch) -> dict:
        if batch["x"].device.type != "cuda":
            return self.run(model, batch)
        out = self.graphs(lambda b: self.run(model, b), batch, key=(model,))
        return {k: v.clone() for k, v in out.items()}

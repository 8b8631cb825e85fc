"""The pretraining loop on one device (port of dpot_tpu/train/loop.py).

`train(cfg)` drives: dataset mixture -> train step (AR rollout, noise
injection, optimizer) -> per-dataset eval rollouts -> epoch logging under
the reference's scalar names -> checkpoints -> loss-explosion rollback.

The loss of step i is read back only after step i + 1 has been queued
(one-step-lagged fetch), so the host never waits for the device inside a
step. Train batches are assembled in the loader's ring of pinned slots
(`loader_slot_ring`, 2 by default), already in the wire dtype, and cross
to the device asynchronously; the loader refills a slot only after a CUDA
event recorded behind its copy (data/loader.py). With
`steps_per_dispatch=K` the loader hands out K * B samples at a time, which
go to the device as (K, B, ...) and run as one K-step dispatch (a CUDA
graph on the card, train/step.py); a tail that cannot fill a dispatch runs
as B-sized single steps, so an epoch takes the samples and optimizer steps
of K = 1. Every option of the JAX loop is ported; none is ignored.

Checkpoints: with `async_ckpt` (the default, as in JAX) rank 0 hands each
write to a worker thread (train/checkpoint.py AsyncCheckpointWriter): the
state's CPU copies, and under a sharded layout the gather over the ranks,
are taken synchronously, `torch.save` and the rename into place run on
the thread while the next epoch trains, and `train()` waits for the last
write before it returns (and when it raises).

Rollback snapshots (`rollback_factor`): copies of the parameters, moments
and buffers on the device, or pinned host copies when a device copy of
this rank's local bytes would take the state past 80 % of the card's
memory (`snapshot_mode`, as JAX's _choose_snapshot_fn;
DPOT_SNAPSHOT_MODE=device|host overrides it). A host snapshot is a
non_blocking copy on the current stream, so it is ordered before the next
step's in-place update, and a restore copies it back the same way; neither
is ever captured in a K-step graph (the loop takes them between
dispatches).

`viz_dir`: in the final epoch, rank 0 writes the first sample of each test
set's first batch, prediction and target masked (utils/viz.py
save_eval_viz; a split grid gathered over 'spatial' first).

Under torchrun (parallel/multihost.py) the loop runs on every rank over the
mesh of the config's mesh_* axes (parallel/mesh.py): each rank loads the
contiguous slice of every global batch that its 'data' coordinate selects
(an uneven tail whole), and where the model splits the grid over
'spatial' keeps its H rows of it. The parameters are placed after init or
restore, as in the JAX loop (`place_state`): replicated under DDP
(`shard_params: replicate`), sharded by FSDP2 (`fsdp`), cut into
tensor-parallel shards over 'model' (`tp`, with FSDP2 over 'data' in
`tp_fsdp`), cut to a pipeline stage's blocks (`mesh_pipe`), or these
combined; under 'spatial' the model itself splits the grid, and a model
that no layout reaches (FNO, UNet) is computed alike by the ranks of the
other axes, its BatchNorm statistics taken over 'data'. Every rank
computes, and logs, what one process computes on the same global batches:
the train and eval sums are all-reduced over 'data', so the rollback
decides on the same loss everywhere, and evaluation runs the same
distributed forward on every rank. Under any axis but 'data' the forward
holds collectives, which run on the host under gloo and which a CUDA graph
cannot hold, so the eval rollout runs eagerly. Rank 0 alone writes logs
and checkpoints; where the state is sharded every rank takes part in
gathering the state that it writes.

The log directory is the JAX loop's timestamped name, or, when a run of
the same second took it already, that name with the first free suffix
_1, _2, ... (`unique_log_dir`), so that two runs never share one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.parallel import make_mesh, maybe_initialize, rank_world, replicate, shard_rows
from dpot_tpu_torch.parallel.mesh import check_mesh_data
from dpot_tpu_torch.parallel.pipeline import shard_state_pipe
from dpot_tpu_torch.parallel.tensor import shard_state_tp
from dpot_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.schedules import build_schedule, onecycle_momentum
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import UNTRAINED, make_eval_rollout, make_train_step
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


def check_ported(cfg: TrainConfig, world: int = 1) -> None:
    """Raise for the combinations the JAX loop refuses and mesh axes whose
    product is not the world size (ValueError), for FSDP without a process
    group (RuntimeError), over `world` ranks."""
    if cfg.steps_per_dispatch > 1 and world > 1:
        raise ValueError("steps_per_dispatch > 1 is single-process only (the batches of "
                         "a multi-process run are assembled a step at a time, and a CUDA "
                         "graph cannot hold gloo's collectives, which run on the host)")
    if cfg.steps_per_dispatch > 1 and cfg.mesh_spatial > 1:
        raise ValueError("steps_per_dispatch does not compose with spatial sharding "
                         "(mesh_spatial)")
    if cfg.mesh_pipe > 1 and cfg.mesh_spatial > 1:
        raise ValueError("pipeline and spatial sharding cannot combine (mesh_pipe, "
                         "mesh_spatial), as in the JAX package")
    check_mesh_data(cfg.mesh_data, world, cfg.mesh_spatial * cfg.mesh_model * cfg.mesh_pipe)
    family = cfg.model.upper()
    if family in ("DPOT3D", "CDPOT") and (cfg.mesh_spatial > 1 or cfg.mesh_pipe > 1):
        # JAX's DPOTNet3D and CDPOTNet take no spatial_mesh or pipe_mesh
        # (dpot_tpu/models/dpot3d.py, cdpot.py; its loop passes them,
        # dpot_tpu/train/loop.py:160-168, and the model's construction raises
        # TypeError): there is no 3D pencil FFT and no pipelined CDPOT trunk
        raise ValueError(f"{cfg.model} takes no spatial or pipeline sharding (mesh_spatial, "
                         "mesh_pipe), as in the JAX package, whose model has no such mesh")
    if cfg.shard_params == "fsdp" and not dist.is_initialized():
        raise RuntimeError("shard_params=fsdp needs the default process group: launch "
                           "under torchrun (one rank per card, --nproc_per_node 1 for one)")


def _rollback_tensors(state: TrainState) -> tuple[torch.Tensor, ...]:
    """What a rollback restores: the parameters (the f32 master where the
    model runs a working copy), the moments and the model's buffers (UNet's
    BatchNorm statistics, which JAX keeps among its params)."""
    opt = state.optimizer
    return (*opt.params, *opt.mu, *opt.nu, *state.model.buffers())


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view), any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _snapshot(state: TrainState) -> list[torch.Tensor]:
    """Device copies of the rollback's tensors."""
    return [t.detach().clone() for t in _rollback_tensors(state)]


def _host_snapshot(state: TrainState) -> list[torch.Tensor]:
    """Host copies of this rank's rollback tensors (local shards), pinned
    where they come from the card, each a non_blocking copy on the
    current stream: the next step's in-place update is queued behind it."""
    out = []
    for t in _rollback_tensors(state):
        t = _local(t).detach()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        out.append(h.copy_(t, non_blocking=True))
    return out


@torch.no_grad()
def _restore(state: TrainState, snap: list[torch.Tensor]) -> None:
    """Copy a snapshot (device or host) back into the live tensors, on the
    current stream."""
    for dst, src in zip(_rollback_tensors(state), snap):
        _local(dst).copy_(_local(src), non_blocking=True)
    state.refresh_working_copy()


def _memory_limit(device: torch.device) -> Optional[int]:
    """The card's memory in bytes; None for a CPU, which has no limit (as
    JAX's CPU backend reports none)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def snapshot_mode(state: TrainState) -> tuple[str, int, Optional[int]]:
    """('device' or 'host', this rank's bytes of the rollback's tensors,
    the card's memory or None): host when two copies of those bytes (the
    state and its snapshot) would exceed 80 % of the card's memory, as JAX's
    _choose_snapshot_fn rules (dpot_tpu/train/loop.py:58-85); the bytes
    count FSDP2's and tensor parallelism's local shards.
    DPOT_SNAPSHOT_MODE=device|host overrides the rule."""
    per_dev = sum(_local(t).numel() * t.element_size() for t in _rollback_tensors(state))
    limit = _memory_limit(next(state.model.parameters()).device)
    mode = os.environ.get("DPOT_SNAPSHOT_MODE", "")
    if mode not in ("device", "host"):
        mode = "host" if limit and 2 * per_dev > 0.8 * limit else "device"
    return mode, per_dev, limit


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host batch column (numpy, or a loader's torch.bfloat16 tensor) on
    `device`, converted to `dtype` where it is not in it yet. On the card it
    crosses asynchronously from pinned memory: a pinned ring slot as it is,
    anything else through a pinned copy."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def loader_arch(cfg: TrainConfig) -> tuple[int, int]:
    """(prefetch, slot_ring) of the train loader, the config's -1 resolved
    as in the JAX loop: inline on a one-worker host, 8 batches ahead
    otherwise; a ring of 2 slot sets beyond those in flight."""
    prefetch = cfg.loader_prefetch
    if prefetch < 0:
        prefetch = 0 if cfg.num_workers <= 1 else 8
    ring = cfg.loader_slot_ring
    return prefetch, 2 if ring < 0 else ring


def build_everything(cfg: TrainConfig, device: str | torch.device = "cuda"):
    """Datasets, loaders (this rank's shards of them), model, schedule and
    the train state at step 0, the mesh on the state (None in one process
    without a process group)."""
    rank, world = rank_world()
    check_ported(cfg, world)
    device = resolve_device(device)
    mesh = None
    if dist.is_initialized():
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_spatial, cfg.mesh_model, cfg.mesh_pipe,
                         device)
        rank, world = mesh.coords["data"], mesh.size("data")
    shard_kw = dict(num_shards=world, shard_index=rank)
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
    prefetch, ring = loader_arch(cfg)
    # steps_per_dispatch=K: K optimizer steps' samples a loader batch
    train_dl = DataLoader(train_ds, cfg.batch_size * cfg.steps_per_dispatch, shuffle=True,
                          num_workers=cfg.num_workers, seed=cfg.seed, prefetch=prefetch,
                          slot_ring=ring, **shard_kw)
    test_dls = [DataLoader(ds, cfg.batch_size, shuffle=False,
                           num_workers=cfg.num_workers, prefetch=prefetch, **shard_kw)
                for ds in test_dss]
    model = build_model(
        cfg.model, img_size=cfg.res, patch_size=cfg.patch_size,
        in_channels=train_ds.n_channels, in_timesteps=cfg.T_in,
        out_timesteps=cfg.T_bundle, embed_dim=cfg.width, modes=cfg.modes,
        depth=cfg.n_layers, n_blocks=cfg.n_blocks, mlp_ratio=cfg.mlp_ratio,
        out_layer_dim=cfg.out_layer_dim, act=cfg.act, n_cls=len(cfg.train_paths),
        normalize=cfg.normalize, use_ln=cfg.use_ln, remat=cfg.remat,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        device=device, seed=cfg.seed, **model_mesh_kw(cfg, mesh),
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
    state.mesh = mesh
    return model, state, sched, train_dl, test_dls, train_ds


def model_mesh_kw(cfg: TrainConfig, mesh) -> dict:
    """The model's mesh arguments: DPOTNet takes the mesh under a 'spatial'
    or 'pipe' axis (the JAX loop's spatial_mesh and pipe_mesh)."""
    if mesh is None or (cfg.mesh_spatial == 1 and cfg.mesh_pipe == 1):
        return {}
    return dict(mesh=mesh, pipe_microbatches=cfg.pipe_microbatches)


def unique_log_dir(cfg: TrainConfig) -> str:
    """The run's log directory (the module docstring)."""
    base = os.path.join(cfg.log_path or "./logs", time.strftime("%m%d_%H_%M_%S") + cfg.comment)
    path, i = base, 0
    while os.path.exists(path):
        i += 1
        path = f"{base}_{i}"
    return path


def global_sizes(dl) -> list[int]:
    """The global rows of each batch of `dl` in an epoch (a shard's batches
    are slices of these)."""
    n, bs = len(dl.dataset), dl.batch_size
    return [min(bs, n - i) for i in range(0, n, bs)]


def place_state(state: TrainState, cfg: TrainConfig, device: torch.device) -> None:
    """Place the state over the ranks, as the JAX loop does after init or
    restore (the loop's docstring): tensor-parallel shards (`tp`,
    `tp_fsdp`), a pipeline stage's blocks (`mesh_pipe`), either of them
    with FSDP2 over 'data' (`fsdp`, `tp_fsdp`), FSDP2 alone (`fsdp`, also
    on one rank), DDP over replicas (`replicate` over 'data' alone), or the
    model itself, split by its own forward ('spatial') or computed alike
    by the ranks of the other axes (a model whose leaves no TP rule
    reaches, FNO and UNet, as JAX leaves them replicated). The gradients
    are then averaged by the step over 'data' and 'spatial', where
    neither DDP nor FSDP2 reduces them. A model's BatchNorm takes its
    statistics over 'data' (models/unet.py `sync_batch_stats`)."""
    from dpot_tpu_torch.models.unet import sync_batch_stats
    from dpot_tpu_torch.parallel.fsdp import check_fsdp_shardings, shard_state_fsdp

    mesh = state.mesh
    if mesh is None:
        raise RuntimeError(f"shard_params={cfg.shard_params} over ranks needs the default "
                           "process group: launch under torchrun")
    model = state.model
    sync_batch_stats(model, mesh.axis("data"))
    spatial = getattr(model, "spatial", None)
    # the groups whose ranks hold different rows: 'data', and 'spatial'
    # where the model splits the grid
    rows = tuple(a.group for a in (mesh.axis("data"), spatial) if a is not None and a.size > 1)
    tp = cfg.shard_params in ("tp", "tp_fsdp")
    pipe = getattr(model, "pipe", None) is not None
    if tp:
        shard_state_tp(state, mesh)
    if pipe:
        shard_state_pipe(state, mesh)
    if cfg.shard_params in ("fsdp", "tp_fsdp"):
        # FSDP2 averages over 'data'; the step then over 'spatial'
        shard_state_fsdp(state, mesh, (spatial.group,) if spatial is not None else None)
        bad = check_fsdp_shardings(state)
        if bad:
            raise RuntimeError(f"FSDP left {len(bad)} tensors unsharded: {bad[:4]}")
    elif tp or pipe or mesh.size("data") < mesh.size():
        state.train_module = model
        state.place_over(mesh, rows or None)
    else:
        state.train_module = replicate(model, UNTRAINED)
        state.place_over(mesh)


def write_viz(pred: torch.Tensor, y, msk, split, viz_dir: str, name: str) -> list[str]:
    """One sample's visuals, prediction and target masked, by rank 0: the
    final epoch's of a test set here, each set's first in the evaluator
    (as the JAX loop and evaluator write them); a grid split over
    'spatial' (`split`, else None) is gathered first, by every rank of the
    axis. Returns the files written (none on the other ranks)."""
    from dpot_tpu_torch.parallel.mesh import gather_stacked
    from dpot_tpu_torch.utils.viz import save_eval_viz

    if split is not None:
        pred = torch.cat(gather_stacked(pred.contiguous(), split).unbind(0), 0)
    if rank_world()[0] != 0:
        return []
    msk = torch.as_tensor(np.asarray(msk))
    return save_eval_viz((pred.cpu() * msk).float().numpy(),
                         (torch.as_tensor(np.asarray(y)) * msk).float().numpy(),
                         viz_dir, name)


def spatial_rows(a, axis):
    """This rank's H rows of a host batch column (B, H, W, ...) under the
    model's 'spatial' axis (`axis`), else the column."""
    if axis is None:
        return a
    n = a.shape[1] // axis.size
    return a[:, axis.rank * n:(axis.rank + 1) * n]


def train(cfg: TrainConfig, log_dir: Optional[str] = None,
          device: str | torch.device = "cuda",
          init_state_dict: Optional[dict[str, torch.Tensor]] = None,
          dist_backend: Optional[str] = None) -> dict:
    """Train on `device` (CUDA unless the caller asks for the CPU). Returns
    the state, the model, the last epoch's metrics, the log directory and
    the host time of every loop iteration (`step_seconds`).

    The run starts from, in this order of precedence: `init_state_dict`
    (the caller's weights, e.g. cli/finetune's merge), cfg.resume_path (a
    full resume: weights, moments, step, noise stream) or cfg.init_from (a
    checkpoint's weights only). A warm start from weights keeps fresh
    moments, step 0 and the schedule from its start. `dispatch_steps`
    holds the optimizer steps of each loop iteration (K or 1).

    Under torchrun the default process group starts here (`dist_backend`,
    by default nccl on CUDA and gloo on the CPU), unless the caller started
    it; each rank's default device is cuda:LOCAL_RANK."""
    with contextlib.ExitStack() as resources:
        return _train(cfg, log_dir, device, init_state_dict, dist_backend, resources)


def _train(cfg, log_dir, device, init_state_dict, dist_backend,
           resources: contextlib.ExitStack) -> dict:
    """train()'s run; what it opens that outlives a step (the checkpoint
    writer) it enters into `resources`, which train() closes."""
    maybe_initialize(dist_backend, resolve_device(device))
    rank, world = rank_world()
    model, state, sched, train_dl, test_dls, train_ds = build_everything(cfg, device)
    mesh = state.mesh
    device = next(model.parameters()).device
    saves = bool(log_dir) or cfg.use_writer  # the same on every rank
    if log_dir is None and cfg.use_writer and rank == 0:
        # rank 0's choice counts: it alone writes
        log_dir = unique_log_dir(cfg)
    if rank:
        # rank 0 writes; the others only take part in gathering a sharded
        # checkpoint
        log_dir = None
    writer = MetricWriter(log_dir, echo=rank == 0)
    resources.callback(writer.close)
    ckpt_dir = os.path.join(log_dir, "model") if log_dir else None
    # rank 0 writes on the writer's thread; the gather of a sharded state
    # stays synchronous. Closing it waits for the last write.
    ckpt_writer = None
    if ckpt_dir and cfg.async_ckpt:
        ckpt_writer = resources.enter_context(AsyncCheckpointWriter())

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
    if world > 1 or cfg.shard_params != "replicate":
        place_state(state, cfg, device)
    # the rows of a global batch are split over 'data' only
    rank, world = state.rank, state.world

    # the model's 'spatial' axis, whose ranks each take their H rows
    split = getattr(model, "spatial", None)
    if cfg.mesh_spatial > 1:
        # spatial sharding takes the standard host layout, as in the JAX loop
        train_ds.time_major_batches = False
    time_major = bool(train_ds.time_major_batches)
    ones_mask = bool(train_ds.train_masks_are_ones)
    # wire formats: x in bf16 when the compute is bf16 anyway; no mask when
    # the train masks are all ones
    wire = cfg.wire_dtype
    if wire == "auto":
        wire = "bfloat16_x" if cfg.dtype == "bfloat16" else "float32"
    wire_x = torch.bfloat16 if wire.startswith("bfloat16") else None
    wire_y = torch.bfloat16 if wire == "bfloat16" else None
    # the loader converts in its assembly pass; _to_device then converts
    # only the batches that did not go through its slots
    train_dl.x_dtype, train_dl.y_dtype = wire_x, wire_y
    step_kw = dict(t_bundle=cfg.T_bundle, noise_scale=cfg.noise_scale,
                   time_major=time_major, ones_mask=ones_mask)
    K = cfg.steps_per_dispatch
    step_fn = make_train_step(grad_accum=cfg.grad_accum, scan_steps=K, **step_kw)
    # a tail that cannot fill a dispatch runs B-sized single steps
    tail_step_fn = make_train_step(grad_accum=cfg.grad_accum, **step_kw) if K > 1 else step_fn
    # a tail batch that does not divide into grad_accum takes one full step
    noaccum_step_fn = make_train_step(**step_kw) if cfg.grad_accum > 1 else tail_step_fn
    roll_fn = make_eval_rollout(t_bundle=cfg.T_bundle)
    if state.sharded or (mesh is not None and mesh.size() > mesh.size("data")):
        # FSDP2 gathers the weights, and the other layouts' forwards hold
        # collectives, which a CUDA graph cannot hold: the rollout runs eagerly
        roll_fn = roll_fn.run

    def sharded(n: int) -> bool:
        """Whether a global batch of n rows is split over the ranks (else
        every rank holds it whole)."""
        return world > 1 and shard_rows(n, rank, world) is not None

    n_params = sum(p.numel() for p in model.parameters())
    writer.text(f"model {cfg.model} params {n_params / 1e6:.2f}M device {device}"
                + (f" ranks {rank_world()[1]} ({cfg.shard_params})"
                   if rank_world()[1] > 1 else ""))

    it = start_epoch * steps_per_epoch
    loss_ema = None
    rollback_on = cfg.rollback_factor > 0 and cfg.rollback_snapshot_steps >= 0
    take_snapshot = _snapshot
    if rollback_on:
        mode, per_dev, limit = snapshot_mode(state)
        take_snapshot = _host_snapshot if mode == "host" else _snapshot
        mem = "no memory limit" if limit is None else f"80% of {limit / 2**30:.1f} GiB HBM"
        writer.text(f"rollback snapshots on {mode.upper()}: params+opt are "
                    f"{per_dev / 2**30:.1f} GiB/device ({per_dev} bytes); {mem}"
                    + (" (DPOT_SNAPSHOT_MODE)" if os.environ.get("DPOT_SNAPSHOT_MODE")
                       in ("device", "host") else ""))
    last_good = take_snapshot(state) if rollback_on else None
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
            """Loader batches as (x, y, msk, cls, k, n): a full K * B batch is
            one K-step dispatch, anything else B-sized single steps; n is the
            unit's global rows (K = 1 over several ranks)."""
            bs = cfg.batch_size
            for (x_, y_, msk_, cls_), n_ in zip(dl, global_sizes(dl)):
                if K == 1 or x_.shape[0] == K * bs:
                    yield x_, y_, msk_, cls_, K, n_
                else:
                    for i in range(0, x_.shape[0], bs):
                        yield (x_[i:i + bs], y_[i:i + bs], msk_[i:i + bs], cls_[i:i + bs], 1,
                               x_[i:i + bs].shape[0])

        for x, y, msk, cls, k_unit, n in dispatch_units(train_dl):
            t_load += time.perf_counter() - t_1
            t_1 = time.perf_counter()
            host = {"x": spatial_rows(x, split), "y": spatial_rows(y, split), "cls": cls}
            if not ones_mask:
                host["msk"] = spatial_rows(msk, split)
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
                fn = noaccum_step_fn if n % cfg.grad_accum else tail_step_fn
            if world > 1 and not sharded(n):
                state, aux = fn(state, batch, replicated=True)
            else:
                state, aux = fn(state, batch)
            prev_it = it
            it += k_unit
            drain(pending)
            if (rollback_on and cfg.rollback_snapshot_steps > 0
                    and it // cfg.rollback_snapshot_steps
                    != prev_it // cfg.rollback_snapshot_steps):
                # mid-epoch snapshot, taken after the drain so that a
                # just-detected explosion snapshots the restored state
                last_good = take_snapshot(state)
            pending = (aux, n // k_unit, steps_per_sample, it)
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
            for (x, y, msk, _), n in zip(dl, global_sizes(dl)):
                if t_y not in (None, y.shape[-2]):
                    raise ValueError(
                        f"eval batches of {cfg.test_paths[di]} mix rollout lengths "
                        f"{t_y} and {y.shape[-2]}"
                    )
                t_y = y.shape[-2]
                out = roll_fn(model, {k: _to_device(spatial_rows(v, split), device)
                                      for k, v in (("x", x), ("y", y), ("msk", msk))})
                if cfg.viz_dir and ep == cfg.epochs - 1 and n_seen == 0:
                    write_viz(out["pred"][0], y[0], msk[0], split, cfg.viz_dir,
                              cfg.test_paths[di])
                sums = torch.stack([out["loss_step"], out["loss_full"]])
                if sharded(n):
                    dist.all_reduce(sums, group=state.data_group)
                s_b, f_b = sums.tolist()
                s_sum += s_b
                f_sum += f_b
                n_seen += n
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
        if state.sharded:
            # FSDP2 keeps the root's weights gathered after a forward with no
            # backward, gathered under inference mode: shard them again, so
            # that the next train step gathers weights autograd can track
            model.reshard()

        if (saves and (rank_world()[0] == 0 or state.gathers)
                and (ep % cfg.save_every == 0 or ep == cfg.epochs - 1)):
            target = ckpt_dir
            if ckpt_dir and cfg.ckpt_bucket_epochs > 0:
                target = f"{ckpt_dir}_{ep // cfg.ckpt_bucket_epochs}"
            save_checkpoint(target, state, config=vars(cfg), writer=ckpt_writer)
        if rollback_on and cfg.rollback_snapshot_steps == 0:
            last_good = take_snapshot(state)

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

    return {"state": state, "model": model, "log_dir": log_dir,
            "step_seconds": step_seconds, "dispatch_steps": dispatch_steps, **history}

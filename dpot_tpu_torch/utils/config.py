"""Config system of the port: one dataclass, optional YAML, CLI override,
and the sweep's expansion of a YAML `tasks:` grid (the port's copy of
dpot_tpu/utils/config.py). Field names, and so the CLI flags, are those of
the JAX package. PyYAML is imported only when a YAML file is given."""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
from typing import Any, List, Optional, Sequence


@dataclasses.dataclass
class TrainConfig:
    # model
    model: str = "DPOT"
    width: int = 512
    n_layers: int = 4
    modes: int = 32
    patch_size: int = 8
    n_blocks: int = 4
    mlp_ratio: float = 1.0
    out_layer_dim: int = 32
    act: str = "gelu"
    normalize: bool = False
    time_agg: str = "exp_mlp"
    use_ln: int = 0  # FNO GroupNorm(4) layers (reference configs use_ln)

    # data
    train_paths: List[str] = dataclasses.field(
        default_factory=lambda: ["ns2d_fno_1e-5"]
    )
    test_paths: List[str] = dataclasses.field(default_factory=list)
    ntrain_list: Optional[List[int]] = None
    ntest_list: Optional[List[int]] = None
    data_weights: List[int] = dataclasses.field(default_factory=lambda: [1])
    res: int = 128
    T_in: int = 10
    T_ar: int = 1
    T_bundle: int = 1
    noise_scale: float = 0.0

    # optimization
    opt: str = "adam"
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: Optional[float] = None
    lr_method: str = "cycle"
    cycle_momentum: bool = True
    lr_step_size: int = 20
    step_size: int = 100
    step_gamma: float = 0.5
    warmup_epochs: int = 5
    grad_clip: float = 10000.0
    opt_moment_dtype: str = "float32"
    batch_size: int = 8
    steps_per_dispatch: int = 1
    grad_accum: int = 1
    epochs: int = 500
    rollback_factor: float = 10.0
    rollback_warmup_steps: int = 20
    rollback_snapshot_steps: int = 0
    async_ckpt: bool = True

    # runtime
    seed: int = 0
    num_workers: int = 8
    loader_prefetch: int = -1
    loader_slot_ring: int = -1
    n_channels: int = 4  # model input channels when no dataset infers them
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    wire_dtype: str = "auto"  # auto | float32 | bfloat16
    remat: bool = False
    mesh_data: Optional[int] = None
    mesh_spatial: int = 1
    mesh_model: int = 1
    mesh_pipe: int = 1
    pipe_microbatches: int = 0
    shard_params: str = "replicate"

    # logging / checkpoint
    comment: str = ""
    log_path: str = ""
    use_writer: bool = False
    viz_dir: str = ""
    # the serve CLI reads model weights from a reference-layout .pth here
    resume_path: str = ""
    init_from: str = ""
    load_components: List[str] = dataclasses.field(
        default_factory=lambda: ["blocks", "pos", "time_agg"]
    )
    save_every: int = 1
    ckpt_bucket_epochs: int = 0

    def __post_init__(self):
        if isinstance(self.train_paths, str):
            self.train_paths = [self.train_paths]
        if isinstance(self.test_paths, str):
            self.test_paths = [self.test_paths]
        if not self.test_paths:
            self.test_paths = list(self.train_paths)
        if len(self.data_weights) == 1 and len(self.train_paths) > 1:
            self.data_weights = [self.data_weights[0]] * len(self.train_paths)
        if self.opt_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"opt_moment_dtype {self.opt_moment_dtype!r} must be float32 or bfloat16"
            )
        if self.grad_accum < 1 or self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size {self.batch_size} must divide into "
                f"grad_accum={self.grad_accum} microbatches"
            )
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}")


def pop_flag(argv: list[str], flag: str, default: Any = None, cast=str) -> Any:
    """Remove `flag VALUE` from argv and return VALUE cast, or `default`
    when the flag is absent: the CLIs' own flags beside TrainConfig's."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = cast(argv[i + 1])
    del argv[i:i + 2]
    return value


def pop_switch(argv: list[str], flag: str) -> bool:
    """Remove a bare `flag` from argv; whether it was there."""
    present = flag in argv
    if present:
        argv.remove(flag)
    return present


def _parser_for(cls) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", type=str, default=None)
    # adopt --resume_path's saved model architecture as the base config
    p.add_argument("--config_from_ckpt", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=False)
    for f in dataclasses.fields(cls):
        name = f"--{f.name}"
        t = str(f.type)
        if f.type in ("bool", bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None)
        elif "List[str]" in t:
            p.add_argument(name, type=str, nargs="+", default=None)
        elif "List[int]" in t:
            p.add_argument(name, type=int, nargs="+", default=None)
        elif "int" in t:
            p.add_argument(name, type=int, default=None)
        elif "float" in t:
            p.add_argument(name, type=float, default=None)
        else:
            p.add_argument(name, type=str, default=None)
    return p


# the fields that define a model's architecture, which --config_from_ckpt
# adopts from a checkpoint (not its schedule or datasets)
ARCH_KEYS = ("model", "res", "patch_size", "width", "n_layers", "n_blocks", "modes", "T_in",
             "T_bundle", "mlp_ratio", "out_layer_dim", "act", "use_ln", "normalize", "time_agg")


def ckpt_config_base(resume_path: str) -> dict:
    """The architecture fields of the config.json that the port saved beside
    a checkpoint in directory `resume_path` ({} when there is none): an
    evaluation or a served model takes the checkpoint's shape, and an act
    or normalize typed wrong cannot change its predictions unnoticed."""
    path = os.path.join(resume_path, "config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        saved = json.load(f)
    return {k: saved[k] for k in ARCH_KEYS if k in saved}


def load_config(argv: Optional[Sequence[str]] = None, cls=TrainConfig):
    """The checkpoint's architecture (--config_from_ckpt true with a
    --resume_path directory) < YAML (--config_file) < CLI flags."""
    ns = _parser_for(cls).parse_args(argv)
    base: dict[str, Any] = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    if ns.config_from_ckpt and ns.resume_path:
        base.update(ckpt_config_base(ns.resume_path))
    if ns.config_file:
        import yaml

        with open(ns.config_file) as f:
            y = yaml.safe_load(f)
        base.update({k: v for k, v in y.items() if k in fields})
    for name in fields:
        v = getattr(ns, name)
        if v is not None:
            base[name] = v
    return cls(**base)


def expand_tasks(yaml_dict: dict) -> list[dict]:
    """Expand a sweep config: any key under 'tasks' whose value is a list
    becomes a grid axis (reference trainer.py:86-111 / README.md:76-88);
    every other key of the file is common to all jobs."""
    tasks = yaml_dict.get("tasks", {})
    base = {k: v for k, v in yaml_dict.items() if k != "tasks"}
    grid_keys = [k for k, v in tasks.items() if isinstance(v, list)]
    fixed = {k: v for k, v in tasks.items() if not isinstance(v, list)}
    out = []
    for combo in itertools.product(*[tasks[k] for k in grid_keys]) or [()]:
        job = dict(base)
        job.update(fixed)
        job.update(dict(zip(grid_keys, combo)))
        out.append(job)
    return out

"""Pretraining CLI of the port (port of dpot_tpu/cli/train.py):

    python -m dpot_tpu_torch.cli.train --model DPOT --train_paths ns2d_fno_1e-5 \
        --width 512 --n_layers 4 --epochs 500 --use_writer true [--device cpu]

Takes the reference's flag names and --config_file YAML (flags override the
YAML), plus --device: cuda by default, where the kernels run; cpu runs
their plain versions. Without a GPU the cuda default raises.

Several processes, data-parallel (`shard_params: replicate`, DDP) or fully
sharded (`shard_params: fsdp`, FSDP2), one rank per card:

    torchrun --nproc_per_node N -m dpot_tpu_torch.cli.train --config_file ...

--dist_backend names the process group's backend: nccl by default on CUDA,
gloo on the CPU (--device cpu). Two ranks on one card take
`--dist_backend gloo --device cuda:0`, since nccl refuses that.
"""

from __future__ import annotations

import sys


def main(argv=None):
    from dpot_tpu_torch.parallel import maybe_initialize
    from dpot_tpu_torch.train.loop import train
    from dpot_tpu_torch.utils.config import load_config, pop_flag
    from dpot_tpu_torch.utils.device import resolve_device

    argv = list(argv if argv is not None else sys.argv[1:])
    device = pop_flag(argv, "--device", "cuda")
    dist_backend = pop_flag(argv, "--dist_backend")
    # under torchrun, the process group first (a no-op otherwise)
    maybe_initialize(dist_backend, resolve_device(device))
    cfg = load_config(argv)
    print("config", vars(cfg), "device", device, flush=True)
    return train(cfg, device=device, dist_backend=dist_backend)


if __name__ == "__main__":
    main()

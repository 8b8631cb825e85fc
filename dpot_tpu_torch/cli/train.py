"""Pretraining CLI of the port (port of dpot_tpu/cli/train.py):

    python -m dpot_tpu_torch.cli.train --model DPOT --train_paths ns2d_fno_1e-5 \
        --width 512 --n_layers 4 --epochs 500 --use_writer true [--device cpu]

Takes the reference's flag names and --config_file YAML (flags override the
YAML), plus --device: cuda by default, where the kernels run; cpu runs
their plain versions. Without a GPU the cuda default raises.
"""

from __future__ import annotations

import sys


def main(argv=None):
    from dpot_tpu_torch.train.loop import train
    from dpot_tpu_torch.utils.config import load_config

    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i: i + 2]
    cfg = load_config(argv)
    print("config", vars(cfg), "device", device, flush=True)
    return train(cfg, device=device)


if __name__ == "__main__":
    main()

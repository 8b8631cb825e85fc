"""Fine-tuning CLI of the port (port of dpot_tpu/cli/finetune.py, the
reference's finetune.py):

    python -m dpot_tpu_torch.cli.finetune --config_file configs/dpot_finetune.yaml \
        --resume_path DPOT_small_model.pth --train_paths ns2d_cond_pda [--device cpu]

Copies the components named by --load_components (default blocks, pos,
time_agg; 'all' for every one) from the pretrained checkpoint at
--resume_path (a reference-layout .pth, or a checkpoint directory that the
port wrote) into a model built for the target datasets, a unit at a time
where the shapes match, prints the units copied and trains from the merge
with fresh optimizer state. Without --resume_path it trains from scratch.
Under torchrun it runs on every rank, with --dist_backend, as cli/train.
"""

from __future__ import annotations

import sys


def main(argv=None) -> dict:
    from dpot_tpu_torch.parallel import maybe_initialize
    from dpot_tpu_torch.train.checkpoint import load_components
    from dpot_tpu_torch.train.interop import params_from_any
    from dpot_tpu_torch.train.loop import build_everything, train
    from dpot_tpu_torch.utils.config import load_config, pop_flag
    from dpot_tpu_torch.utils.device import resolve_device

    argv = list(argv if argv is not None else sys.argv[1:])
    device = pop_flag(argv, "--device", "cuda")
    dist_backend = pop_flag(argv, "--dist_backend")
    # under torchrun, the process group first (a no-op otherwise)
    maybe_initialize(dist_backend, resolve_device(device))
    cfg = load_config(argv)
    print("config", vars(cfg), "device", device, flush=True)
    if not cfg.resume_path:
        return train(cfg, device=device, dist_backend=dist_backend)

    # a throwaway model for the target's parameter names and shapes
    model = build_everything(cfg, device)[0]
    target = model.state_dict()
    merged, copied = load_components(target, params_from_any(cfg.resume_path, model),
                                     components=cfg.load_components)
    print(f"loaded components {cfg.load_components}: {len(copied)} units {copied}",
          flush=True)
    del model, target
    # the merge is the run's start; clearing resume_path stops a full resume
    cfg.resume_path = ""
    out = train(cfg, device=device, init_state_dict=merged, dist_backend=dist_backend)
    out["copied"] = copied
    return out


if __name__ == "__main__":
    main()

"""How far the bf16 kernels of fused_gn_afno sit from its plain version, per
call and over a model's rollout, to set the bf16 limits of chip_smoke.py's
plain-mixer checks.

    python3 tools/bf16_mixer_readings.py

Builds the kernels and, on the card (TF32 off):
  - per call, at B = 8 and the block shapes of Ti (4 blocks of 128
    channels), configs/afno_config_single.yaml (8 blocks of 64) and L (16
    blocks of 96), with the AFNO weights from N(0, 0.05^2) and at the
    init's scale: the Hopper kernel of the shapes and the five-launch
    kernel (forced) against the plain version, as the relative L2 of the
    output and of its spectral part (the output less the f32 normed input,
    the residual), the share of output elements that differ, the two
    kernels against each other, and two plain mixers wrong on purpose
    ("drop_mode", "conj_w2"; chip_smoke.py `faulty_mixer`);
  - over an 11-step eval rollout of 4 samples (a synthetic 128^2 set of 4
    channels, T_in 10), for the config's model (width 512, depth 4, 8
    blocks) and Ti's, each in bf16 and f32, their AFNO weights redrawn from
    N(0, 0.05^2) (chip_smoke.py `draw_mixer_weights`): the predictions on
    the kernel of the shapes, on the five-launch kernel (forced) and with
    three faulty plain mixers, each against the plain mixer's (relative
    L2).
Prints one JSON line per case, and the card's name and power limit last.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from dpot_tpu_torch.ops.cuda import build  # noqa: E402
from dpot_tpu_torch.ops.cuda.afno_fused import fused_gn_afno, fused_gn_afno_ref  # noqa: E402
from dpot_tpu_torch.ops.norms import group_norm  # noqa: E402

CALL_CASES = (("Ti", cs.TI, "hopper"), ("A", cs.AFNO_SINGLE, "hopper_pairs"),
              ("L", cs.DPOT_L, "hopper_l"))
MODELS = (("A", dict(embed_dim=512, depth=4, n_blocks=8, modes=32, mlp_ratio=1.0)),
          ("Ti", dict(preset="Ti")))


def per_call(name: str, geo: dict, path: str, scale: float | None) -> dict:
    args, K, g = cs.afno_case(8, torch.bfloat16, scale, 108, geo)
    want = fused_gn_afno_ref(*args, K, g, True).float()
    spectral = (want - group_norm(args[0].float(), args[1], args[2], g)).norm().item()
    got = {}
    for p in (path, "general"):
        with cs.forced_path(p):
            got[p] = fused_gn_afno(*args, K, g, True).float()
    torch.cuda.synchronize()
    row = {"spectral_over_out": spectral / want.norm().item()}
    for p, y in got.items():
        row[p] = dict(rel_out=cs.rel_l2(y, want), rel_spectral=(y - want).norm().item() / spectral,
                      share_differing=(y != want).float().mean().item())
    row["kernels_apart_rel_spectral"] = (got[path] - got["general"]).norm().item() / spectral
    for fault in ("drop_mode", "conj_w2"):
        y = cs.faulty_mixer(fault)(*args, K, g, True).float()
        row[fault + "_rel_spectral"] = (y - want).norm().item() / spectral
    return {f"call/{name}/bfloat16/scale={scale}": row}


def rollouts(batch: dict) -> list[dict]:
    from dpot_tpu_torch.models import build_model
    from dpot_tpu_torch.train.step import make_eval_rollout

    rows = []
    for name, kw in MODELS:
        for dtype in (torch.bfloat16, torch.float32):
            model = build_model("DPOT", img_size=128, patch_size=8, in_channels=4,
                                in_timesteps=10, n_cls=1, dtype=dtype, device="cuda", seed=0,
                                **kw)
            cs.draw_mixer_weights(model, seed=8)
            roll = make_eval_rollout()

            def preds():
                return roll.run(model, batch)["pred"].float()

            got = preds()
            with cs.forced_path("general"):
                general = preds()
            with cs.plain_mixer():
                want = preds()
            row = {"kernel": cs.rel_l2(got, want), "general": cs.rel_l2(general, want),
                   "kernel_vs_general": cs.rel_l2(got, general)}
            for fault in ("drop_mode", "conj_w2", "swap_pairs"):
                with cs.plain_mixer(cs.faulty_mixer(fault)):
                    row[fault] = cs.rel_l2(preds(), want)
            rows.append({f"rollout/{name}/{str(dtype).replace('torch.', '')}": row})
            del model
    return rows


def main() -> int:
    from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
    from dpot_tpu_torch.data.registry import make_synthetic_spec

    if not torch.cuda.is_available():
        print("bf16_mixer_readings: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    for name, geo, path in CALL_CASES:
        for scale in (cs.MIXER_SCALE, None):
            print(json.dumps(per_call(name, geo, path, scale)), flush=True)
    make_synthetic_spec("synthetic_readings", train_size=4, test_size=4, t_total=21, t_test=11,
                        in_size=(128, 128), n_channels=4)
    ds = MixedTemporalDataset(["synthetic_readings"], res=128, t_in=10, t_ar=-1, n_channels=4,
                              train=False)
    x, y, msk, _ = next(iter(DataLoader(ds, 4, shuffle=False, num_workers=0)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in (("x", x), ("y", y), ("msk", msk))}
    for row in rollouts(batch):
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

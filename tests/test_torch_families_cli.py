"""The model families through the port's CLIs on the CPU at a tiny size:
`cli.sweep` on a copy of configs/cdpot_parallel.yaml with its data and
widths cut, `cli.convert` of each family's reference-layout .pth (CDPOT's
duplicate keys, FNO3d's torch.cfloat weights), `cli.serve` of the converted
CDPOT directory against a direct loop over model(x), `cli.train` of FNO
(patch 1) and UNet with `cli.evaluate` on their checkpoints, and
`cli.evaluate` of FNO3D on a 3D set."""

import contextlib
import io
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dpot_tpu_torch.cli import sweep
from dpot_tpu_torch.cli.convert import main as convert_main
from dpot_tpu_torch.cli.evaluate import main as evaluate_main
from dpot_tpu_torch.cli.serve import main as serve_main
from dpot_tpu_torch.cli.train import main as train_main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.checkpoint import restore_params

ROOT = Path(__file__).resolve().parents[1]
SETS = ("synthetic_fam_a", "synthetic_fam_b")
ARCH = {
    "CDPOT": ["--res", "16", "--patch_size", "4", "--width", "32", "--n_layers", "1",
              "--n_blocks", "4", "--modes", "4", "--out_layer_dim", "8"],
    "FNO": ["--res", "16", "--patch_size", "1", "--width", "16", "--n_layers", "2",
            "--modes", "4", "--use_ln", "1"],
    "FNO3D": ["--res", "8", "--width", "8", "--n_layers", "1", "--modes", "2"],
    "UNet": ["--res", "16", "--out_layer_dim", "4"],
}
BUILD = {  # the same architectures as build_model arguments
    "CDPOT": dict(img_size=16, patch_size=4, embed_dim=32, depth=1, n_blocks=4, modes=4,
                  out_layer_dim=8),
    "FNO": dict(img_size=16, patch_size=1, embed_dim=16, depth=2, modes=4, use_ln=1),
    "FNO3D": dict(img_size=8, embed_dim=8, depth=1, modes=2),
    "UNet": dict(img_size=16, out_layer_dim=4),
}
RUN = ["--T_in", "4", "--batch_size", "4", "--num_workers", "1", "--epochs", "1",
       "--warmup_epochs", "1", "--use_writer", "true", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _sets():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(SETS[0], train_size=4, test_size=2, t_total=8, t_test=3,
                        in_size=(16, 16), n_channels=2)
    make_synthetic_spec(SETS[1], train_size=4, test_size=2, t_total=8, t_test=3,
                        in_size=(24, 24), n_channels=1)
    make_synthetic_spec("synthetic_fam_3d", train_size=2, test_size=2, t_total=7, t_test=2,
                        in_size=(8, 8, 8), n_channels=2)
    yield
    torch.set_num_threads(n)


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def test_sweep_pretrains_cdpot_from_the_config_file(tmp_path):
    """configs/cdpot_parallel.yaml with its corpora replaced by two tiny
    synthetic sets and its widths, grid and epochs cut; every other key
    (CDPOT, adam, cycle schedule, betas, noise, f32) the file's. Finite
    losses, a checkpoint that restores to the state's weights, and
    cli.evaluate --config_from_ckpt on it giving the loop's last test
    metric."""
    doc = yaml.safe_load((ROOT / "configs" / "cdpot_parallel.yaml").read_text())
    assert doc["model"] == "CDPOT" and doc["opt"] == "adam"
    doc.update(train_paths=list(SETS), test_paths=list(SETS), ntrain_list=[4, 4],
               data_weights=[2, 1], log_path=str(tmp_path / "logs"))
    doc["tasks"].update(res=[16], patch_size=[4], width=[32], n_layers=[1], modes=[4],
                        out_layer_dim=[8], batch_size=[4], epochs=[2], warmup_epochs=[1],
                        T_in=[4], num_workers=[1])
    path = tmp_path / "cdpot.yaml"
    path.write_text(yaml.safe_dump(doc))
    (out,) = quiet(sweep.main, ["--config_file", str(path), "--device", "cpu"])
    state, model = out["state"], out["model"]
    assert type(model).__name__ == "CDPOTNet" and state.step == 2 * 3
    assert np.isfinite([out["train_l2_step"], *out["test_l2_fulls"]]).all()
    saved = restore_params(str(Path(out["log_dir"]) / "model"))
    assert saved.keys() == model.state_dict().keys()
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
    got = quiet(evaluate_main, ["--resume_path", str(Path(out["log_dir"]) / "model"),
                                "--config_from_ckpt", "true", "--train_paths", *SETS,
                                "--test_paths", *SETS, "--num_workers", "1",
                                "--device", "cpu"])
    for i, name in enumerate(SETS):
        np.testing.assert_allclose(got[name]["loss_full"], out["test_l2_fulls"][i], rtol=1e-6)


def reference_pth(family, path, seed=3):
    """A seeded model of `family` written as the reference writes it: DDP
    prefixes, FNO3d's spectral weights as torch.cfloat."""
    model = build_model(family, device="cpu", seed=seed, in_channels=2, in_timesteps=4,
                        n_cls=1, **BUILD[family])
    sd = {k: torch.complex(v[0], v[1]) if ".weights" in k and family == "FNO3D" else v
          for k, v in model.state_dict().items()}
    torch.save({"args": None, "model": {f"module.{k}": v for k, v in sd.items()}}, path)
    return model


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{family: (the reference model, its converted directory)}."""
    out = {}
    for family in ARCH:
        d = tmp_path_factory.mktemp(family)
        model = reference_pth(family, d / "ref.pth")
        quiet(convert_main, ["--model", family, *ARCH[family], "--n_channels", "2",
                             "--T_in", "4", "--resume_path", str(d / "ref.pth"),
                             "--out_path", str(d / "ckpt"), "--device", "cpu"])
        out[family] = (model, str(d / "ckpt"))
    return out


@pytest.mark.parametrize("family", list(ARCH))
def test_convert_takes_each_familys_reference_pth(converted, family):
    model, ckpt = converted[family]
    obj = torch.load(f"{ckpt}/model.pth", map_location="cpu", weights_only=False)
    assert obj["step"] == 0 and obj["model"].keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(obj["model"][k], v), k
    assert json.load(open(f"{ckpt}/config.json"))["model"] == family


def test_serve_answers_the_converted_cdpot_directory(converted):
    model, ckpt = converted["CDPOT"]
    httpd, rs = serve_main(["--model", "CDPOT", *ARCH["CDPOT"], "--n_channels", "2",
                            "--T_in", "4", "--port", "0", "--device", "cpu",
                            "--resume_path", ckpt], wait=False)
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 4, 2)).astype(np.float32)
    try:
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/rollout?steps=2",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            pred = np.load(io.BytesIO(r.read()))
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()
    carry, want = torch.from_numpy(x), []
    with torch.inference_mode():
        for _ in range(2):
            im = model.eval()(carry)[0]
            want.append(im)
            carry = torch.cat([carry[..., 1:, :], im], dim=-2)
    np.testing.assert_array_equal(pred, torch.cat(want, dim=-2).numpy())


@pytest.mark.parametrize("family", ["FNO", "UNet"])
def test_train_then_evaluate_fno_and_unet(family, tmp_path):
    """One epoch through cli.train (UNet in train mode, its statistics
    updated), then cli.evaluate --config_from_ckpt on the run's checkpoint
    (in eval mode): the loop's last test metric."""
    out = quiet(train_main, ["--model", family, *ARCH[family], *RUN, "--train_paths", SETS[0],
                             "--log_path", str(tmp_path)])
    assert out["state"].step == 1 and np.isfinite(out["train_l2_step"])
    if family == "UNet":
        assert out["model"].encoder1.enc1norm1.num_batches_tracked.item() == 1
    got = quiet(evaluate_main, ["--resume_path", str(Path(out["log_dir"]) / "model"),
                                "--config_from_ckpt", "true", "--train_paths", SETS[0],
                                "--test_paths", SETS[0], "--num_workers", "1",
                                "--device", "cpu"])
    np.testing.assert_allclose(got[SETS[0]]["loss_full"], out["test_l2_fulls"][0], rtol=1e-6)


def test_evaluate_fno3d_on_a_3d_set(converted):
    got = quiet(evaluate_main, ["--resume_path", converted["FNO3D"][1], "--config_from_ckpt",
                                "true", "--test_paths", "synthetic_fam_3d", "--metrics",
                                "--batch_size", "2", "--num_workers", "1", "--device", "cpu"])
    row = got["synthetic_fam_3d"]
    assert np.isfinite([row["loss_full"], row["loss_step"], row["nmse"]]).all()

"""Checkpoint conversion and the checkpoint directories of the port, on the
CPU at a small size: cli/convert.py turns a reference-layout .pth into a
directory that cli.train resumes, cli.serve serves and cli.evaluate reads
(with --config_from_ckpt)."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from dpot_tpu_torch.cli.convert import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.checkpoint import restore_params
from dpot_tpu_torch.utils.config import load_config

ARCH = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "16",
        "--n_layers", "2", "--n_blocks", "2", "--modes", "4", "--T_in", "4"]
RUN = ["--batch_size", "4", "--num_workers", "2", "--warmup_epochs", "1", "--epochs", "1",
       "--use_writer", "true", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _spec():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec("synthetic_tconv", train_size=8, test_size=4, t_total=10, t_test=3,
                        in_size=(16, 16), n_channels=2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A seeded model and its weights as a reference-layout .pth, the DDP
    prefix included, as the released files are."""
    model = build_model("DPOT", device="cpu", seed=6, img_size=16, patch_size=4,
                        in_channels=2, in_timesteps=4, embed_dim=16, depth=2, n_blocks=2,
                        modes=4, n_cls=1)
    path = tmp_path_factory.mktemp("ref") / "model_tiny.pth"
    torch.save({"args": None, "model": {f"module.{k}": v for k, v in
                                        model.state_dict().items()}}, path)
    return model, str(path)


@pytest.fixture(scope="module")
def converted(reference, tmp_path_factory):
    out = tmp_path_factory.mktemp("conv") / "ckpt"
    main(ARCH + ["--n_channels", "2", "--resume_path", reference[1], "--out_path", str(out),
                 "--device", "cpu"])
    return str(out)


def test_convert_writes_weights_fresh_state_and_config(reference, converted):
    obj = torch.load(f"{converted}/model.pth", map_location="cpu", weights_only=False)
    assert obj["step"] == 0 and obj["optimizer"]["count"] == 0
    assert all(not m.any() for m in obj["optimizer"]["mu"] + obj["optimizer"]["nu"])
    for k, v in reference[0].state_dict().items():
        assert torch.equal(obj["model"][k], v), k
    cfg = json.load(open(f"{converted}/config.json"))
    assert (cfg["width"], cfg["n_layers"], cfg["n_blocks"]) == (16, 2, 2)


def test_converted_checkpoint_resumes_in_train(reference, converted, tmp_path):
    """cli.train --resume_path takes the directory: one epoch from step 0,
    starting from the converted weights."""
    from dpot_tpu_torch.cli.train import main as train_main

    out = train_main(ARCH + RUN + ["--train_paths", "synthetic_tconv", "--resume_path",
                                   converted, "--log_path", str(tmp_path)])
    assert out["state"].step == 2 and np.isfinite(out["train_l2_step"])
    logs = open(f"{out['log_dir']}/logs.txt").read()
    assert "step 0, continuing at epoch 0" in logs


def served_answer(resume_path, x, steps=2):
    from dpot_tpu_torch.cli.serve import main as serve_main

    httpd, rs = serve_main(ARCH + ["--n_channels", "2", "--port", "0", "--device", "cpu",
                                   "--resume_path", resume_path], wait=False)
    try:
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/rollout?steps={steps}",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return np.load(io.BytesIO(r.read())), rs.model
    finally:
        httpd.shutdown()
        rs.stop(drain=True)
        httpd.server_close()


def direct_rollout(model, x, steps=2):
    carry, outs = torch.from_numpy(x), []
    with torch.inference_mode():
        for _ in range(steps):
            im = model(carry)[0]
            outs.append(im)
            carry = torch.cat([carry[..., 1:, :], im], dim=-2)
    return torch.cat(outs, dim=-2).numpy()


def test_converted_checkpoint_serves(reference, converted):
    x = np.random.default_rng(0).standard_normal((1, 16, 16, 4, 2)).astype(np.float32)
    pred, _ = served_answer(converted, x)
    np.testing.assert_array_equal(pred, direct_rollout(reference[0].eval(), x))


def test_a_directory_without_model_pth_names_what_it_expected(tmp_path):
    with pytest.raises(FileNotFoundError, match="without model.pth"):
        restore_params(str(tmp_path))


def test_config_from_ckpt_adopts_the_architecture(converted, tmp_path):
    cfg = load_config(["--resume_path", converted, "--config_from_ckpt", "true",
                       "--n_layers", "3"])
    assert (cfg.width, cfg.n_blocks, cfg.res, cfg.n_layers) == (16, 2, 16, 3)
    assert load_config(["--resume_path", converted]).width == 512
    assert load_config(["--resume_path", str(tmp_path), "--config_from_ckpt",
                        "true"]).width == 512


def test_evaluate_reads_the_converted_directory(reference, converted):
    from dpot_tpu_torch.cli.evaluate import main as evaluate_main
    from dpot_tpu_torch.train.evaluator import evaluate

    got = evaluate_main(["--resume_path", converted, "--config_from_ckpt", "true",
                         "--test_paths", "synthetic_tconv", "--batch_size", "2",
                         "--num_workers", "1", "--device", "cpu"])
    want = evaluate(reference[0], ["synthetic_tconv"], res=16, t_in=4, batch_size=2,
                    num_workers=1)
    assert got["synthetic_tconv"] == want["synthetic_tconv"]


def test_an_unknown_family_has_no_converter(reference, tmp_path):
    with pytest.raises(ValueError, match="no converter"):
        main(["--model", "MLP", "--resume_path", reference[1], "--out_path",
              str(tmp_path), "--device", "cpu"])


def test_cuda_is_the_default_device(reference, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ARCH + ["--n_channels", "2", "--resume_path", reference[1], "--out_path",
                     str(tmp_path)])

"""The port's 3D training and evaluation path on the CPU at a small size:
the train step and eval rollout on a pred-only DPOTNet3D (train/step.py
`pred_and_cls`) against the JAX package's on the same weights, batch and
noise; cli.finetune3d from a 2D .pth and from a port checkpoint directory;
cli.evaluate on a 3D set against the JAX evaluator; cli.convert --model
DPOT3D; and the sweep CLI running the JAX package's finetune3d name.

Bars: a train step's losses at 1e-5 and every gradient at 1e-4 relative
L2, as tests/test_torch_train_step.py holds the 2D step; the eval rollout
at the interop bar of PARITY.md, 2e-4; the evaluator's numbers at 1e-5
relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from dpot_tpu.data import registry as jax_registry
from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train import evaluator as jax_evaluator
from dpot_tpu.train.interop import dpot3d_params_from_torch
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_eval_rollout as jax_eval_rollout
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu.train.step import wrap_pred_only
from dpot_tpu_torch.cli import sweep
from dpot_tpu_torch.cli.convert import main as convert_main
from dpot_tpu_torch.cli.evaluate import main as evaluate_main
from dpot_tpu_torch.cli.finetune3d import main as finetune3d_main
from dpot_tpu_torch.data import registry
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train.checkpoint import restore_params
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import make_eval_rollout, make_train_step

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=3,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=1)
SET3D = "synthetic_t3d_ft"
ARCH = ["--res", "16", "--patch_size", "4", "--width", "32", "--n_layers", "2",
        "--n_blocks", "4", "--modes", "4", "--T_in", "3"]
RUN = ["--batch_size", "2", "--num_workers", "2", "--warmup_epochs", "1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """Two torch threads; a 16^3, 2-channel synthetic set in both registries."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    kw = dict(name=SET3D, train_path="", test_path="", train_size=4, test_size=3,
              scatter_storage=False, t_test=2, t_in=10, t_total=7, in_size=(16, 16, 16),
              n_channels=2, downsample=(1, 1, 1), synthetic=True)
    registry.register_dataset(registry.DatasetSpec(**kw))
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(
        jax_registry.DatasetSpec(**{k: v for k, v in kw.items() if k in fields}))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _numpy_host_paths(monkeypatch):
    import dpot_tpu.native.preprocess as pre
    import dpot_tpu_torch.native.preprocess as port_pre

    monkeypatch.setattr(pre, "get_library", lambda: None)
    monkeypatch.setattr(port_pre, "get_library", lambda: None)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def jax_params_of(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return dpot3d_params_from_torch(sd, depth=CFG["depth"])


def make_batch(seed, B=2, t_ar=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    shape = (B, 16, 16, 16)
    msk = np.ones(shape + (1, 2), f)
    msk[0, ::2] = 0.0
    return dict(x=(1.0 + rng.standard_normal(shape + (3, 2))).astype(f),
                y=(1.0 + rng.standard_normal(shape + (t_ar, 2))).astype(f), msk=msk,
                cls=np.zeros(B, np.int32),
                noise=rng.standard_normal((t_ar, *shape, 3, 2)).astype(f))


def grab_grads():
    """An optax transform that keeps the last gradient tree as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def test_3d_train_step_matches_jax():
    """T_ar 2, noise 0.05 through the external draws, a masked loss; the
    pred-only model gets one zero logit in both packages (cls loss 0)."""
    model = build_model("DPOT3D", device="cpu", seed=0, **CFG)
    jm = jax_build_model("DPOT3D", **CFG)
    batch = make_batch(0)
    jstate = JaxTrainState.create(wrap_pred_only(jm.apply), jax_params_of(model),
                                  grab_grads(), jax.random.key(0))
    jstate, jaux = jax_train_step(noise_scale=0.05, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(jstate.opt_state))
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 0.0), 0)
    state, aux = make_train_step(noise_scale=0.05)(
        state, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    for k in ("loss_step", "loss_full"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    assert aux["cls_loss"].item() == float(jaux["cls_loss"]) == 0.0
    for name, p in model.named_parameters():
        if name.startswith("cls_head"):
            assert p.grad is None and not want[name].numpy().any(), name
            continue
        assert rel_l2(p.grad.numpy(), want[name].numpy()) <= 1e-4, name


def test_3d_eval_rollout_matches_jax():
    model = build_model("DPOT3D", device="cpu", seed=1, **CFG)
    jm = jax_build_model("DPOT3D", **CFG)
    b = make_batch(1, t_ar=3)
    del b["noise"], b["cls"]
    want = jax_eval_rollout(t_bundle=1)(wrap_pred_only(jm.apply), jax_params_of(model),
                                         {k: jnp.asarray(v) for k, v in b.items()})
    got = make_eval_rollout(t_bundle=1)(model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert got["pred"].shape == (2, 16, 16, 16, 3, 2)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), atol=2e-4,
                               rtol=0)
    for k in ("loss_step", "loss_full"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-4)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A seeded 2D DPOT of the 3D model's widths (4 channels, 16^2) as a
    reference-layout .pth with DDP prefixes, and the same weights as a port
    checkpoint directory written by cli.convert."""
    m2 = build_model("DPOT", device="cpu", seed=2, **{**CFG, "in_channels": 4,
                                                     "out_channels": 4})
    root = tmp_path_factory.mktemp("src2d")
    pth = root / "dpot2d.pth"
    torch.save({"model": {f"module.{k}": v for k, v in m2.state_dict().items()}}, pth)
    convert_main(["--model", "DPOT"] + ARCH + ["--n_channels", "4", "--resume_path",
                                               str(pth), "--out_path", str(root / "ckpt"),
                                               "--device", "cpu"])
    return m2, str(pth), str(root / "ckpt")


def test_finetune3d_inflates_a_2d_pth(sources, tmp_path, capsys):
    """At lr 0 the checkpoint keeps the inflated weights: every trunk block
    and the time aggregator are the 2D source's, 1x1 convolutions as 1x1x1;
    the losses are finite and the checkpoint restores strict."""
    m2, pth, _ = sources
    out = finetune3d_main(ARCH + RUN + ["--train_paths", SET3D, "--epochs", "2", "--lr", "0",
                                        "--use_writer", "true", "--log_path", str(tmp_path),
                                        "--resume_path", pth])
    n = 12 * CFG["depth"] + 2
    assert len(out["copied"]) == n
    assert f"inflated {n} 2D entries into the 3D model" in capsys.readouterr().out
    assert np.isfinite(out["train_l2_step"] + out["test_l2_full"]).all()
    assert len(out["train_l2_step"]) == 2 and out["state"].step == 4
    fresh = build_model("DPOT3D", device="cpu", seed=9, **CFG)
    fresh.load_state_dict(restore_params(str(tmp_path)), strict=True)
    src = m2.state_dict()
    for k, v in fresh.state_dict().items():
        if k in out["copied"]:
            torch.testing.assert_close(v, src[k].reshape(v.shape), rtol=0, atol=0)
        torch.testing.assert_close(v, out["model"].state_dict()[k], rtol=0, atol=0)


def test_finetune3d_from_a_port_checkpoint_directory_trains(sources, tmp_path, capsys):
    _, _, ckpt = sources
    out = finetune3d_main(ARCH + RUN + ["--train_paths", SET3D, "--epochs", "2",
                                        "--lr", "1e-3", "--use_writer", "true",
                                        "--log_path", str(tmp_path), "--resume_path", ckpt])
    assert len(out["copied"]) == 12 * CFG["depth"] + 2
    assert np.isfinite(out["train_l2_step"] + out["test_l2_full"]).all()
    lines = [s for s in capsys.readouterr().out.splitlines() if s.startswith("epoch ")]
    assert len(lines) == 2 and "test l2 full" in lines[-1]
    restored = restore_params(str(tmp_path))
    for k, v in out["model"].state_dict().items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)


def test_finetune3d_defaults_to_the_card(sources):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune3d_main(ARCH + ["--train_paths", SET3D, "--epochs", "1"])


@pytest.fixture(scope="module")
def pth3d(tmp_path_factory):
    model = build_model("DPOT3D", device="cpu", seed=3, **CFG)
    path = tmp_path_factory.mktemp("eval3d") / "dpot3d.pth"
    torch.save({"model": model.state_dict()}, path)
    return model, str(path)


EVAL = ["--model", "DPOT"] + ARCH + ["--test_paths", SET3D, "--batch_size", "2",
                                     "--num_workers", "2", "--device", "cpu"]


def test_evaluate_cli_on_a_3d_set_matches_the_jax_evaluator(pth3d):
    """A DPOT model named on a 3D set becomes DPOT3D, pred-only, and the 3D
    metric battery runs: every number within 1e-5 of the JAX evaluator's."""
    model, path = pth3d
    got = evaluate_main(EVAL + ["--resume_path", path, "--metrics"])
    want = jax_evaluator.evaluate(
        jax_build_model("DPOT3D", **CFG), jax_params_of(model), [SET3D], res=16, t_in=3,
        batch_size=2, n_channels=2, num_workers=2, full_metrics=True, pred_only=True)
    assert set(got[SET3D]) == set(want[SET3D]) == {
        "loss_step", "loss_full", "nmae", "nmse", "nmxe", "bdmse", "fmse_low", "fmse_mid"}
    for k, w in want[SET3D].items():
        np.testing.assert_allclose(got[SET3D][k], w, rtol=1e-5, err_msg=k)


def test_convert_dpot3d_gives_a_directory_that_evaluates(pth3d, tmp_path):
    _, path = pth3d
    out = str(tmp_path / "ckpt3d")
    convert_main(["--model", "DPOT3D"] + ARCH + ["--n_channels", "2", "--resume_path", path,
                                                 "--out_path", out, "--device", "cpu"])
    obj = torch.load(f"{out}/model.pth", map_location="cpu", weights_only=False)
    assert obj["step"] == 0 and obj["model"]["pos_embed"].shape == (1, 32, 4, 4, 4)
    a = evaluate_main(EVAL + ["--resume_path", path])
    b = evaluate_main(["--config_from_ckpt", "true", "--resume_path", out, "--test_paths",
                       SET3D, "--batch_size", "2", "--num_workers", "2", "--device", "cpu"])
    assert a[SET3D] == b[SET3D]


def test_sweep_runs_the_finetune3d_script(sources, tmp_path):
    """A sweep file naming dpot_tpu.cli.finetune3d runs the port's CLI: two
    jobs (an lr axis) in this process."""
    _, pth, _ = sources
    doc = {"script": "dpot_tpu.cli.finetune3d", "train_paths": [SET3D], "resume_path": pth,
           "tasks": {"res": [16], "patch_size": [4], "width": [32], "n_layers": [2],
                     "n_blocks": [4], "modes": [4], "T_in": [3], "batch_size": [2],
                     "epochs": [1], "warmup_epochs": [1], "num_workers": [1],
                     "lr": [1e-3, 5e-4]}}
    path = tmp_path / "ft3d.yaml"
    path.write_text(yaml.safe_dump(doc))
    outs = sweep.main(["--config_file", str(path), "--device", "cpu"])
    assert len(outs) == 2
    assert all(len(o["copied"]) == 12 * CFG["depth"] + 2 for o in outs)
    assert all(np.isfinite(o["train_l2_step"]).all() for o in outs)

"""Fine-tuning in the port: component surgery (train/checkpoint.py
load_components), the position-embedding resize (train/interop.py), the
loop's warm starts (init_from, init_state_dict) and cli/finetune.py, on the
CPU at a small size, against the JAX package where it has the same
function.

The JAX side needs no model run: the port's seeded state dicts are carried
into JAX params by `dpot_params_from_torch`, and JAX's merge comes back
through `state_dict_from_jax`.
"""

import numpy as np
import pytest
import torch

from dpot_tpu.train.checkpoint import load_components as jax_load_components
from dpot_tpu.train.interop import dpot_params_from_torch, resize_pos_embed_nhwc
from dpot_tpu_torch.cli.finetune import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.train.checkpoint import COMPONENT_PREFIXES, load_components
from dpot_tpu_torch.train.interop import resize_pos_embed, state_dict_from_jax
from dpot_tpu_torch.utils.config import TrainConfig

SMALL = dict(img_size=16, patch_size=4, in_timesteps=4, embed_dim=16, n_blocks=2,
             modes=4, n_cls=1)


def state_dict(depth, channels, seed, **kw):
    m = build_model("DPOT", device="cpu", seed=seed, depth=depth, in_channels=channels,
                    **{**SMALL, **kw})
    return m.state_dict()


def jax_params(sd, depth):
    return dpot_params_from_torch({k: v.numpy() for k, v in sd.items()}, depth=depth,
                                  normalize="scale_feats_mu.weight" in sd)


PAIRS = {
    # target and source: depth, channels, extra model arguments
    "channels": ((11, 3, {}), (11, 4, {})),
    "depth": ((11, 4, {}), (2, 4, {})),
    "cls_head": ((3, 4, dict(n_cls=1)), (3, 4, dict(n_cls=12))),
    "normalize": ((2, 3, dict(normalize=True)), (2, 4, dict(normalize=True))),
}


@pytest.mark.parametrize("components", [("blocks", "pos", "time_agg"), ("all",), "all",
                                        ("out", "cls_head", "scale_feats", "patch_embed")])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_load_components_matches_jax(pair, components):
    """The units copied, under their JAX names, and the merged weights equal
    JAX's for the same pair; depth 11 puts blocks.1. beside blocks.10."""
    (td, tc, tkw), (sd_, sc, skw) = PAIRS[pair]
    target, source = state_dict(td, tc, 1, **tkw), state_dict(sd_, sc, 2, **skw)
    merged, copied = load_components(target, source, components)
    jmerged, jcopied = jax_load_components(jax_params(target, td), jax_params(source, sd_),
                                           components)
    assert sorted(copied) == sorted(jcopied) and len(copied) == len(set(copied))
    want = state_dict_from_jax(jmerged)
    assert set(merged) == set(want) == set(target)
    for k, v in want.items():
        assert torch.equal(merged[k], v), k
    if pair == "channels" and components in ("all", ("all",)):
        assert "blocks_10" in copied and "blocks_1" in copied
        assert "patch_embed" not in copied and "out_conv2" not in copied


def test_load_components_leaves_the_target_alone():
    target, source = state_dict(2, 3, 1), state_dict(2, 3, 2)
    before = {k: v.clone() for k, v in target.items()}
    merged, copied = load_components(target, source, "all")
    assert len(copied) == 2 + 2 + 3 + 3 + 1  # blocks, pos/time_agg, heads, out, patch
    assert all(torch.equal(target[k], before[k]) for k in target)
    assert all(torch.equal(merged[k], source[k]) for k in merged)


def test_component_names_are_jax_s():
    from dpot_tpu.train.checkpoint import COMPONENT_PREFIXES as JAX_PREFIXES

    assert set(COMPONENT_PREFIXES) == set(JAX_PREFIXES)


@pytest.mark.parametrize("size", [(8, 8), (4, 6), (12, 12)])
def test_resize_pos_embed_matches_jax(size):
    pos = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 16, 8, 8))
                           .astype(np.float32))
    got = resize_pos_embed(pos, *size)
    want = resize_pos_embed_nhwc(pos.permute(0, 2, 3, 1).numpy(), *size)
    assert got.shape == (1, 16, *size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


TINY = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "16",
        "--n_layers", "2", "--n_blocks", "2", "--modes", "4", "--T_in", "4",
        "--batch_size", "4", "--num_workers", "2", "--warmup_epochs", "1",
        "--use_writer", "true", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _specs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec("synthetic_tft3", train_size=8, test_size=4, t_total=10, t_test=3,
                        in_size=(16, 16), n_channels=3)
    make_synthetic_spec("synthetic_tft2", train_size=8, test_size=4, t_total=10, t_test=3,
                        in_size=(16, 16), n_channels=2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def source_run(tmp_path_factory):
    """A 2-channel pretraining run whose checkpoint directory is the source."""
    from dpot_tpu_torch.cli.train import main as train_main

    out = train_main(TINY + ["--train_paths", "synthetic_tft2", "--epochs", "1",
                             "--log_path", str(tmp_path_factory.mktemp("src"))])
    return out


def test_init_from_is_a_params_only_warm_start(source_run, tmp_path):
    """The run's first step sees the checkpoint's weights, zero moments, an
    optimizer count of 0 and step 0."""
    src = f"{source_run['log_dir']}/model"
    cfg = TrainConfig(model="DPOT", train_paths=["synthetic_tft2"], res=16, patch_size=4,
                      width=16, n_layers=2, n_blocks=2, modes=4, T_in=4, batch_size=4,
                      num_workers=1, epochs=1, warmup_epochs=1, init_from=src)
    seen = {}
    real = loop.make_train_step

    def spy(**kw):
        step = real(**kw)

        def first(state, batch):
            if not seen:
                opt = state.optimizer
                seen.update(step=state.step, count=int(opt.count),
                            moments=all(not m.any() for m in (*opt.mu, *opt.nu)),
                            params={k: v.clone() for k, v in state.model.state_dict().items()})
            return step(state, batch)

        return first

    loop.make_train_step = spy
    try:
        loop.train(cfg, device="cpu")
    finally:
        loop.make_train_step = real
    assert seen["step"] == 0 and seen["count"] == 0 and seen["moments"]
    for k, v in source_run["model"].state_dict().items():
        assert torch.equal(seen["params"][k], v), k


def test_init_state_dict_outranks_resume_and_init_from(source_run):
    model = build_model("DPOT", device="cpu", seed=9, depth=2, in_channels=2, **SMALL)
    sd = model.state_dict()
    cfg = TrainConfig(model="DPOT", train_paths=["synthetic_tft2"], res=16, patch_size=4,
                      width=16, n_layers=2, n_blocks=2, modes=4, T_in=4, batch_size=4,
                      num_workers=1, epochs=1, lr=0.0, warmup_epochs=1,
                      resume_path=f"{source_run['log_dir']}/model",
                      init_from=f"{source_run['log_dir']}/model")
    out = loop.train(cfg, device="cpu", init_state_dict=sd)
    assert out["state"].step == 2  # one epoch of two steps from step 0
    for k, v in out["model"].state_dict().items():
        assert torch.allclose(v, sd[k], atol=1e-6), k


def test_cli_finetunes_a_checkpoint_with_another_channel_count(source_run, tmp_path,
                                                               capsys):
    """A 2-channel source into a 3-channel target: every unit whose shapes
    do not depend on the channel count is copied, and training starts from
    the merge."""
    out = main(TINY + ["--train_paths", "synthetic_tft3", "--epochs", "1",
                       "--load_components", "all", "--log_path", str(tmp_path),
                       "--resume_path", f"{source_run['log_dir']}/model"])
    want = ["blocks_0", "blocks_1", "pos_embed", "time_agg", "cls_head_0", "cls_head_1",
            "cls_head_2", "out_deconv", "out_conv1"]
    assert sorted(out["copied"]) == sorted(want)
    assert "loaded components ['all']: 9 units" in capsys.readouterr().out
    assert out["state"].step == 2 and np.isfinite(out["test_l2_fulls"]).all()


def test_cli_without_a_source_trains_from_scratch(tmp_path):
    out = main(TINY + ["--train_paths", "synthetic_tft3", "--epochs", "1",
                       "--log_path", str(tmp_path)])
    assert "copied" not in out and out["state"].step == 2


def test_cuda_is_the_default_device(source_run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--train_paths", "synthetic_tft3", "--epochs", "1",
                     "--resume_path", f"{source_run['log_dir']}/model"])

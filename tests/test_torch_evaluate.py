"""The port's evaluation (dpot_tpu_torch/utils/criterion.py's metric battery,
ops/spectral.py's spectral resize, train/evaluator.py, cli/evaluate.py)
against the JAX package's, on the CPU at a small size.

Inputs come from numpy seeds and go to both packages; the models share the
port's seeded weights, carried into JAX by `dpot_params_from_torch`; the
synthetic test sets are registered in both registries and give the same
batches bit for bit. Tolerances: the metric battery and the resize are the
same f32 arithmetic in another order (1e-5 relative); the evaluations run
a whole model, held at the repo's interop bar of 2e-4 (PARITY.md:16).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpot_tpu.data import registry as jax_registry
from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.ops.spectral import resize_temporal as jax_resize_temporal
from dpot_tpu.ops.spectral import spectral_resize as jax_spectral_resize
from dpot_tpu.train import evaluator as jax_evaluator
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.utils import criterion as jax_criterion
from dpot_tpu_torch.cli.evaluate import main
from dpot_tpu_torch.data import registry
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.spectral import resize_temporal, spectral_resize
from dpot_tpu_torch.train import evaluator
from dpot_tpu_torch.utils import criterion

RTOL = 1e-5
BAR = 2e-4
CFG = dict(img_size=32, patch_size=4, in_channels=3, out_channels=3, in_timesteps=6,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=1)
EVAL_SET = "synthetic_torch_eval"


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """Two torch threads; the test set (2 channels, so that a model of 3
    has a fully masked one) in both registries."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    kw = dict(name=EVAL_SET, train_path="", test_path="", train_size=4, test_size=6,
              scatter_storage=False, t_test=4, t_in=10, t_total=12, in_size=(32, 32),
              n_channels=2, downsample=(1, 1), synthetic=True)
    registry.register_dataset(registry.DatasetSpec(**kw))
    fields = {f.name for f in dataclasses.fields(jax_registry.DatasetSpec)}
    jax_registry.register_dataset(
        jax_registry.DatasetSpec(**{k: v for k, v in kw.items() if k in fields}))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _numpy_host_paths(monkeypatch):
    """Both packages' numpy host paths, which give the same batches bit for
    bit (the native resize rounds differently from numpy; native against
    native is tests/test_torch_native.py and test_torch_loader_native.py)."""
    import dpot_tpu.native.preprocess as pre
    import dpot_tpu_torch.native.preprocess as port_pre

    monkeypatch.setattr(pre, "get_library", lambda: None)
    monkeypatch.setattr(port_pre, "get_library", lambda: None)


@pytest.fixture(scope="module")
def models():
    model = build_model("DPOT", device="cpu", seed=4, **CFG)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = dpot_params_from_torch(sd, depth=CFG["depth"])
    return model, jax_build_model("DPOT", **CFG), params


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def fields(rank, seed, masked_channel=True):
    """pred and target (B, spatial..., T, C) with channel 2 masked out
    (zero in both) when asked."""
    rng = np.random.default_rng(seed)
    shape = (2,) + (24,) * rank + (3, 3)
    p = rng.standard_normal(shape).astype(np.float32)
    t = (1.0 + rng.standard_normal(shape)).astype(np.float32)
    if masked_channel:
        p[..., 2] = t[..., 2] = 0.0
    return p, t


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_metric_battery_matches_jax(rank):
    """evaluator_metrics (with temporal), boundary RMSE and the three
    spectral bands per rank, and the 2D lp/relative-lp/RFNE metrics; a
    fully masked channel gives NaN in the same places in both."""
    p, t = fields(rank, rank)
    tp, tt, jp, jt = torch.from_numpy(p), torch.from_numpy(t), jnp.asarray(p), jnp.asarray(t)
    got = criterion.evaluator_metrics(tp, tt, temporal=True)
    want = jax_criterion.evaluator_metrics(jp, jt, temporal=True)
    assert set(got) == set(want) == {"nmae", "nmse", "nmxe", "nmae_t", "nmse_t", "nmxe_t"}
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.array_equal(np.isnan(g), np.isnan(w)) and np.isnan(w[..., 2]).all()
        close(g[..., :2], w[..., :2], RTOL)
    name = {1: "1d", 2: "2d", 3: "3d"}[rank]
    close(getattr(criterion, f"boundary_rmse_{name}")(tp, tt),
          getattr(jax_criterion, f"boundary_rmse_{name}")(jp, jt), RTOL)
    for g, w in zip(getattr(criterion, f"spectral_band_mse_{name}")(tp, tt),
                    getattr(jax_criterion, f"spectral_band_mse_{name}")(jp, jt)):
        assert g.shape == w.shape == (3, 3)
        close(g, w, RTOL)
    if rank == 2:
        p, t = fields(2, 9, masked_channel=False)
        for fn in ("lp_metric", "rel_lp_metric", "rfne_loss"):
            close(getattr(criterion, fn)(torch.from_numpy(p), torch.from_numpy(t)),
                  getattr(jax_criterion, fn)(jnp.asarray(p), jnp.asarray(t)), RTOL)
        close(criterion.rel_lp_metric(torch.from_numpy(p), torch.from_numpy(t), p=1,
                                      per_channel=True),
              jax_criterion.rel_lp_metric(jnp.asarray(p), jnp.asarray(t), p=1,
                                          per_channel=True), RTOL)


def test_spectral_bands_of_a_small_grid_are_nan_past_its_bins():
    """On a 12-px grid there are 6 radial bins: the high band (from bin 12)
    is empty and NaN, as in JAX, where the evaluator leaves its key out."""
    p, t = fields(2, 5, masked_channel=False)
    p, t = p[:, :12, :12], t[:, :12, :12]
    lo, mid, hi = criterion.spectral_band_mse_2d(torch.from_numpy(p), torch.from_numpy(t))
    assert torch.isfinite(lo).all() and torch.isfinite(mid).all() and torch.isnan(hi).all()


@pytest.mark.parametrize("size_in,size_out", [(32, 41), (41, 32), (50, 50), (41, 128),
                                              (128, 59)])
def test_spectral_resize_matches_jax(size_in, size_out):
    """Odd and even sizes both ways: the band copy, the Nyquist column an odd
    grid gains or loses, the amplitude factor. Channels-last
    resize_temporal and the last-two-axes spectral_resize."""
    rng = np.random.default_rng(size_in * 1000 + size_out)
    x = rng.standard_normal((2, size_in, size_in, 3, 2)).astype(np.float32)
    got = resize_temporal(torch.from_numpy(x), (size_out, size_out))
    assert got.shape == (2, size_out, size_out, 3, 2) and got.dtype == torch.float32
    close(got, jax_resize_temporal(jnp.asarray(x), (size_out, size_out)), RTOL)
    x2 = rng.standard_normal((2, 3, size_in, size_in + 1)).astype(np.float32)
    close(spectral_resize(torch.from_numpy(x2), (size_out, size_out + 2)),
          jax_spectral_resize(jnp.asarray(x2), (size_out, size_out + 2)), RTOL)


def test_spectral_resize_keeps_bf16():
    x = torch.randn(1, 8, 8, 2, 1).to(torch.bfloat16)
    assert resize_temporal(x, (11, 11)).dtype == torch.bfloat16


def test_refill_mask_matches_jax_exactly():
    msk = np.zeros((2, 8, 8, 1, 3), np.float32)
    msk[:, ::2, ::2, :, :2] = 1.0
    msk[1, :, :, :, 1] = 0.0
    got = evaluator.refill_mask(torch.from_numpy(msk), 13).numpy()
    want = np.asarray(jax_evaluator.refill_mask(jnp.asarray(msk), 13))
    assert got.shape == (2, 13, 13, 1, 3)
    np.testing.assert_array_equal(got, want)


def test_evaluate_matches_jax(models):
    """loss_step, loss_full and every key of the metric battery over three
    batches (6 trajectories, batch 2), with a third channel that only the
    model has (masked out)."""
    model, jm, params = models
    kw = dict(res=32, t_in=6, batch_size=2, n_channels=3, num_workers=2, full_metrics=True)
    got = evaluator.evaluate(model, [EVAL_SET], **kw)
    want = jax_evaluator.evaluate(jm, params, [EVAL_SET], **kw)
    assert set(got[EVAL_SET]) == set(want[EVAL_SET]) == {
        "loss_step", "loss_full", "nmae", "nmse", "nmxe", "bdmse", "fmse_low",
        "fmse_mid", "fmse_high"}
    for k, w in want[EVAL_SET].items():
        assert np.isfinite(got[EVAL_SET][k]), k
        np.testing.assert_allclose(got[EVAL_SET][k], w, rtol=BAR, err_msg=k)
    assert got["avg_step_time"] > 0


def test_evaluate_varying_resolution_matches_jax(models):
    model, jm, params = models
    kw = dict(model_res=32, t_in=6, batch_size=3, n_channels=3, res_list=[23, 32],
              num_workers=2)
    got = evaluator.evaluate_varying_resolution(model, [EVAL_SET], **kw)
    want = jax_evaluator.evaluate_varying_resolution(jm, params, [EVAL_SET], **kw)
    assert list(got) == list(want) == [23, 32]
    for res in want:
        for k, w in want[res][EVAL_SET].items():
            np.testing.assert_allclose(got[res][EVAL_SET][k], w, rtol=BAR,
                                       err_msg=f"{res} {k}")


def test_avg_step_time_skips_the_first_batch_of_each_shape(models):
    model = models[0]
    one = evaluator.evaluate(model, [EVAL_SET], res=32, t_in=6, batch_size=6,
                             n_channels=3, num_workers=1)
    assert one["avg_step_time"] == 0.0 and np.isfinite(one[EVAL_SET]["loss_full"])


def test_default_sweep_resolutions():
    assert evaluator.VARYRES_LIST == (32, 41, 50, 59, 68, 77, 86, 95, 104, 113, 122)


CLI = ["--model", "DPOT", "--res", "32", "--patch_size", "4", "--width", "32",
       "--n_layers", "2", "--n_blocks", "4", "--modes", "4", "--T_in", "6",
       "--test_paths", EVAL_SET, "--batch_size", "3", "--num_workers", "2"]


@pytest.fixture(scope="module")
def pth(models, tmp_path_factory):
    """The shared model's weights as a reference-layout .pth, with the DDP
    prefix the released files carry; the model has 2 channels here, as
    the CLI builds it from the test set."""
    model = build_model("DPOT", device="cpu", seed=4, **{**CFG, "in_channels": 2,
                                                         "out_channels": 2})
    path = tmp_path_factory.mktemp("eval") / "w.pth"
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    return model, str(path)


@pytest.mark.parametrize("flags", [[], ["--metrics"], ["--varyres"]])
def test_cli_on_the_cpu(pth, flags, capsys):
    """The CLI loads the .pth into a model built from its flags and prints a
    line per dataset and the results as JSON, which equal the library
    call's."""
    model, path = pth
    got = main(CLI + ["--resume_path", path, "--device", "cpu"] + flags)
    if flags == ["--varyres"]:
        assert list(got) == list(evaluator.VARYRES_LIST)
        assert all(np.isfinite(v[EVAL_SET]["loss_full"]) for v in got.values())
        assert f"res 122, {EVAL_SET}:" in capsys.readouterr().out
        return
    want = evaluator.evaluate(model, [EVAL_SET], res=32, t_in=6, batch_size=3,
                              num_workers=2, full_metrics=bool(flags))
    for k, w in want[EVAL_SET].items():
        np.testing.assert_allclose(got[EVAL_SET][k], w, rtol=1e-6, err_msg=k)
    assert ("fmse_high" in got[EVAL_SET]) == bool(flags)
    assert '"avg_step_time"' in capsys.readouterr().out


def test_cli_rejects_what_is_not_ported(pth, tmp_path):
    """--viz_dir, the last option ported, writes the JAX evaluator's files
    (nothing where matplotlib is absent); the sweep refuses a 3D set, and
    the CLI a mixture of 2D and 3D sets or no checkpoint."""
    _, path = pth
    base = CLI + ["--resume_path", path, "--device", "cpu"]
    main(base + ["--viz_dir", str(tmp_path / "viz")])
    from dpot_tpu_torch.utils.viz import _plt

    want = [f"{EVAL_SET}_rollout.gif", f"{EVAL_SET}_rollout.png"] if _plt() else []
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == want
    registry.make_synthetic_spec("synthetic_torch_eval3d", in_size=(8, 8, 8), n_channels=2)
    with pytest.raises(SystemExit):
        main(base + ["--test_paths", "synthetic_torch_eval3d", "--varyres"])
    with pytest.raises(SystemExit):
        main(base + ["--test_paths", EVAL_SET, "synthetic_torch_eval3d"])
    with pytest.raises(SystemExit, match="resume_path"):
        main(CLI + ["--device", "cpu"])


def test_cli_shape_mismatch_names_both_sizes(pth):
    """A checkpoint whose widths do not match the flags raises (the strict
    load_state_dict), naming the key and both shapes."""
    _, path = pth
    argv = list(CLI)
    argv[argv.index("--width") + 1] = "64"
    with pytest.raises(RuntimeError, match=r"pos_embed: copying a param with shape "
                                           r"torch.Size\(\[1, 32, 8, 8\]\) from checkpoint, "
                                           r"the shape in current model is "
                                           r"torch.Size\(\[1, 64, 8, 8\]\)"):
        main(argv + ["--resume_path", path, "--device", "cpu"])


def test_cuda_is_the_default_device(pth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(CLI + ["--resume_path", pth[1]])

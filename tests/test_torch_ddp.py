"""The port's data-parallel training (dpot_tpu_torch/parallel, DDP) on 2 gloo
ranks on the CPU, held against one process and against the JAX package.

The ranks run tests/torch_dist_cases.py under a time limit. The tiny DPOT
trains on 13 samples in batches of 8, so every epoch ends with a 5-sample
tail that does not divide over the 2 ranks, which every rank computes
whole; with noise injection and grad_accum = 2 the 2-rank run must compute
what one process computes (1e-5, f32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_cases import SPEC, TINY, launch

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from dpot_tpu.train.state import TrainState as JaxTrainState
from dpot_tpu.train.step import make_train_step as jax_train_step
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data import DataLoader, MixedTemporalDataset
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.parallel import shard_rows
from dpot_tpu_torch.parallel.mesh import check_mesh_data
from dpot_tpu_torch.train import loop
from dpot_tpu_torch.train.interop import state_dict_from_jax
from dpot_tpu_torch.train.optimizers import build_optimizer
from dpot_tpu_torch.train.state import TrainState
from dpot_tpu_torch.train.step import UNTRAINED, make_train_step
from dpot_tpu_torch.utils.config import TrainConfig

NAME = "synthetic_ddp"
TOL = 1e-5
ARGV = TINY + ["--train_paths", NAME, "--noise_scale", "0.01", "--grad_accum", "2",
               "--use_writer", "true"]


@pytest.fixture(autouse=True, scope="module")
def _spec():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(NAME, **SPEC)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def step_losses(log_dir) -> list[float]:
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "train_loss_step"]


def assert_same_run(got: dict, want: dict) -> None:
    """History and final weights of a rank against one process's run."""
    for k in ("train_l2_step", "train_l2_full"):
        assert abs(got["history"][k] - want[k]) <= TOL * abs(want[k]), k
    for k in ("test_l2_steps", "test_l2_fulls"):
        np.testing.assert_allclose(got["history"][k], want[k], rtol=TOL)
    sd = want["state"].params_state_dict()
    assert sorted(got["params"]) == sorted(sd)
    for name, v in sd.items():
        assert rel(got["params"][name], v) <= TOL, name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process: epoch 1, then a resume to epoch 2 from its checkpoint.
    Two DDP ranks: epoch 1 from scratch, then the same resume from the
    single process's checkpoint (a checkpoint crossing from 1 rank to 2)."""
    tmp = tmp_path_factory.mktemp("ddp")
    s1 = main(ARGV + ["--epochs", "1", "--log_path", str(tmp / "s1")])
    ckpt = f"{s1['log_dir']}/model"
    s2 = main(ARGV + ["--epochs", "2", "--log_path", str(tmp / "s2"), "--resume_path", ckpt])
    argvs = [ARGV + ["--epochs", "1", "--log_path", str(tmp / "d1")],
             ARGV + ["--epochs", "2", "--log_path", str(tmp / "d2"), "--resume_path", ckpt]]
    ranks = launch("train", tmp, {"runs": argvs, "specs": {NAME: SPEC}})
    return tmp, (s1, s2), ranks


def test_ddp_train_equals_one_process(runs):
    """Per-step losses, epoch metrics and final weights of both ranks within
    1e-5 of one process, the tail replicated on every rank (one train and
    one eval tail an epoch), and the DDP wrapper in the step."""
    tmp, (s1, _), ranks = runs
    for r in ranks:
        got = r["runs"][0]
        assert got["ddp"] == "DistributedDataParallel" and got["step"] == s1["state"].step == 2
        assert_same_run(got, s1)
        assert got["fallbacks"] == 2
    d1 = ranks[0]["runs"][0]["log_dir"]
    np.testing.assert_allclose(step_losses(d1), step_losses(s1["log_dir"]), rtol=TOL)


def test_rank0_alone_writes_the_reference_layout(runs):
    """Rank 0 writes the checkpoint, whose keys are the module's own (no DDP
    'module.' prefix); rank 1 writes nothing."""
    tmp, (s1, _), ranks = runs
    assert ranks[1]["runs"][0]["log_dir"] is None
    assert len(list((tmp / "d1").iterdir())) == 1
    ck = torch.load(f"{ranks[0]['runs'][0]['log_dir']}/model/model.pth", weights_only=False)
    assert list(ck["model"]) == list(s1["state"].model.state_dict())
    for name, v in s1["state"].params_state_dict().items():
        assert rel(ck["model"][name], v) <= TOL, name


def test_one_process_checkpoint_resumes_on_two_ranks(runs):
    _, (_, s2), ranks = runs
    for r in ranks:
        assert r["runs"][1]["step"] == s2["state"].step == 4
        assert_same_run(r["runs"][1], s2)


def test_replicas_are_bit_equal_over_the_ranks(runs):
    """check_replica_consistency over the 2 DDP ranks compares every
    parameter and buffer and finds them equal; a one-ulp change in rank 1's
    copy of one parameter raises on both ranks, naming it."""
    _, (s1, _), ranks = runs
    model = s1["state"].model
    n = len(list(model.parameters())) + len(list(model.buffers()))
    first = next(iter(model.named_parameters()))[0]
    for r in ranks:
        for run in r["runs"]:
            assert run["replicas"]["compared"] == n
            assert run["replicas"]["control"] == f"replica mismatch at {first}"


def test_tail_goes_whole_to_every_shard(monkeypatch):
    """An uneven batch (the 5-sample tail) goes whole to both shards, an
    even one splits in halves; shard_rows counts the fallback."""
    ds = MixedTemporalDataset([NAME], res=16, t_in=6, t_ar=1, train=True)
    kw = dict(batch_size=8, num_workers=1, seed=3, prefetch=0, slot_ring=0)
    whole = [tuple(np.array(a) for a in b) for b in DataLoader(ds, **kw)]
    shards = [[tuple(np.array(a) for a in b) for b in DataLoader(ds, num_shards=2,
                                                                 shard_index=i, **kw)]
              for i in range(2)]
    assert [len(b[0]) for b in whole] == [8, 5] == loop.global_sizes(DataLoader(ds, **kw))
    for i in range(2):
        assert len(DataLoader(ds, num_shards=2, shard_index=i, **kw)) == 2
        assert [len(b[0]) for b in shards[i]] == [4, 5]
        for k in range(4):
            np.testing.assert_array_equal(shards[i][1][k], whole[1][k])
            np.testing.assert_array_equal(shards[i][0][k], whole[0][k][4 * i:4 * i + 4])
    monkeypatch.setattr(shard_rows, "fallbacks", 0)
    assert shard_rows(8, 1, 2) == slice(4, 8) and shard_rows.fallbacks == 0
    with pytest.warns(UserWarning, match="does not divide"):
        assert shard_rows(5, 1, 2) is None
    assert shard_rows.fallbacks == 1


@pytest.mark.parametrize("cfg,data", [
    (dict(shard_params="tp"), 2),
    (dict(shard_params="tp_fsdp", mesh_model=2), 1),
    (dict(mesh_pipe=2), 1),
    (dict(mesh_model=2), 1),
    (dict(mesh_spatial=2), 1),
])
def test_unported_layouts_raise(cfg, data):
    """The layouts of item 12's second half, refused until they were ported,
    are accepted at a world size that their axes make, and leave the data
    axis what the others leave of it; at a world size they do not make,
    they raise."""
    config = TrainConfig(model="DPOT", train_paths=[NAME], **cfg)
    loop.check_ported(config, world=2)
    others = config.mesh_spatial * config.mesh_model * config.mesh_pipe
    assert check_mesh_data(config.mesh_data, 2, others) == data
    if others > 1:
        with pytest.raises(ValueError, match="do not make the 3 ranks"):
            loop.check_ported(config, world=3)


def test_refused_combinations():
    """What the JAX loop asserts against: K-step dispatches over several
    ranks, or with spatial sharding, pipe with spatial; a mesh_data that is
    not the world size; DPOT3D and CDPOT over 'spatial' or 'pipe' (JAX's
    models take no such mesh); and the port's own refusals: FSDP or a
    placement without a process group, an unknown shard_params. The
    layouts combined, fsdp over another axis, the other families over the
    model axes and viz_dir over ranks are accepted, as the JAX package
    runs them."""
    cfg = dict(model="DPOT", train_paths=[NAME])
    with pytest.raises(ValueError, match="single-process only"):
        loop.check_ported(TrainConfig(steps_per_dispatch=2, **cfg), world=2)
    loop.check_ported(TrainConfig(steps_per_dispatch=2, **cfg), world=1)
    with pytest.raises(ValueError, match="spatial"):
        loop.check_ported(TrainConfig(steps_per_dispatch=2, mesh_spatial=2, **cfg))
    with pytest.raises(ValueError, match="cannot combine"):
        loop.check_ported(TrainConfig(mesh_pipe=2, mesh_spatial=2, **cfg), world=4)
    for combo in (dict(mesh_model=2, mesh_spatial=2), dict(shard_params="tp", mesh_pipe=2),
                  dict(shard_params="tp_fsdp", mesh_model=2, mesh_spatial=2, mesh_data=1)):
        loop.check_ported(TrainConfig(**combo, **cfg), world=4)
    with pytest.raises(RuntimeError, match="process group"):  # past every refusal
        loop.check_ported(TrainConfig(shard_params="fsdp", mesh_model=2, **cfg), world=4)
    for family in ("UNet", "FNO", "CDPOT", "DPOT3D"):
        loop.check_ported(TrainConfig(**{**cfg, "model": family}, mesh_model=2), world=2)
    for family in ("CDPOT", "DPOT3D"):
        for axis in ("mesh_spatial", "mesh_pipe"):
            with pytest.raises(ValueError, match="as in the JAX package"):
                loop.check_ported(TrainConfig(**{**cfg, "model": family}, **{axis: 2}), world=2)
    loop.check_ported(TrainConfig(viz_dir="viz", **cfg), world=2)
    with pytest.raises(ValueError, match="mesh_data=3"):
        check_mesh_data(3, 2)
    assert check_mesh_data(None, 2) == check_mesh_data(2, 2) == 2
    with pytest.raises(ValueError, match="unknown shard_params"):
        TrainConfig(shard_params="zero3", **cfg)
    unet = build_model("UNet", img_size=16, in_channels=2, out_channels=2, in_timesteps=4,
                       out_layer_dim=4, n_cls=1, device="cpu")
    state = TrainState.create(unet, build_optimizer("adam", unet.parameters(), 1e-3), 0)
    with pytest.raises(RuntimeError, match="process group"):
        loop.place_state(state, TrainConfig(**cfg), torch.device("cpu"))
    dpot = build_model("DPOT", img_size=16, patch_size=4, in_channels=2, in_timesteps=4,
                       embed_dim=32, depth=1, n_blocks=4, modes=4, device="cpu")
    state = TrainState.create(dpot, build_optimizer("adam", dpot.parameters(), 1e-3), 0)
    with pytest.raises(RuntimeError, match="process group"):
        loop.place_state(state, TrainConfig(shard_params="fsdp", **cfg), torch.device("cpu"))


FAMILIES = {
    "DPOT": dict(img_size=16, patch_size=4, in_channels=2, in_timesteps=4, embed_dim=32,
                 depth=1, n_blocks=4, modes=4, n_cls=2),
    "CDPOT": dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
                  embed_dim=32, depth=1, n_blocks=4, modes=4, out_layer_dim=8, n_cls=2),
    "DPOT3D": dict(img_size=8, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
                   embed_dim=16, depth=1, n_blocks=2, modes=2, out_layer_dim=8),
    "FNO": dict(img_size=16, patch_size=1, in_channels=2, in_timesteps=4, embed_dim=16,
                depth=1, modes=4, n_cls=2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_untrained_parameters_are_the_class_head(family):
    """The parameters that the loss does not reach, which DDP must leave out
    of its reducer: exactly those under train/step.py UNTRAINED (the class
    head), for every family with one."""
    model = build_model(family, device="cpu", **FAMILIES[family])
    grid = (8, 8, 8) if family == "DPOT3D" else (16, 16)
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((2, *grid, 4, 2), np.float32)),
             "y": torch.from_numpy(rng.standard_normal((2, *grid, 1, 2), np.float32)),
             "msk": torch.ones((2, *grid, 1, 2)), "cls": torch.zeros(2, dtype=torch.int64)}
    state = TrainState.create(model, build_optimizer("adam", model.parameters(), 1e-3), 0)
    make_train_step()(state, batch)
    none = sorted(n for n, p in model.named_parameters() if p.grad is None)
    assert none == sorted(n for n, _ in model.named_parameters() if n.startswith(UNTRAINED))


JCFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
            out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)


def test_two_rank_step_matches_jax(tmp_path):
    """Weights carried over from the JAX package (state_dict_from_jax), one
    adam step with the clip active on a global batch of 8 with external
    noise: each rank's rows through DDP and through FSDP2 give the loss and
    the weights of dpot_tpu's single-device make_train_step, within 2e-4."""
    jm = jax_build_model("DPOT", **JCFG)
    rng = np.random.default_rng(5)
    f = np.float32
    B = 8
    msk = np.ones((B, 16, 16, 1, 2), f)
    msk[0, ::2] = 0.0
    batch = dict(x=(1.0 + rng.standard_normal((B, 16, 16, 4, 2))).astype(f),
                 y=(1.0 + rng.standard_normal((B, 16, 16, 2, 2))).astype(f), msk=msk,
                 cls=rng.integers(0, 2, B).astype(np.int32),
                 noise=rng.standard_normal((2, B, 16, 16, 4, 2)).astype(f))
    # the JAX package's variables (from seeded weights; its own init takes
    # seconds to trace), carried over to the port by state_dict_from_jax
    seeded = build_model("DPOT", device="cpu", seed=3, **JCFG).state_dict()
    jvars = dpot_params_from_torch({k: v.numpy() for k, v in seeded.items()},
                                   depth=JCFG["depth"], normalize=False)
    sd = state_dict_from_jax(jax.device_get(jvars))
    torch.save(sd, tmp_path / "sd.pt")
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, tmp_path / "batch.pt")
    lr, clip, noise = 1e-3, 0.5, 0.05
    tx = jax_build_optimizer("adam", lr, grad_clip=clip)
    jstate = JaxTrainState.create(jm.apply, jvars, tx, jax.random.key(0))
    jstate, jaux = jax_train_step(noise_scale=noise, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(jaux["grad_norm"]) > clip
    want = state_dict_from_jax(jax.device_get(jstate.params))
    ranks = launch("step", tmp_path, {"sd": str(tmp_path / "sd.pt"),
                                      "batch": str(tmp_path / "batch.pt"), "cfg": JCFG,
                                      "lr": lr, "clip": clip, "noise": noise,
                                      "layouts": ["ddp", "fsdp"]})
    for r in ranks:
        for layout, out in r.items():
            for k in ("loss_step", "loss_full", "grad_norm"):
                assert abs(out["aux"][k] - float(jaux[k])) <= 2e-4 * abs(float(jaux[k])), \
                    (layout, k)
            for name, v in want.items():
                assert rel(out["params"][name], v) <= 2e-4, (layout, name)


def test_two_rank_noise_of_a_bf16_x_over_two_rollout_steps_equals_one_process(tmp_path):
    """Noise drawn from the state's generator for the global batch, with a
    bf16 x and 2 rollout steps: one process draws the first step's noise in
    bf16 and the second's in f32 (x is f32 once the f32 prediction joins
    it); each DDP rank's rows of the same draws give one process's step,
    loss and weights within 1e-5."""
    rng = np.random.default_rng(9)
    f = np.float32
    B = 8
    batch = {"x": torch.from_numpy((1.0 + rng.standard_normal((B, 16, 16, 4, 2))).astype(f))
             .to(torch.bfloat16),
             "y": torch.from_numpy((1.0 + rng.standard_normal((B, 16, 16, 2, 2))).astype(f)),
             "msk": torch.ones((B, 16, 16, 1, 2)),
             "cls": torch.from_numpy(rng.integers(0, 2, B))}
    sd = build_model("DPOT", device="cpu", seed=3, **JCFG).state_dict()
    torch.save(sd, tmp_path / "sd.pt")
    torch.save(batch, tmp_path / "batch.pt")
    lr, clip, noise = 1e-3, 0.5, 0.05
    model = build_model("DPOT", device="cpu", **JCFG)
    model.load_state_dict(sd)
    state = TrainState.create(
        model, build_optimizer("adam", model.parameters(), lr, grad_clip=clip), seed=0)
    state, aux = make_train_step(noise_scale=noise)(state, batch)
    assert float(aux["n_steps"]) == 2
    want = state.params_state_dict()
    ranks = launch("step", tmp_path, {"sd": str(tmp_path / "sd.pt"),
                                      "batch": str(tmp_path / "batch.pt"), "cfg": JCFG,
                                      "lr": lr, "clip": clip, "noise": noise,
                                      "layouts": ["ddp"]})
    for r in ranks:
        out = r["ddp"]
        for k in ("loss_step", "loss_full", "grad_norm"):
            assert abs(out["aux"][k] - float(aux[k])) <= TOL * abs(float(aux[k])), k
        for name, v in want.items():
            assert rel(out["params"][name], v) <= TOL, name

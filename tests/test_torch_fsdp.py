"""The port's fully sharded training (dpot_tpu_torch/parallel/fsdp.py, FSDP2)
on 2 gloo ranks on the CPU, held against one process: lamb with the clip
active, remat and noise injection (1e-5, f32), checkpoints crossing from 2
ranks to 1 and from 1 to 2, every parameter and moment sharded, and the
bf16 weight cache of the Hopper kernels switched off under FSDP."""

import numpy as np
import pytest
import torch
from torch_dist_cases import SPEC, TINY, launch

from dpot_tpu.parallel.fsdp import shape_spec
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.ops.cuda import afno_fused
from dpot_tpu_torch.parallel.fsdp import _shard_dim, no_block_cache

NAME = "synthetic_fsdp"
TOL = 1e-5
ARGV = TINY + ["--train_paths", NAME, "--noise_scale", "0.01", "--opt", "lamb",
               "--grad_clip", "0.05", "--remat", "true", "--use_writer", "true"]


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


def assert_same_run(history: dict, params: dict, want: dict) -> None:
    for k in ("train_l2_step", "train_l2_full"):
        assert abs(history[k] - want[k]) <= TOL * abs(want[k]), k
    for k in ("test_l2_steps", "test_l2_fulls"):
        np.testing.assert_allclose(history[k], want[k], rtol=TOL)
    sd = want["state"].params_state_dict()
    assert list(params) == list(sd)
    for name, v in sd.items():
        assert rel(params[name], v) <= TOL, name


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process: epoch 1 (S1), then a resume to epoch 2 (S2). Two FSDP
    ranks: epoch 1 from scratch (F1), then a resume to epoch 2 from S1's
    checkpoint, then 2 epochs in one run without checkpoints. One process
    again: a resume to epoch 2 from F1's, and 2 epochs in one run."""
    tmp = tmp_path_factory.mktemp("fsdp")
    s1 = main(ARGV + ["--epochs", "1", "--log_path", str(tmp / "s1")])
    ckpt = f"{s1['log_dir']}/model"
    s2 = main(ARGV + ["--epochs", "2", "--log_path", str(tmp / "s2"), "--resume_path", ckpt])
    fsdp = ["--shard_params", "fsdp"]
    argvs = [ARGV + fsdp + ["--epochs", "1", "--log_path", str(tmp / "f1")],
             ARGV + fsdp + ["--epochs", "2", "--log_path", str(tmp / "f2"),
                            "--resume_path", ckpt],
             ARGV + fsdp + ["--epochs", "2", "--use_writer", "false"]]
    ranks = launch("train", tmp, {"runs": argvs, "specs": {NAME: SPEC}})
    back = main(ARGV + ["--epochs", "2", "--log_path", str(tmp / "b2"),
                        "--resume_path", f"{ranks[0]['runs'][0]['log_dir']}/model"])
    whole = main(ARGV + ["--epochs", "2", "--use_writer", "false"])
    return (s1, s2), ranks, back, whole


def test_fsdp_train_equals_one_process(runs):
    (s1, _), ranks, _, _ = runs
    for r in ranks:
        got = r["runs"][0]
        assert got["ddp"] == "FSDPDPOTNet" and got["step"] == s1["state"].step == 2
        assert_same_run(got["history"], got["params"], s1)


def test_two_epochs_without_checkpoints_equal_one_process(runs):
    """Two epochs in one run, with no checkpoint between them: the first
    step after an evaluation (a forward without backward, which leaves
    FSDP2's root weights gathered under inference mode) trains as in one
    process."""
    _, ranks, _, whole = runs
    for r in ranks:
        got = r["runs"][2]
        assert got["step"] == 4
        assert_same_run(got["history"], got["params"], whole)


def test_every_parameter_and_moment_is_sharded_and_the_weight_cache_is_off(runs):
    _, ranks, _, _ = runs
    for r in ranks:
        for got in r["runs"]:
            assert got["unsharded"] == []
            assert got["cache_blocks"] == [False]


def test_replica_check_skips_fsdp_shards(runs):
    """Every parameter is an FSDP2 shard, which check_replica_consistency
    skips (as JAX skips shards of different indices): nothing compared,
    no mismatch raised, no replicated parameter for the control."""
    _, ranks, _, _ = runs
    for r in ranks:
        for run in r["runs"]:
            assert run["replicas"] == {"compared": 0, "control": None}


def test_sharded_checkpoint_resumes_in_one_process(runs):
    """F1, written by rank 0 from the gathered shards, holds the module's
    reference-layout keys and resumes in one process to S2's epoch 2."""
    (s1, s2), _, back, _ = runs
    assert back["state"].step == s2["state"].step == 4
    assert_same_run({k: back[k] for k in ("train_l2_step", "train_l2_full", "test_l2_steps",
                                          "test_l2_fulls")},
                    back["state"].params_state_dict(), s2)
    assert list(back["state"].model.state_dict()) == list(s1["state"].model.state_dict())


def test_one_process_checkpoint_resumes_sharded(runs):
    (_, s2), ranks, _, _ = runs
    for r in ranks:
        got = r["runs"][1]
        assert got["step"] == 4
        assert_same_run(got["history"], got["params"], s2)


def test_bf16_block_cache_goes_stale_when_the_version_is_kept():
    """The hazard FSDP2 brings to the bf16 kernels' weight cache: its
    all-gather writes new values into the same tensor and keeps the version
    counter, so the cached conversion is served stale. A weight marked by
    the forward pre-hook that shard_state_fsdp gives every AFNO module
    (no_block_cache) is converted afresh at every call."""
    w = torch.randn(2, 1, 4, 4)
    first = afno_fused._bf16_blocks(w)
    with torch.autograd._unsafe_preserve_version_counter(w):
        w.mul_(2.0)
    assert afno_fused._bf16_blocks(w) is first  # stale
    w._dpot_block_cache = False
    fresh = w.transpose(-1, -2).to(torch.bfloat16)
    assert torch.equal(afno_fused._bf16_blocks(w), fresh)

    model = build_model("DPOT", img_size=16, patch_size=4, in_channels=2, in_timesteps=4,
                        embed_dim=32, depth=1, n_blocks=4, modes=4, device="cpu")
    afno = model.blocks[0].filter
    with torch.no_grad():
        model(torch.randn(1, 16, 16, 4, 2))
        assert not hasattr(afno.w1, "_dpot_block_cache")
        no_block_cache(model)
        model(torch.randn(1, 16, 16, 4, 2))
    assert afno.w1._dpot_block_cache is False and afno.w2._dpot_block_cache is False


@pytest.mark.parametrize("shape", [(2, 4, 96, 96), (1, 1536, 16, 16), (96,), (3, 5), (7,)])
def test_shard_axis(shape):
    """The first axis when 2 ranks divide it; else the axis JAX's shape_spec
    picks for 2 shards; else the first, unevenly."""
    got = _shard_dim(torch.Size(shape), 2)
    spec = tuple(shape_spec(shape, 2, min_size=0))
    if shape[0] % 2 == 0:
        assert got == 0
    elif "data" in spec:
        assert got == spec.index("data")
    else:
        assert got == 0

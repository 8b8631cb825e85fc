"""The port's tensor parallelism (dpot_tpu_torch/parallel/tensor.py) on gloo
ranks on the CPU, held against one port process and against the JAX
package's `shard_state_tp` steps and TP `RolloutServer`.

Two launches (tests/torch_dist_cases.py, each under a 120 s limit): two
ranks (model = 2) for the train steps, TP serving and the checkpoints that
cross between TP and one process through cli.train; four ranks (data 2 x
model 2) for tp and tp_fsdp. The tiny DPOT (width 32, 4 AFNO blocks, norm
groups 8, depth 2, 16^2 grid) in f32: every step within 2e-4 of JAX's and
1e-5 of one port process."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist_cases import SPEC, TINY, launch
from torch_layout_ref import (CLIP, JAX_TOL, ONE_TOL, assert_run, jax_steps, make_batches,
                              port_steps, rel, save_inputs, seeded_weights)

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu.parallel.tensor import count_tp_leaves as jax_count_tp_leaves
from dpot_tpu.parallel.tensor import shard_params_tp, shard_state_tp
from dpot_tpu.serve import RolloutServer as JaxRolloutServer
from dpot_tpu.train.interop import dpot_params_from_torch
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.parallel.tensor import count_tp_leaves, tp_specs

pytestmark = pytest.mark.multichip

NAME = "synthetic_tp"
CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
ARGV = TINY + ["--train_paths", NAME, "--noise_scale", "0.01", "--use_writer", "true"]
TP_ARGV = ["--shard_params", "tp", "--mesh_model", "2"]
SERVE = [(0, 3), (1, 2)]  # (input, rollout steps) of each request


def step_losses(log_dir) -> list[float]:
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "train_loss_step"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded weights carried through the JAX package's layout, two global
    batches, one process's steps; the one-process CLI runs whose checkpoint
    the TP ranks resume; the 2-rank launch."""
    tmp = tmp_path_factory.mktemp("tp")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(NAME, **SPEC)
    jvars, sd = seeded_weights(CFG)
    batches = make_batches(2)
    common = dict(save_inputs(tmp, sd, batches), cfg=CFG)
    xs = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 1, 16, 16, 4, 2))
                          .astype(np.float32))
    torch.save(xs, tmp / "xs.pt")
    s1 = main(ARGV + ["--epochs", "1", "--log_path", str(tmp / "s1")])
    ckpt = f"{s1['log_dir']}/model"
    s2 = main(ARGV + ["--epochs", "2", "--log_path", str(tmp / "s2"), "--resume_path", ckpt])
    suite = [
        ("step", "layout_step", dict(common, layouts=[
            dict(name="tp", mesh=dict(model=2), shard_params="tp")])),
        ("serve", "serve", dict(sd=str(tmp / "sd.pt"), cfg=CFG, xs=str(tmp / "xs.pt"),
                                requests=SERVE)),
        ("train", "train", dict(runs=[
            ARGV + TP_ARGV + ["--epochs", "1", "--log_path", str(tmp / "t1")],
            ARGV + TP_ARGV + ["--epochs", "2", "--log_path", str(tmp / "t2"),
                              "--resume_path", ckpt]])),
    ]
    ranks = launch("suite", tmp, dict(suite=suite, specs={NAME: SPEC}))
    yield dict(tmp=tmp, sd=sd, jvars=jvars, batches=batches, xs=xs, s1=s1, s2=s2,
               ranks=ranks, one=port_steps(CFG, sd, batches), common=common)
    torch.set_num_threads(n)


def test_tp_leaves_are_seven_a_block_and_indivisible_ones_stay_replicated():
    """tp_specs on the port's names: 7 leaves a block at tp = 2 (the
    filter's four on the block axis, fc1's weight and bias, fc2's weight),
    as JAX's count_tp_leaves gives; at tp = 8 the 4 AFNO blocks do not
    divide and the mixer stays replicated (JAX's fallback), the MLP's
    hidden 32 does."""
    model = build_model("DPOT", device="cpu", **CFG)
    specs = tp_specs(model, 2)
    assert count_tp_leaves(model, 2) == 7 * CFG["depth"] == len(specs)
    assert {n.split(".", 2)[2]: d for n, d in specs.items() if n.startswith("blocks.0.")} == {
        "filter.w1": 1, "filter.b1": 1, "filter.w2": 1, "filter.b2": 1,
        "mlp.0.weight": 0, "mlp.0.bias": 0, "mlp.2.weight": 1}
    jm = jax_build_model("DPOT", **CFG)
    jvars = dpot_params_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                                   depth=CFG["depth"], normalize=False)
    assert jax_count_tp_leaves(jvars, jax_mesh(data=1, model=2, devices=jax.devices()[:2])) \
        == count_tp_leaves(model, 2)
    wide = tp_specs(model, 8)
    assert not any(".filter." in n for n in wide)
    assert len(wide) == 3 * CFG["depth"]
    assert count_tp_leaves(model, 8) == jax_count_tp_leaves(
        jvars, jax_mesh(data=1, model=8, devices=jax.devices()[:8]))


def test_two_rank_tp_step_matches_jax_and_one_process(setup):
    """Two f32 adam steps (clip active, external noise) with shard_params tp
    over model = 2: each rank's losses, grad norms and gathered weights
    within 2e-4 of JAX's shard_state_tp steps and 1e-5 of one port process;
    each rank holds its shards (7 a block, half their full axis)."""
    jm = jax_build_model("DPOT", **CFG)
    want_aux, want = jax_steps(jm, setup["jvars"], setup["batches"],
                               jax_mesh(data=1, model=2, devices=jax.devices()[:2]),
                               place=shard_state_tp)
    one_aux, one_params = setup["one"]["aux"], setup["one"]["params"]
    assert want_aux[0]["grad_norm"] > CLIP
    for r in setup["ranks"]:
        got = r["step"]["tp"]
        assert_run(got, want_aux, want, JAX_TOL, "jax")
        assert_run(got, one_aux, one_params, ONE_TOL, "one process")
        assert len(got["tp_dims"]) == 7 * CFG["depth"]
        for name, dim in got["tp_dims"].items():
            assert got["local_shapes"][name][dim] * 2 == one_params[name].shape[dim], name


def test_replicated_parameters_get_the_full_gradient_on_every_rank(setup):
    """The gradients of the last step's parameters that are not shards
    (norm1's affine, of which each rank uses only its own channels, norm2,
    fc2's bias, the embeddings and heads) equal one process's on both
    ranks within 1e-5."""
    one_grads = setup["one"]["grads"]
    for r in setup["ranks"]:
        grads = r["step"]["tp"]["grads"]
        assert "blocks.0.norm1.weight" in grads and "blocks.1.mlp.2.bias" in grads
        assert sorted(grads) == sorted(n for n in one_grads if n not in r["step"]["tp"]["tp_dims"])
        for name, g in grads.items():
            assert rel(g, one_grads[name]) <= ONE_TOL, name


def test_tp_serving_matches_jax_tp_server(setup):
    """RolloutServer over model = 2 (rank 0 answers, rank 1 follows): each
    answer within 1e-5 of JAX's RolloutServer with TP-sharded params and a
    mesh, on the same weights and inputs."""
    jm = jax_build_model("DPOT", **CFG)
    mesh = jax_mesh(data=1, model=2, devices=jax.devices()[:2])
    rs = JaxRolloutServer(jm, shard_params_tp(setup["jvars"], mesh, min_size=0), mesh=mesh,
                          batch_buckets=(1, 2), max_wait_ms=1.0)
    rs.start()
    try:
        want = [rs.submit(setup["xs"][i].numpy(), steps) for i, steps in SERVE]
    finally:
        rs.stop()
    got = setup["ranks"][0]["serve"]
    assert setup["ranks"][1]["serve"]["preds"] is None
    assert got["shards"] == setup["ranks"][1]["serve"]["shards"] == 7 * CFG["depth"]
    assert got["n_params"] == sum(v.numel() for v in setup["sd"].values())
    for (_, steps), a, b in zip(SERVE, got["preds"], want, strict=True):
        assert a.shape == b.shape == (1, 16, 16, steps, 2)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_tp_run_equals_one_process_and_its_checkpoint_resumes_in_one(setup):
    """cli.train under tp on 2 ranks: epoch metrics and per-step losses
    within 1e-5 of one process's, rank 0 alone writes a checkpoint in the
    reference layout (gathered over 'model'), which one process resumes to
    the uninterrupted run's epoch 2."""
    tmp, s1, s2 = setup["tmp"], setup["s1"], setup["s2"]
    r0 = setup["ranks"][0]["train"]["runs"][0]
    assert setup["ranks"][1]["train"]["runs"][0]["log_dir"] is None
    for k in ("train_l2_step", "train_l2_full"):
        assert abs(r0["history"][k] - s1[k]) <= ONE_TOL * abs(s1[k]), k
    np.testing.assert_allclose(step_losses(r0["log_dir"]), step_losses(s1["log_dir"]),
                               rtol=ONE_TOL)
    ck = torch.load(f"{r0['log_dir']}/model/model.pth", weights_only=False)
    assert list(ck["model"]) == list(s1["state"].model.state_dict())
    for mom in ("mu", "nu"):
        want = getattr(s1["state"].optimizer, mom)
        for a, b in zip(ck["optimizer"][mom], want, strict=True):
            assert a.shape == b.shape and rel(a, b) <= 1e-4
    resumed = main(ARGV + ["--epochs", "2", "--log_path", str(tmp / "r"), "--resume_path",
                           f"{r0['log_dir']}/model"])
    assert resumed["state"].step == s2["state"].step == 4
    for k in ("train_l2_step", "train_l2_full"):
        assert abs(resumed[k] - s2[k]) <= ONE_TOL * abs(s2[k]), k
    for name, v in s2["state"].params_state_dict().items():
        assert rel(resumed["state"].params_state_dict()[name], v) <= ONE_TOL, name


def test_one_process_checkpoint_resumes_under_tp(setup):
    """One process's epoch-1 checkpoint resumed under tp on 2 ranks gives
    the uninterrupted run's epoch 2 within 1e-5 (metrics and weights)."""
    s2 = setup["s2"]
    for r in setup["ranks"]:
        got = r["train"]["runs"][1]
        assert got["step"] == 4
        for k in ("train_l2_step", "train_l2_full"):
            assert abs(got["history"][k] - s2[k]) <= ONE_TOL * abs(s2[k]), k
        for name, v in s2["state"].params_state_dict().items():
            assert rel(got["params"][name], v) <= ONE_TOL, name


def test_four_rank_tp_and_tp_fsdp_match_jax_and_one_process(setup, tmp_path):
    """data 2 x model 2 on 4 ranks: tp and tp_fsdp (FSDP2 over the data
    sub-mesh on top of the TP shards) against JAX's 2D TP x FSDP step
    within 2e-4 and one port process within 1e-5."""
    jm = jax_build_model("DPOT", **CFG)
    want_aux, want = jax_steps(jm, setup["jvars"], setup["batches"],
                               jax_mesh(data=2, model=2, devices=jax.devices()[:4]),
                               place=lambda st, m: shard_state_tp(st, m, fsdp_axis="data"))
    one_aux, one_params = setup["one"]["aux"], setup["one"]["params"]
    ranks = launch("layout_step", tmp_path, dict(setup["common"], layouts=[
        dict(name="tp", mesh=dict(data=2, model=2), shard_params="tp"),
        dict(name="tp_fsdp", mesh=dict(data=2, model=2), shard_params="tp_fsdp")]), world=4)
    for r in ranks:
        for name, got in r.items():
            assert got["world"] == 2, name
            assert_run(got, want_aux, want, JAX_TOL, f"jax {name}")
            assert_run(got, one_aux, one_params, ONE_TOL, f"one process {name}")


def test_follower_counts_a_failed_rollout_and_follows_on():
    """A rank > 0 of a served mesh counts a rollout that fails and goes on
    to the next announcement; rank 0's worker announces the stop whatever
    ended it."""
    from dpot_tpu_torch.serve.server import RolloutServer

    model = build_model("DPOT", device="cpu", **CFG)
    rs = RolloutServer(model, device="cpu")
    shape = (1, 16, 16, 4, 2)
    heads = [torch.tensor([2, *shape]), torch.zeros(*shape), torch.tensor([3, *shape]),
             torch.zeros(*shape), torch.zeros(6, dtype=torch.int64)]
    rs._bcast = lambda t: heads.pop(0)
    ran = []

    def rollout(x, n_steps):
        ran.append(n_steps)
        if len(ran) == 1:
            raise RuntimeError("out of memory")

    rs._eager_rollout = rollout
    rs.follow()
    assert ran == [2, 3] and not heads and rs.metrics()["errors"] == 1

    announced = []
    rs.mesh, rs._announce = object(), lambda n, x=None: announced.append(n)

    def dies():
        raise RuntimeError("worker died")

    rs._serve = dies
    with pytest.raises(RuntimeError, match="worker died"):
        rs._drain()
    assert announced == [0]

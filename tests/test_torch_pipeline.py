"""The port's GPipe pipeline over the trunk's depth
(dpot_tpu_torch/parallel/pipeline.py) on gloo ranks on the CPU, held against
one port process and against the JAX package's pipelined DPOTNet.

Two launches (tests/torch_dist_cases.py, each under a 120 s limit): two
stages (pipe = 2) with 2, 4 and 3 (degraded to 2) microbatches, with remat,
and cli.train's run and checkpoint; four ranks (data 2 x pipe 2). The tiny
DPOT at depth 4 (2 blocks a stage) in f32: every step within 2e-4 of JAX's
and 1e-5 of one port process."""

import jax
import numpy as np
import pytest
import torch
from torch_dist_cases import SPEC, TINY, launch
from torch_layout_ref import (JAX_TOL, ONE_TOL, assert_run, jax_steps, make_batches,
                              port_steps, rel, save_inputs, seeded_weights)

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.parallel.pipeline import micro_count

pytestmark = pytest.mark.multichip

NAME = "synthetic_pipe"
CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=4, n_blocks=4, modes=4, n_cls=2)
ARGV = TINY + ["--train_paths", NAME, "--noise_scale", "0.01", "--use_writer", "true",
               "--n_layers", "2"]
# (layout, microbatches asked, microbatches run, remat): B = 8 rows a stage
TWO_STAGE = [("m2", 0, 2, False), ("m4", 4, 4, False), ("m3", 3, 2, False),
             ("remat", 0, 2, True)]
APPLICATIONS = 2  # a step's rollout: 2 target frames at t_bundle 1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(NAME, **SPEC)
    jvars, sd = seeded_weights(CFG)
    batches = make_batches(2)
    common = dict(save_inputs(tmp, sd, batches), cfg=CFG)
    s1 = main(ARGV + ["--epochs", "1", "--log_path", str(tmp / "s1")])
    layouts = [dict(name=name, mesh=dict(pipe=2), micro=m, remat=remat)
               for name, m, _, remat in TWO_STAGE]
    suite = [("step", "layout_step", dict(common, layouts=layouts)),
             ("train", "train", dict(runs=[ARGV + ["--mesh_pipe", "2", "--epochs", "1",
                                                   "--log_path", str(tmp / "p1")]]))]
    ranks = launch("suite", tmp, dict(suite=suite, specs={NAME: SPEC}))
    yield dict(tmp=tmp, sd=sd, jvars=jvars, batches=batches, s1=s1, ranks=ranks,
               one=port_steps(CFG, sd, batches), common=common)
    torch.set_num_threads(n)


def jax_pipe_steps(setup, mesh, micro):
    jm = jax_build_model("DPOT", pipe_mesh=mesh, pipe_microbatches=micro, **CFG)
    return jax_steps(jm, setup["jvars"], setup["batches"], mesh)


def test_microbatches_degrade_to_a_divisor():
    assert [micro_count(8, m) for m in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 2, 4, 4, 8, 8]
    assert micro_count(6, 4) == 3 and micro_count(5, 2) == 1


def test_pipelined_trunk_matches_the_sequential_one(setup):
    """The model's forward with its trunk pipelined over 2 stages, at 2, 4
    and 3 (run as 2) microbatches: the prediction and class logits of one
    process's sequential trunk within 1e-5, on both stages."""
    pred, cls = setup["one"]["forward"]
    for r in setup["ranks"]:
        for name, *_ in TWO_STAGE:
            got_pred, got_cls = r["step"][name]["forward"]
            assert rel(got_pred, pred) <= ONE_TOL and rel(got_cls, cls) <= ONE_TOL, name


def test_two_stage_steps_match_jax_and_one_process(setup):
    """Two adam steps over pipe = 2 (each stage holding its 2 blocks alone):
    each stage's losses, grad norms and gathered weights within 2e-4 of the
    JAX package's pipelined step (same microbatches) and 1e-5 of one port
    process; each stage runs its blocks exactly M x L/P times an application
    (twice under remat)."""
    one = setup["one"]
    for name, asked, run, remat in TWO_STAGE:
        want_aux, want = jax_pipe_steps(setup, jax_mesh(data=1, pipe=2,
                                                        devices=jax.devices()[:2]), asked)
        for stage, r in enumerate(setup["ranks"]):
            got = r["step"][name]
            assert_run(got, want_aux, want, JAX_TOL, f"jax {name}")
            assert_run(got, one["aux"], one["params"], ONE_TOL, f"one process {name}")
            blocks = sorted({k.split(".")[1] for k in got["local_shapes"]
                             if k.startswith("blocks.")}, key=int)
            assert blocks == [str(2 * stage), str(2 * stage + 1)], blocks
            steps = len(setup["batches"])
            assert got["block_calls"] == steps * APPLICATIONS * run * 2 * (1 + remat), name


def test_replicated_gradients_equal_one_process(setup):
    """The last step's gradients of the embedding, the position embedding,
    the time aggregator and the output head on both stages, and of each
    stage's blocks, equal one process's within 1e-5 (not P times the heads'
    gradient)."""
    one = setup["one"]["grads"]
    for r in setup["ranks"]:
        grads = r["step"]["m2"]["grads"]
        for prefix in ("patch_embed.", "pos_embed", "time_agg_layer.", "out_layer."):
            assert any(k.startswith(prefix) for k in grads), prefix
        for name, g in grads.items():
            assert rel(g, one[name]) <= ONE_TOL, name


def test_pipelined_cli_run_equals_one_process_and_checkpoints_in_the_reference_layout(setup):
    """cli.train with --mesh_pipe 2 (depth 2, one block a stage): epoch
    metrics within 1e-5 of one process's, and rank 0's checkpoint holds
    every block (gathered over 'pipe') and the moments in one process's
    order, within 1e-5."""
    s1 = setup["s1"]
    r0 = setup["ranks"][0]["train"]["runs"][0]
    for k in ("train_l2_step", "train_l2_full"):
        assert abs(r0["history"][k] - s1[k]) <= ONE_TOL * abs(s1[k]), k
    ck = torch.load(f"{r0['log_dir']}/model/model.pth", weights_only=False)
    assert list(ck["model"]) == list(s1["state"].model.state_dict())
    for name, v in s1["state"].params_state_dict().items():
        assert rel(ck["model"][name], v) <= ONE_TOL, name
    for a, b in zip(ck["optimizer"]["nu"], s1["state"].optimizer.nu, strict=True):
        assert a.shape == b.shape and rel(a, b) <= 1e-4


def test_data_by_pipe_steps_match_jax_and_one_process(tmp_path, setup):
    """data 2 x pipe 2 on 4 ranks (each stage's rows over 'data', the
    gradients averaged over it): against JAX's make_mesh(data=2, pipe=2)
    step within 2e-4 and one port process within 1e-5."""
    want_aux, want = jax_pipe_steps(setup, jax_mesh(data=2, pipe=2, devices=jax.devices()[:4]),
                                    2)
    ranks = launch("layout_step", tmp_path, dict(setup["common"], layouts=[
        dict(name="dp_pp", mesh=dict(data=2, pipe=2), micro=2)]), world=4)
    one = setup["one"]
    for r in ranks:
        got = r["dp_pp"]
        assert got["world"] == 2
        assert_run(got, want_aux, want, JAX_TOL, "jax")
        assert_run(got, one["aux"], one["params"], ONE_TOL, "one process")
    np.testing.assert_equal(len(ranks), 4)

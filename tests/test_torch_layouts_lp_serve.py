"""The rest of the port's parallel layer on 2 gloo ranks on the CPU: the bf16
working copy (`TrainState.create(..., param_working_dtype=torch.bfloat16)`)
under FSDP2, TP, tp_fsdp and the pipeline; FSDP2 checkpoints gathered
with c10d collectives (DTensor's full_tensor made to raise on the ranks);
and serving over 'pipe', 'data' and 'spatial' mesh axes (and cli.serve under
torchrun over 'pipe').

One launch (tests/torch_dist_cases.py, under a 120 s limit), started before
the references so that the ranks run while the JAX package's working copy
and servers compile. The tiny DPOT of test_torch_tp.py (width 32, 4 AFNO
blocks, depth 2, 16^2 grid), f32 compute:

- the working copy, two adam steps (clip active, external noise): every
  rank's losses, grad norms, gathered f32 master and its change over the
  steps against one port process's working-copy run, within 1e-5 where the
  layout does not split the batch (TP: the same roundings) and within
  2e-2, the working copy's bar for a split batch
  (tests/test_torch_params_lp.py::test_working_copy_grad_accum_matches_full_batch),
  where it does (FSDP2 over 'data', the pipeline's microbatches): each
  rank's gradient of a bf16 parameter is bf16, rounded before the sum over
  ranks or microbatches (in f32, rounded once more), where one process
  rounds the whole batch's once (measured: 5e-3 to 7e-3 on the change);
  and within 2e-2 of the JAX package's working copy (the port's bar against
  it); the copy stays the master's cast, shard by shard; under FSDP2 with
  grad_accum 2 (no noise: external draws do not split into microbatches)
  against one process alike;
- the checkpoint: 2 FSDP2 ranks write one (cli.train, one epoch); restored
  into a fresh FSDP2 state on the 2 ranks and gathered back, and read by
  one process, it is the file bit for bit; the 2 ranks' resume to epoch 2
  equals one process's resume from it within 1e-5;
- serving: RolloutServer over pipe = 2, data = 2 and spatial = 2 (rank 0
  answers, rank 1 follows): each answer within 1e-5 of the JAX package's
  RolloutServer(mesh=...) on the same mesh (pipe and data) and of one port
  process's server (all three)."""

import json

import jax
import numpy as np
import pytest
import torch
from torch_dist_cases import SPEC, TINY, start
from torch_layout_ref import (ONE_TOL, assert_run, jax_steps, make_batches, port_steps, rel,
                              save_inputs, seeded_weights)

from dpot_tpu.models import build_model as jax_build_model
from dpot_tpu.parallel.mesh import make_mesh as jax_mesh
from dpot_tpu.serve import RolloutServer as JaxRolloutServer
from dpot_tpu_torch.cli.serve import main as serve_main
from dpot_tpu_torch.cli.train import main
from dpot_tpu_torch.data.registry import make_synthetic_spec
from dpot_tpu_torch.models import build_model
from dpot_tpu_torch.serve.server import RolloutServer

pytestmark = pytest.mark.multichip

CFG = dict(img_size=16, patch_size=4, in_channels=2, out_channels=2, in_timesteps=4,
           out_timesteps=1, embed_dim=32, depth=2, n_blocks=4, modes=4, n_cls=2)
LP_TOL = 2e-2
# name: (mesh axes, shard_params, grad_accum); the batch split where 'data'
# or 'pipe' has two ranks
LP_LAYOUTS = {
    "lp_fsdp": (dict(data=2), "fsdp", 1),
    "lp_tp": (dict(model=2), "tp", 1),
    "lp_tp_fsdp": (dict(data=1, model=2), "tp_fsdp", 1),
    "lp_pipe": (dict(pipe=2), "replicate", 1),
    "lp_fsdp_accum": (dict(data=2), "fsdp", 2),
}
SERVE_MESHES = {"pipe": dict(pipe=2), "data": dict(data=2), "spatial": dict(spatial=2)}
SERVE = [(0, 2)]  # (input, rollout steps) of each request
SERVE_ARGV = ["--model", "DPOT", "--res", "16", "--patch_size", "4", "--width", "32",
              "--n_layers", "2", "--n_blocks", "4", "--modes", "4", "--T_in", "4",
              "--n_channels", "2", "--device", "cpu", "--port", "0"]
NAME = "synthetic_lp_ckpt"
ARGV = TINY + ["--train_paths", NAME, "--noise_scale", "0.01", "--opt", "lamb",
               "--shard_params", "fsdp", "--use_writer", "true"]


def step_losses(log_dir) -> list[float]:
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [r["value"] for r in map(json.loads, f) if r["tag"] == "train_loss_step"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lp_serve")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    make_synthetic_spec(NAME, **SPEC)
    jvars, sd = seeded_weights(CFG)
    batches = make_batches(2)
    quiet = [{k: v for k, v in b.items() if k != "noise"} for b in batches]
    common = save_inputs(tmp, sd, batches)
    torch.save([{k: torch.from_numpy(v) for k, v in b.items()} for b in quiet],
               tmp / "quiet.pt")
    xs = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 1, 16, 16, 4, 2))
                          .astype(np.float32))
    torch.save(xs, tmp / "xs.pt")
    serve = dict(sd=str(tmp / "sd.pt"), cfg=CFG, xs=str(tmp / "xs.pt"), requests=SERVE)
    suite = [
        ("lp", "layout_step", dict(common, cfg=CFG, layouts=[
            dict(name=name, mesh=axes, shard_params=shard, lp=True, accum=accum,
                 **(dict(batches=str(tmp / "quiet.pt"), noise=0.0) if accum > 1 else {}))
            for name, (axes, shard, accum) in LP_LAYOUTS.items()])),
        ("ckpt", "fsdp_ckpt", dict(cfg=dict(img_size=16, patch_size=4, in_channels=2,
                                            in_timesteps=6, embed_dim=32, depth=1, n_blocks=4,
                                            modes=4, n_cls=1),
                                   runs=[ARGV + ["--epochs", "1", "--log_path",
                                                 str(tmp / "f1")]],
                                   resume=ARGV + ["--epochs", "2", "--log_path",
                                                  str(tmp / "f2")])),
        *[(f"serve_{k}", "serve", dict(serve, mesh=axes)) for k, axes in SERVE_MESHES.items()],
        ("serve_cli", "serve_cli", dict(argv=SERVE_ARGV + ["--mesh_pipe", "2"],
                                        xs=str(tmp / "xs.pt"), steps=SERVE[0][1])),
    ]
    wait = start("suite", tmp, dict(suite=suite, specs={NAME: SPEC}))
    try:
        jm = jax_build_model("DPOT", **CFG)
        want_lp = jax_steps(jm, jvars, batches, lp=True)
        one_lp = port_steps(CFG, sd, batches, lp=True)
        one_lp_accum = port_steps(CFG, sd, quiet, lp=True, accum=2, noise=0.0)
        want_serve = {}
        for k in ("pipe", "data"):
            mesh = jax_mesh(devices=jax.devices()[:2], **{"data": 1, **SERVE_MESHES[k]})
            model = jax_build_model("DPOT", **CFG,
                                    **({"pipe_mesh": mesh} if k == "pipe" else {}))
            rs = JaxRolloutServer(model, jax.device_put(jvars), mesh=mesh, batch_buckets=(1,),
                                  max_wait_ms=1.0, warmup_steps=(SERVE[0][1],))
            rs.start()
            try:
                want_serve[k] = [rs.submit(xs[i].numpy(), steps) for i, steps in SERVE]
            finally:
                rs.stop()
        model = build_model("DPOT", device="cpu", **CFG)
        model.load_state_dict(sd)
        rs = RolloutServer(model, device="cpu", batch_buckets=(1,), max_wait_ms=1.0)
        rs.start()
        try:
            one_serve = [rs.submit(xs[i].numpy(), steps) for i, steps in SERVE]
        finally:
            rs.stop(drain=True)
        httpd, rs = serve_main(SERVE_ARGV, wait=False)
        try:
            one_cli = rs.submit(xs[0].numpy(), SERVE[0][1])
        finally:
            rs.stop(drain=True)
            httpd.shutdown()
    finally:
        ranks = wait()
    f1 = ranks[0]["ckpt"]["runs"][0]["log_dir"]
    one_resume = main(ARGV[:ARGV.index("--shard_params")] + ARGV[ARGV.index("--use_writer"):]
                      + ["--epochs", "2", "--log_path", str(tmp / "r2"),
                         "--resume_path", f"{f1}/model"])
    torch.set_num_threads(n)
    return dict(ranks=ranks, sd=sd, n_full=sum(v.numel() for v in sd.values()),
                want_lp=want_lp, one_lp=one_lp, one_lp_accum=one_lp_accum,
                want_serve=want_serve, one_serve=one_serve, one_cli=one_cli, f1=f1,
                one_resume=one_resume)


@pytest.mark.parametrize("name", list(LP_LAYOUTS))
def test_working_copy_layout_matches_one_process_and_jax(runs, name):
    """Each rank's working-copy steps: within 1e-5 of one port process's
    working-copy run and 2e-2 of JAX's working copy; the copy is the cast
    of the master after the steps; FSDP2 shards and TP shards where the
    layout makes them."""
    axes, shard, accum = LP_LAYOUTS[name]
    one = runs["one_lp_accum"] if accum > 1 else runs["one_lp"]
    tol = LP_TOL if axes.get("data", 1) * axes.get("pipe", 1) > 1 else ONE_TOL
    sd = runs["sd"]
    for r in runs["ranks"]:
        got = r["lp"][name]
        assert got["lp_cast"] is True
        assert got["sharded"] == (shard in ("fsdp", "tp_fsdp"))
        assert bool(got["tp_dims"]) == shard.startswith("tp")
        assert all(v.dtype == torch.float32 for v in got["params"].values())
        assert_run(got, one["aux"], one["params"], tol, f"one process {name}")
        change = {k: got["params"][k] - sd[k] for k in sd}
        assert rel(torch.cat([v.reshape(-1) for v in change.values()]),
                   torch.cat([(one["params"][k] - sd[k]).reshape(-1) for k in sd])) <= tol
        if accum == 1:
            want_aux, want = runs["want_lp"]
            assert_run(got, want_aux, want, LP_TOL, f"jax {name}")


def test_fsdp_checkpoint_gathers_without_dtensor(runs, tmp_path):
    """The 2 FSDP2 ranks' checkpoint (DTensor.full_tensor raising on both):
    rank 0 alone wrote it; restored on 2 ranks under FSDP2 and gathered
    back, and read by one process, its weights, moments and step are the
    file's bit for bit; the ranks' resume to epoch 2 equals one process's
    resume from it within 1e-5, step for step."""
    from dpot_tpu_torch.train.checkpoint import MODEL_FILE

    ck = torch.load(f"{runs['f1']}/model/{MODEL_FILE}", weights_only=False)
    assert ck["step"] == 2
    for r in runs["ranks"]:
        got = r["ckpt"]["restored"]
        assert got["step"] == 2
        assert list(got["params"]) == list(ck["model"])
        for k, v in ck["model"].items():
            assert torch.equal(got["params"][k], v), k
        for mom in ("mu", "nu"):
            for a, b in zip(got[mom], ck["optimizer"][mom], strict=True):
                assert torch.equal(a, b)
        # each rank held its shards, not whole tensors
        assert any(s != tuple(ck["model"][k].shape) for s, k in
                   zip(got["local"], [k for k in ck["model"] if "running" not in k]))
    assert runs["ranks"][1]["ckpt"]["runs"][0]["log_dir"] is None
    one = runs["one_resume"]
    assert one["state"].step == 4
    for r in runs["ranks"]:
        res = r["ckpt"]["resumed"]
        assert res["step"] == 4
        for k in ("train_l2_step", "train_l2_full"):
            assert abs(res["history"][k] - one[k]) <= ONE_TOL * abs(one[k]), k
        for name, v in one["state"].params_state_dict().items():
            assert rel(res["params"][name], v) <= ONE_TOL, name
    np.testing.assert_allclose(step_losses(runs["ranks"][0]["ckpt"]["resumed"]["log_dir"]),
                               step_losses(one["log_dir"]), rtol=ONE_TOL)


@pytest.mark.parametrize("axis", list(SERVE_MESHES))
def test_serving_over_a_mesh_axis(runs, axis):
    """RolloutServer over 2 ranks of one axis: rank 0's answers within 1e-5
    of one port process's server and of JAX's RolloutServer on the same
    mesh (pipe and data); a pipeline rank holds its stage's blocks; the
    full model's parameters counted."""
    got = runs["ranks"][0][f"serve_{axis}"]
    assert runs["ranks"][1][f"serve_{axis}"]["preds"] is None
    blocks = CFG["depth"] // (2 if axis == "pipe" else 1)
    assert got["blocks"] == runs["ranks"][1][f"serve_{axis}"]["blocks"] == blocks
    assert got["n_params"] == runs["n_full"]
    for (_, steps), a, b in zip(SERVE, got["preds"], runs["one_serve"], strict=True):
        assert a.shape == b.shape == (1, 16, 16, steps, 2)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(got["preds"], runs["want_serve"].get(axis, got["preds"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_serve_cli_over_pipeline_ranks(runs):
    """cli.serve under torchrun with --mesh_pipe 2: rank 0's answer equals
    the one-process CLI's on the same seeded weights within 1e-5, each
    rank holding its stage's block."""
    ranks = runs["ranks"]
    assert ranks[1]["serve_cli"]["pred"] is None
    assert ranks[0]["serve_cli"]["blocks"] == ranks[1]["serve_cli"]["blocks"] == 1
    got, want = ranks[0]["serve_cli"]["pred"], runs["one_cli"]
    assert got.shape == want.shape == (1, 16, 16, SERVE[0][1], 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
